"""Solver registry — the pluggable backend table of the planner facade.

Every allocation algorithm (the paper's GH/AGH/DM and the external
baselines, plus any user-defined solver) is described by a `SolverSpec`
and looked up by name at `plan()` time.  Registering a solver is the ONLY
step needed to make it reachable from the facade — no caller
enumerates algorithms by hand.

A spec's `solve` callable receives ``(instance, options, warm_start)`` and
returns ``(Solution, diagnostics_dict)``.  `warm_start` is an incumbent
`Solution` (or None); solvers that cannot use one (declared via
``supports_warm_start=False``) simply receive None from the facade.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.instance import Instance
from repro_torch.core.solution import Solution


class UnknownSolverError(KeyError):
    """Raised when a `plan()` request names a solver nobody registered."""


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """One registered planning backend.

    ``solve(inst, options, warm_start) -> (Solution, diagnostics)`` must be
    deterministic for fixed inputs (the CI regression gate pins objectives
    exactly); `diagnostics` is a JSON-safe dict of solver-specific counters
    (orderings evaluated, moves applied, rescans, MILP status, ...).
    """
    name: str
    solve: Callable[[Instance, object, Solution | None],
                    tuple[Solution, dict]]
    description: str = ""
    supports_warm_start: bool = False
    aliases: tuple[str, ...] = ()


_REGISTRY: dict[str, SolverSpec] = {}
_ALIASES: dict[str, str] = {}


def register_solver(spec: SolverSpec, overwrite: bool = False) -> SolverSpec:
    """Add `spec` (and its aliases) to the registry and return it.

    Re-registering an existing name requires ``overwrite=True`` so plugins
    cannot silently shadow the paper's solvers.  Builtins are loaded
    first, so a plugin colliding with a builtin name fails loudly HERE —
    not later, inside the builtin module's own deferred import.
    """
    # Load the builtin table before checking collisions (guarded against
    # recursion: during the builtin module's own import this re-entry
    # finds it already in sys.modules and is a no-op).
    _ensure_builtins()
    names = (spec.name, *spec.aliases)
    for name in names:
        taken = _ALIASES.get(name, name) in _REGISTRY
        if taken and not overwrite and _ALIASES.get(name, name) != spec.name:
            raise ValueError(f"solver name {name!r} is already registered "
                             f"(pass overwrite=True to replace it)")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"solver {spec.name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    # Replacing a spec (or promoting a name that was previously an alias,
    # e.g. overwriting "dm") must drop every stale alias mapping — lookups
    # resolve aliases first, so a leftover entry would silently shadow
    # the new registration.
    replaced = _REGISTRY.get(spec.name)
    if replaced is not None:
        for alias in replaced.aliases:
            _ALIASES.pop(alias, None)
    _ALIASES.pop(spec.name, None)
    _REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        _ALIASES[alias] = spec.name
    return spec


def unregister_solver(name: str) -> None:
    """Remove a solver by name OR alias (tests / plugin teardown) —
    lookups resolve aliases, so removal does too."""
    spec = _REGISTRY.pop(_ALIASES.get(name, name), None)
    if spec is not None:
        for alias in spec.aliases:
            _ALIASES.pop(alias, None)


def solver_names() -> tuple[str, ...]:
    """Canonical registered names, sorted (aliases excluded)."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_solver(name: str) -> SolverSpec:
    """Look up a solver by name or alias.

    Unknown names raise `UnknownSolverError` whose message lists every
    registered name — a typo'd solver fails loudly and helpfully.
    """
    _ensure_builtins()
    canonical = _ALIASES.get(name, name)
    spec = _REGISTRY.get(canonical)
    if spec is None:
        raise UnknownSolverError(
            f"unknown solver {name!r}; registered solvers: "
            f"{', '.join(solver_names())}")
    return spec


def _ensure_builtins() -> None:
    """Idempotently import the builtin adapter module, which registers the
    paper's solvers on first import (lazy so `repro_torch.planner.registry` can
    be imported without pulling scipy in)."""
    from . import builtin  # noqa: F401  (import-for-side-effect)
