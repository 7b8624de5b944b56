"""Pluggable checker registry.

A checker is a class with a `rules` tuple, an optional path `scope`
(posix substrings; empty = every file), and a ``check(ctx)`` method
yielding diagnostics.  `@register_checker` adds it to the table the
runner walks; registering is the only wiring step, mirroring the solver
registry's contract (`repro_torch.planner.registry`).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Iterator, Type

from .diagnostics import Diagnostic, Rule


@dataclasses.dataclass
class FileContext:
    """Everything a checker may inspect about one file."""
    path: Path              # filesystem path (for re-reads, never shown)
    display: str            # path string used in diagnostics
    posix: str              # normalized posix path, used for scoping
    source: str
    tree: ast.Module
    lines: list[str]        # source split per line (1-based via line-1)


class BaseChecker:
    """One invariant pass.  Subclass, set `rules` (+ optional `scope`),
    implement `check`, and decorate with `@register_checker`."""

    rules: tuple[Rule, ...] = ()
    #: posix path substrings this checker applies to; empty = all files.
    scope: tuple[str, ...] = ()

    def applies_to(self, posix_path: str) -> bool:
        return not self.scope or any(s in posix_path for s in self.scope)

    def check(self, ctx: FileContext) -> Iterator[Diagnostic]:
        raise NotImplementedError


_CHECKERS: dict[str, Type[BaseChecker]] = {}


def register_checker(cls: Type[BaseChecker]) -> Type[BaseChecker]:
    if not cls.rules:
        raise ValueError(f"checker {cls.__name__} declares no rules")
    _CHECKERS[cls.__name__] = cls
    return cls


def _ensure_builtin_checkers() -> None:
    from . import checkers  # noqa: F401  (import-for-side-effect)


def all_checkers() -> list[BaseChecker]:
    _ensure_builtin_checkers()
    return [cls() for cls in _CHECKERS.values()]


# Meta-rules emitted by the framework itself (suppression hygiene, parse
# failures).  Always active and never suppressible — a broken suppression
# must not be silenceable by another broken suppression.
META_RULES: tuple[Rule, ...] = (
    Rule("RPR000", "syntax-error", "file must parse under ast.parse"),
    Rule("RPR001", "malformed-suppression",
         "repro-lint comments must be 'ignore[CODE,...] -- reason'"),
    Rule("RPR002", "bare-suppression",
         "suppressions require a '-- reason' justification"),
    Rule("RPR003", "unknown-suppression-code",
         "suppressed codes must name a registered rule or family"),
)


def all_rules() -> tuple[Rule, ...]:
    _ensure_builtin_checkers()
    seen: dict[str, Rule] = {r.code: r for r in META_RULES}
    for cls in _CHECKERS.values():
        for r in cls.rules:
            if r.code in seen:
                raise ValueError(f"duplicate rule code {r.code}")
            seen[r.code] = r
    return tuple(sorted(seen.values(), key=lambda r: r.code))


def known_code_prefixes() -> frozenset[str]:
    """Every exact code plus every valid RPR-prefix family."""
    codes = {r.code for r in all_rules()}
    fams: set[str] = {"RPR"}
    for c in codes:
        for end in range(4, len(c)):
            fams.add(c[:end])
    return frozenset(codes | fams)


def select_filter(select: Iterable[str] | None):
    """Predicate over rule codes for ``--select`` (prefix semantics)."""
    if not select:
        return lambda code: True
    pats = tuple(s.strip() for s in select if s.strip())
    return lambda code: any(code == p or code.startswith(p) for p in pats)
