"""Determinism discipline (RPR201-204) in the engine paths.

Scope: ``repro_torch/core/`` (the numpy allocator and the torch tier),
``repro_torch/planner/``, ``repro_torch/serving/`` — everything whose
plans the port holds bit for bit against the reference.  The solvers must
be bit-reproducible for fixed inputs, so:

* RPR201 — draws from hidden global generator state.  The legacy
  module-level ``np.random.*`` API, and torch's global generator:
  ``torch.manual_seed`` / ``torch.seed`` (and their ``torch.cuda`` /
  ``torch.random`` forms), the samplers ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``normal``, ``bernoulli``, ``multinomial``,
  ``poisson`` without ``generator=``, their ``*_like`` forms (which take
  no generator), and the in-place ``Tensor.uniform_`` / ``normal_`` /
  ``random_`` / ... and the ``torch.nn.init`` samplers without
  ``generator=``.  Only explicit generators are
  deterministic: ``np.random.default_rng(seed)`` and a seeded
  ``torch.Generator`` passed as ``generator=``, the counterpart of
  ``jax.random``'s explicit keys.
* RPR202 — stdlib ``random`` has the same problem plus hash-dependent
  behaviors; it is banned outright in engine paths.
* RPR203 — iterating a ``set`` feeds Python's unordered iteration into
  whatever consumes it.  Order-insensitive reductions (``sorted``,
  ``len``, ``min``/``max``/``sum``/``any``/``all``, rebuilding a
  ``set``/``frozenset``, membership tests) are exempt; ``list()``/
  ``tuple()``/``enumerate()``/bare ``for`` are flagged.
* RPR204 — wall-clock and environment reads (``time.time``,
  ``datetime.now``, ``os.environ``/``getenv``) make results depend on
  when/where the solve runs.  ``time.perf_counter``/``process_time``/
  ``monotonic`` stay legal: they feed runtime *reporting*, never a
  decision.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..diagnostics import Diagnostic, Rule
from ..registry import BaseChecker, FileContext, register_checker
from ._torch import import_aliases, keyword, resolved

_LEGAL_NP_RANDOM = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "SFC64", "MT19937",
})

#: order-insensitive consumers: set iteration inside these is fine
_ORDER_FREE_CALLS = frozenset({
    "sorted", "len", "min", "max", "sum", "any", "all", "set",
    "frozenset",
})

#: ordering-sensitive constructors over an unordered iterable
_ORDER_SENSITIVE_CALLS = frozenset({"list", "tuple", "enumerate", "iter"})

#: attributes known (from core.mechanisms) to hold sets
_SET_ATTRS = frozenset({"uncovered", "cfg_seen"})

#: torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson",
})

#: torch calls that always use (or reseed) the global generator
_TORCH_GLOBAL = frozenset({
    ("torch", "manual_seed"), ("torch", "seed"),
    ("torch", "random", "manual_seed"), ("torch", "random", "seed"),
    ("torch", "cuda", "manual_seed"), ("torch", "cuda", "manual_seed_all"),
    ("torch", "cuda", "seed"), ("torch", "cuda", "seed_all"),
    ("torch", "rand_like"), ("torch", "randn_like"),
    ("torch", "randint_like"),
})

#: in-place Tensor samplers (global generator unless `generator=`)
_TENSOR_SAMPLERS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})

#: torch.nn.init functions that draw nothing
_INIT_CONSTANT = frozenset({
    "zeros_", "ones_", "constant_", "eye_", "dirac_", "calculate_gain",
})

_CLOCK_BANNED = {
    ("time", "time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}


def _dotted(node: ast.expr) -> tuple[str, ...]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def _ann_is_set(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Name):
        return ann.id in ("set", "frozenset")
    if isinstance(ann, ast.Subscript):
        return _ann_is_set(ann.value)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _ann_is_set(ann.left) or _ann_is_set(ann.right)
    return False


@register_checker
class DeterminismChecker(BaseChecker):
    scope = ("repro_torch/core/", "repro_torch/planner/",
             "repro_torch/serving/")
    rules = (
        Rule("RPR201", "legacy-np-random",
             "use np.random.default_rng(seed) or a seeded torch.Generator, "
             "not a global generator"),
        Rule("RPR202", "stdlib-random",
             "stdlib `random` is banned in engine paths"),
        Rule("RPR203", "unordered-set-iteration",
             "set iteration must feed order-insensitive consumers only"),
        Rule("RPR204", "wallclock-or-env-read",
             "no wall-clock / environment reads in engine paths"),
    )

    def check(self, ctx: FileContext) -> Iterator[Diagnostic]:
        set_names = _collect_set_bindings(ctx.tree)
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from _check_torch_rng(ctx, node, aliases)
            yield from self._check_node(ctx, node, set_names)

    # -- per-node dispatch -------------------------------------------------
    def _check_node(self, ctx: FileContext, node: ast.AST,
                    set_names: set[str]) -> Iterator[Diagnostic]:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random" or a.name.startswith("random."):
                    yield Diagnostic(
                        ctx.display, node.lineno, node.col_offset,
                        "RPR202", "stdlib `random` import in an engine "
                        "path")
            return
        if isinstance(node, ast.ImportFrom):
            if node.module == "random":
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR202",
                    "stdlib `random` import in an engine path")
            return
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if len(dotted) >= 3 and dotted[-3:-1] == ("np", "random") \
                    or (len(dotted) >= 3
                        and dotted[-3:-1] == ("numpy", "random")):
                if dotted[-1] not in _LEGAL_NP_RANDOM:
                    yield Diagnostic(
                        ctx.display, node.lineno, node.col_offset,
                        "RPR201",
                        f"legacy unseeded np.random.{dotted[-1]} — use a "
                        f"np.random.default_rng(seed) Generator")
            if dotted[:1] == ("random",) and len(dotted) == 2:
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR202",
                    f"stdlib random.{dotted[-1]} in an engine path")
            if len(dotted) >= 2 and dotted[-2:] in _CLOCK_BANNED:
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR204",
                    f"wall-clock read {'.'.join(dotted[-2:])} in an "
                    f"engine path (perf_counter is fine for timing)")
            if dotted[-2:] == ("os", "environ") \
                    or dotted[-2:] == ("os", "getenv"):
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR204",
                    "environment read in an engine path")
            return
        if isinstance(node, ast.For):
            if _is_set_expr(node.iter, set_names):
                yield Diagnostic(
                    ctx.display, node.iter.lineno, node.iter.col_offset,
                    "RPR203", "bare iteration over a set — wrap in "
                    "sorted(...) or prove order-insensitivity")
            return
        if isinstance(node, ast.comprehension):
            if _is_set_expr(node.iter, set_names):
                yield Diagnostic(
                    ctx.display, node.iter.lineno, node.iter.col_offset,
                    "RPR203", "comprehension over a set — wrap in "
                    "sorted(...) or prove order-insensitivity")
            return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _ORDER_SENSITIVE_CALLS and node.args:
            if _is_set_expr(node.args[0], set_names):
                yield Diagnostic(
                    ctx.display, node.lineno, node.col_offset, "RPR203",
                    f"{node.func.id}() over a set materializes an "
                    f"arbitrary order — sort first")


def _check_torch_rng(ctx: FileContext, node: ast.Call,
                     aliases: dict[str, tuple[str, ...]]
                     ) -> Iterator[Diagnostic]:
    """RPR201's torch half: a draw from (or a reseed of) torch's global
    generator."""
    dd = resolved(node.func, aliases)
    seeded = keyword(node, "generator") is not None
    if dd in _TORCH_GLOBAL:
        name = ".".join(dd)
    elif len(dd) == 2 and dd[0] == "torch" and dd[1] in _TORCH_SAMPLERS \
            and not seeded:
        name = ".".join(dd)
    elif dd[:3] == ("torch", "nn", "init") and len(dd) == 4 \
            and dd[3] not in _INIT_CONSTANT and not seeded:
        name = ".".join(dd)
    elif isinstance(node.func, ast.Attribute) \
            and node.func.attr in _TENSOR_SAMPLERS and not seeded \
            and dd[:1] != ("torch",):
        name = f"Tensor.{node.func.attr}"
    else:
        return
    yield Diagnostic(
        ctx.display, node.lineno, node.col_offset, "RPR201",
        f"{name} draws from torch's global generator — pass a seeded "
        f"torch.Generator as generator=")


def _collect_set_bindings(tree: ast.Module) -> set[str]:
    """Names statically known to hold sets: annotated params/vars and
    locals assigned from set displays / set() / frozenset()."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
                if _ann_is_set(arg.annotation):
                    names.add(arg.arg)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and _ann_is_set(node.annotation):
            names.add(node.target.id)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = node.value
            if isinstance(v, (ast.Set, ast.SetComp)) or (
                    isinstance(v, ast.Call)
                    and isinstance(v.func, ast.Name)
                    and v.func.id in ("set", "frozenset")):
                names.add(node.targets[0].id)
    return names


def _is_set_expr(node: ast.expr, set_names: set[str]) -> bool:
    """Is `node` statically a set?  (Comprehension-rebuilds like
    ``set(xs)`` are sets too, but iterating them is only flagged when the
    *expression itself* appears in an iteration slot.)"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.Attribute):
        return node.attr in _SET_ATTRS
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.Sub,
                                     ast.BitXor)):
        return (_is_set_expr(node.left, set_names)
                and _is_set_expr(node.right, set_names))
    return False
