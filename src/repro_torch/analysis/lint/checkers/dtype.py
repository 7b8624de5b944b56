"""f64 dtype discipline (RPR301-303) in the allocator tier, the risk
solver and the kernels.

The numpy oracle runs in float64 and the tier's <=-objective contract
leaves no room for f32 rounding in ranking keys; the risk solver's
stopping rule (primal feasibility < 1e-8, relative gap < 1e-7) needs f64
too.  torch *defaults* to float32 (``torch.get_default_dtype()``), so any
floating tensor built without a dtype is a latent precision downgrade,
as an implicit-dtype ``jnp`` construction is in the reference.  Scope:
``repro_torch/core/tier*.py``, ``repro_torch/kernels/`` and
``repro_torch/risk/``, the counterparts of the reference's ``core/xla/``,
``kernels/`` and ``risk/``.

* RPR301 — ``torch.zeros`` / ``ones`` / ``empty`` / ``full`` / ``tensor``
  / ``as_tensor`` / ``arange`` / ``linspace`` / ``logspace`` / ``eye`` /
  ``scalar_tensor`` must pin a dtype: by keyword, in ``as_tensor``'s
  positional dtype slot, or through a ``**kw`` whose dict (built in the
  same file as ``dict(dtype=..., ...)`` or ``{"dtype": ...}``) carries
  one.  ``torch.*_like``, ``Tensor.new_*`` and ``.to(other)`` inherit a
  dtype and are exempt (they are not in the list).
* RPR302 — f32 narrowing is banned in the tier and ``risk/``:
  ``.float()`` / ``.half()`` / ``.bfloat16()``, ``.to(torch.float32)``
  (any argument or ``dtype=``), ``.type(...)`` / ``.astype(...)`` to an
  f32 or narrower type, ``np.float32(x)``, and a ``dtype=torch.float32``
  keyword in any call.  The kernels are OUT of scope by design, as in the
  reference: they compute in f32 and bf16 on purpose (see
  src/repro_torch/README.md "Invariants & static enforcement").
* RPR303 — stays registered and finds nothing in torch.  The reference's
  hazard is a weakly typed float literal entering a jitted callable:
  promotion there can demote the whole trace.  torch has no trace to
  demote, and a Python float in an op is a *wrapped number* that never
  decides the result's dtype when a tensor operand is present
  (``torch.ones(2, dtype=torch.float64) * 0.5`` and ``torch.where(m,
  f64, 1.0)`` stay f64).  A Python float turns into a default-dtype
  (f32) tensor only where it is made a tensor on its own —
  ``torch.tensor(0.5)``, ``torch.full(shape, 0.5)``,
  ``torch.scalar_tensor(0.5)`` — and RPR301 flags each of those.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..diagnostics import Diagnostic, Rule
from ..registry import BaseChecker, FileContext, register_checker
from ._torch import dotted, import_aliases, keyword, resolved

#: constructor -> index of its positional dtype slot (None = kwarg only)
_TORCH_CREATORS: dict[str, int | None] = {
    "zeros": None, "ones": None, "empty": None, "full": None,
    "tensor": None, "as_tensor": 1, "arange": None, "linspace": None,
    "logspace": None, "eye": None, "scalar_tensor": None,
}

_NARROW_NAMES = frozenset({"float32", "bfloat16", "float16", "half"})
_NARROW_METHODS = frozenset({"float", "half", "bfloat16"})
_CAST_METHODS = frozenset({"to", "type", "astype"})


def _is_narrow(node: ast.expr, aliases: dict[str, tuple[str, ...]]) -> bool:
    """Does `node` name an f32-or-narrower floating dtype?"""
    if isinstance(node, ast.Constant):
        return node.value in _NARROW_NAMES
    dd = resolved(node, aliases)
    return (bool(dd) and dd[-1] in _NARROW_NAMES) \
        or dd == ("torch", "float")


def _dtype_dicts(tree: ast.Module) -> set[str]:
    """Names bound anywhere in the file to a dict that carries a dtype:
    ``like = dict(dtype=..., device=...)`` or ``{"dtype": ...}``."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        if isinstance(v, ast.Call) and dotted(v.func) == ("dict",) \
                and keyword(v, "dtype") is not None \
                or isinstance(v, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "dtype"
                    for k in v.keys):
            names.add(node.targets[0].id)
    return names


@register_checker
class DtypeChecker(BaseChecker):
    scope = ("repro_torch/core/tier", "repro_torch/kernels/",
             "repro_torch/risk/")
    rules = (
        Rule("RPR301", "implicit-tensor-dtype",
             "torch tensor construction must pin an explicit dtype"),
        Rule("RPR302", "f32-narrowing",
             "no float32/bf16 narrowing in the f64 tier and risk solver"),
        Rule("RPR303", "weak-float-literal-into-jit",
             "float literals entering jitted callables are weakly typed "
             "(no torch counterpart: wrapped numbers never demote)"),
    )

    #: RPR302 applies only here; `kernels/` compute in f32 by design.
    #: `risk/` is an f64 LP tier like the allocator tier — narrowing banned.
    _NARROW_SCOPE = ("repro_torch/core/tier", "repro_torch/risk/")

    def check(self, ctx: FileContext) -> Iterator[Diagnostic]:
        aliases = import_aliases(ctx.tree)
        dicts = _dtype_dicts(ctx.tree)
        narrow = any(s in ctx.posix for s in self._NARROW_SCOPE)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            yield from self._check_creation(ctx, node, aliases, dicts)
            if narrow:
                yield from self._check_narrowing(ctx, node, aliases)

    def _check_creation(self, ctx: FileContext, node: ast.Call,
                        aliases: dict[str, tuple[str, ...]],
                        dicts: set[str]) -> Iterator[Diagnostic]:
        dd = resolved(node.func, aliases)
        if len(dd) != 2 or dd[0] != "torch" or dd[1] not in _TORCH_CREATORS:
            return
        if keyword(node, "dtype") is not None:
            return
        if any(kw.arg is None and isinstance(kw.value, ast.Name)
               and kw.value.id in dicts for kw in node.keywords):
            return      # **like, a dict that carries the dtype
        slot = _TORCH_CREATORS[dd[1]]
        if slot is not None and len(node.args) > slot:
            return      # positional dtype slot filled
        yield Diagnostic(
            ctx.display, node.lineno, node.col_offset, "RPR301",
            f"torch.{dd[1]} without an explicit dtype takes the default "
            f"(float32) for float data — pin dtype= explicitly")

    def _check_narrowing(self, ctx: FileContext, node: ast.Call,
                         aliases: dict[str, tuple[str, ...]]
                         ) -> Iterator[Diagnostic]:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _NARROW_METHODS \
                and not node.args and not node.keywords:
            yield Diagnostic(
                ctx.display, node.lineno, node.col_offset, "RPR302",
                f".{f.attr}() narrows inside the f64 tier")
            return
        if isinstance(f, ast.Attribute) and f.attr in _CAST_METHODS \
                and any(_is_narrow(a, aliases) for a in node.args):
            yield Diagnostic(
                ctx.display, node.lineno, node.col_offset, "RPR302",
                f".{f.attr}() to an f32 or narrower dtype inside the f64 "
                f"tier")
            return
        dt = keyword(node, "dtype")
        if dt is not None and _is_narrow(dt, aliases):
            yield Diagnostic(
                ctx.display, node.lineno, node.col_offset, "RPR302",
                "dtype= an f32 or narrower dtype inside the f64 tier")
            return
        # np.float32(x) / torch.float32(x)
        dd = dotted(f)
        if len(dd) == 2 and dd[1] in _NARROW_NAMES:
            yield Diagnostic(
                ctx.display, node.lineno, node.col_offset, "RPR302",
                f"{'.'.join(dd)} cast inside the f64 tier")
