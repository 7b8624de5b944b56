"""Device-program purity (RPR401-403): no host sync inside a device
program.

The reference's programs are traced: a Python ``if`` or ``.item()`` on a
tracer raises at trace time, so its RPR4xx rules guard trace purity.  The
port runs eagerly, and the same line on a CUDA tensor *works*: it waits
for the device to drain, copies the value back and only then lets the
host queue the next launch.  Inside a decode step, a solver block or a
kernel launcher that is a silent stall on every call.  This pass reads
the port's device programs (the table below, each beside the reference
site it stands for), partitions their parameters into device tensors and
host values, propagates that through locals, and flags every point where
a device tensor's value reaches the host.

What counts as a device tensor ("traced") or a host value ("static"):

* a positional parameter is traced unless its annotation names a host
  type (``int``, ``float``, ``bool``, ``str``, a config, a numpy array, a
  list of requests: anything but ``Tensor``, ``dict``, ``Any``);
  ``self``, ``ctx`` and ``cls`` are neither; keyword-only parameters are
  host options unless annotated as tensors;
* results of ``torch.*`` / ``F.*`` calls, of a method on a traced value
  and of a call to a device program of the table (its first function,
  the entry; the others are its helpers) are traced, unless the callee
  is defined in the same file with a return annotation that names a host
  type; other calls are unknown, never flagged;
* ``.shape`` / ``.dtype`` / ``.ndim`` / ``.device`` / ``.requires_grad``
  / ... and ``.numel()`` / ``.size()`` / ``.stride()`` / ``.dim()`` /
  ``.data_ptr()`` / ``.is_contiguous()`` / ... of anything are static
  (metadata, on the host without a sync), as are ``len()``,
  ``isinstance()`` and ``is`` / ``in`` tests (identity, dict keys);
* ``torch.where`` / ``torch.clamp`` / masked arithmetic are the
  sanctioned branching forms — calls, not Python ``if`` — so they pass.

Rules:

* RPR401 — ``if`` / ``while`` / ``assert`` / a conditional expression on
  a traced value (its truth is a host sync);
* RPR402 — ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
  ``float()`` / ``int()`` / ``bool()`` / ``complex()`` and
  ``np.asarray`` / ``np.array`` of a traced value;
* RPR403 — ``range()`` over a traced bound.

A sync a program needs (the engine's TTFT read, its one read of the
decoded tokens) carries a ``repro-lint: ignore[RPR402] -- reason``.
"""
from __future__ import annotations

import ast
import dataclasses
import enum
from typing import Iterator

from ..diagnostics import Diagnostic, Rule
from ..registry import BaseChecker, FileContext, register_checker
from ._torch import dotted, import_aliases, resolved


@dataclasses.dataclass(frozen=True)
class DeviceProgram:
    """Functions of one port file that make up one device program."""
    path: str                       # under src/repro_torch/
    functions: tuple[str, ...]      # qualified names ("Engine.generate")
    stands_for: tuple[str, ...]     # reference sites it replaces
    note: str = ""


_K = "src/repro/kernels"

#: The port's device programs, each beside the reference's `jax.jit` /
#: `pl.pallas_call` sites it stands for.  The CUDA bodies of the kernels
#: are out of the AST's reach: their launchers and dispatchers are listed.
DEVICE_PROGRAMS: tuple[DeviceProgram, ...] = (
    DeviceProgram("risk/solver.py",
                  ("_candidate_kernel", "_lu_small", "_solve_small",
                   "_solve_small_t"),
                  ("src/repro/risk/solver.py:166",),
                  "anchor candidates and their PDHG verification"),
    DeviceProgram("risk/solver.py", ("_pdhg_setup",),
                  ("src/repro/risk/solver.py:238",),
                  "Ruiz scaling and PDHG step sizes"),
    DeviceProgram("risk/solver.py", ("_pdhg_block", "_pdhg_residuals"),
                  ("src/repro/risk/solver.py:286",),
                  "n_inner PDHG iterations and a restart"),
    DeviceProgram("core/tier_kernels.py", ("_phase2_keys", "_scatter_cols"),
                  ("src/repro/core/xla/kernels.py:57",),
                  "GH phase-2 ranking keys over the lanes"),
    DeviceProgram("core/tier_kernels.py", ("_screen", "_scatter_cols"),
                  ("src/repro/core/xla/kernels.py:133",),
                  "the relocate screen"),
    DeviceProgram("kernels/flash_attention/kernel.py",
                  ("flash_attention", "_check"),
                  (f"{_K}/flash_attention/kernel.py:66",
                   f"{_K}/flash_attention/kernel.py:83"),
                  "launcher of csrc/flash_attention.cu"),
    DeviceProgram("kernels/flash_attention/ops.py",
                  ("flash_attention", "FlashAttention.forward",
                   "FlashAttention.backward"),
                  (f"{_K}/flash_attention/kernel.py:66",),
                  "dispatcher, autograd Function"),
    DeviceProgram("kernels/decode_attention/kernel.py",
                  ("decode_attention", "_check", "_merge_counters"),
                  (f"{_K}/decode_attention/kernel.py:65",
                   f"{_K}/decode_attention/kernel.py:79"),
                  "launcher of csrc/decode_attention.cu"),
    DeviceProgram("kernels/decode_attention/ops.py", ("decode_attention",),
                  (f"{_K}/decode_attention/kernel.py:65",),
                  "dispatcher"),
    DeviceProgram("kernels/ssm_scan/kernel.py", ("ssm_scan", "_check"),
                  (f"{_K}/ssm_scan/kernel.py:62",
                   f"{_K}/ssm_scan/kernel.py:75"),
                  "launcher of csrc/ssm_scan.cu"),
    DeviceProgram("kernels/ssm_scan/ops.py",
                  ("ssm_scan", "SsmScan.forward", "SsmScan.backward"),
                  (f"{_K}/ssm_scan/kernel.py:62",),
                  "dispatcher, autograd Function"),
    DeviceProgram("kernels/rwkv6_wkv/kernel.py", ("rwkv6_wkv", "_check"),
                  (f"{_K}/rwkv6_wkv/kernel.py:62",
                   f"{_K}/rwkv6_wkv/kernel.py:74"),
                  "launcher of csrc/rwkv6_wkv.cu"),
    DeviceProgram("kernels/rwkv6_wkv/ops.py",
                  ("rwkv6_wkv", "Rwkv6Wkv.forward", "Rwkv6Wkv.backward"),
                  (f"{_K}/rwkv6_wkv/kernel.py:62",),
                  "dispatcher, autograd Function"),
    DeviceProgram("kernels/flash_attention_bwd/kernel.py",
                  ("flash_attention_bwd", "_check"), (),
                  "no reference site: XLA differentiates the attention"),
    DeviceProgram("kernels/flash_attention_bwd/ops.py",
                  ("flash_attention_bwd",), (), "dispatcher"),
    DeviceProgram("kernels/ssm_scan_bwd/kernel.py", ("ssm_scan_bwd", "_check"),
                  (), "no reference site: XLA differentiates the scan"),
    DeviceProgram("kernels/ssm_scan_bwd/ops.py", ("ssm_scan_bwd",), (),
                  "dispatcher"),
    DeviceProgram("kernels/rwkv6_wkv_bwd/kernel.py",
                  ("rwkv6_wkv_bwd", "_check"), (),
                  "no reference site: XLA differentiates the scan"),
    DeviceProgram("kernels/rwkv6_wkv_bwd/ops.py", ("rwkv6_wkv_bwd",), (),
                  "dispatcher"),
    DeviceProgram("kernels/int8_grouped_matmul/kernel.py",
                  ("int8_grouped_matmul", "prepass", "_mma", "_wgmma",
                   "_check", "b_layout"), (),
                  "no reference site: the W8A8 experts' XLA einsums, "
                  "src/repro/models/moe.py:64,66,72"),
    DeviceProgram("kernels/int8_grouped_matmul/ops.py",
                  ("int8_grouped_matmul",), (), "dispatcher"),
    DeviceProgram("models/decoder.py", ("prefill",),
                  ("src/repro/serving/engine.py:42",), "the engine's prefill"),
    DeviceProgram("models/decoder.py", ("decode_step",),
                  ("src/repro/serving/engine.py:44",), "one decode step"),
    DeviceProgram("models/layers.py",
                  ("_sharded_decode", "_decode_attention",
                   "merge_decode_parts", "decode_key_positions"),
                  ("src/repro/serving/engine.py:44",),
                  "a decode step's attention, on a cache split on its "
                  "slots: each rank's part and the merge"),
    DeviceProgram("serving/engine.py", ("Engine.generate",),
                  ("src/repro/serving/engine.py:42",
                   "src/repro/serving/engine.py:44"),
                  "prefill, then the decode loop"),
    DeviceProgram("training/train_loop.py", ("make_train_step.train_step",),
                  ("src/repro/training/train_loop.py:40",),
                  "loss, gradients, AdamW"),
    DeviceProgram("models/decoder.py", ("train_loss",),
                  ("src/repro/training/train_loop.py:40",),
                  "the train step's loss"),
    DeviceProgram("models/layers.py",
                  ("chunked_ce_loss", "_VocabParallelNLL.forward",
                   "_VocabParallelNLL.backward",
                   "_LossPlan.logits", "_fsdp_gathered", "_all_reduce"),
                  ("src/repro/training/train_loop.py:40",),
                  "the train step's loss head; on a mesh each rank's rows "
                  "and vocabulary slice, the log-sum-exps merged"),
    DeviceProgram("models/layers.py",
                  ("vocab_parallel_embed", "_VocabParallelEmbed.forward",
                   "_VocabParallelEmbed.backward", "_slice_rows",
                   "_table_moves", "_fsdp_gathered", "_all_reduce"),
                  ("src/repro/training/train_loop.py:40",
                   "src/repro/serving/engine.py:42",
                   "src/repro/serving/engine.py:44"),
                  "the token embedding of the train step, prefill and "
                  "decode; on a mesh each rank's rows on its slice of the "
                  "table"),
    DeviceProgram("training/optimizer.py",
                  ("apply_updates", "_update", "_pieces", "global_norm",
                   "schedule"),
                  ("src/repro/training/train_loop.py:40",),
                  "the train step's AdamW update"),
)

#: Reference `jax.jit` sites with no device program in the port, and why.
NO_COUNTERPART: tuple[tuple[str, str], ...] = tuple(
    (f"src/repro/launch/dryrun.py:{line}",
     f"the dry-run's {what}: the port runs the step eagerly on meta "
     f"DTensors under a fake process group and counts its ops "
     f"(launch/dryrun.py, analysis/op_stats.py); nothing is compiled and "
     f"nothing runs on a device")
    for line, what in ((77, "train step"), (93, "prefill step"),
                       (106, "decode step")))


class Taint(enum.Enum):
    STATIC = 0
    TRACED = 1
    UNKNOWN = 2     # e.g. results of arbitrary calls — never flagged


_STATIC_ATTRS = frozenset({
    "shape", "dtype", "ndim", "size", "itemsize", "device", "is_cuda",
    "is_meta", "requires_grad", "is_leaf", "layout", "names", "grad_fn",
})
_STATIC_METHODS = frozenset({
    "size", "stride", "numel", "nelement", "dim", "ndimension",
    "element_size", "data_ptr", "storage_offset", "is_contiguous",
    "is_floating_point", "is_complex", "get_device", "untyped_storage",
})
_STATIC_CALLS = frozenset({"len", "isinstance", "hasattr", "type", "id",
                           "callable", "issubclass"})
_HOST_FORCERS = frozenset({"float", "int", "bool", "complex"})
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: torch namespaces and functions that return host objects, not tensors
_TORCH_HOST = frozenset({
    "finfo", "iinfo", "device", "dtype", "Size", "is_tensor",
    "is_floating_point", "is_complex", "get_default_dtype", "promote_types",
    "result_type", "can_cast", "is_grad_enabled", "is_inference_mode_enabled",
    "no_grad", "enable_grad", "inference_mode", "Generator", "cuda",
    "backends", "distributed", "profiler", "compiler", "version",
})
#: annotations of a device tensor (or a tree of them)
_TENSOR_ANNOTATIONS = frozenset({"Tensor", "DTensor", "dict", "Any",
                                 "Parameter"})
_NO_TAINT = frozenset({"self", "ctx", "cls"})


def _ann_names(ann: ast.expr) -> set[str]:
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return set()
    return {n.id if isinstance(n, ast.Name) else n.attr
            for n in ast.walk(ann) if isinstance(n, (ast.Name, ast.Attribute))}


def _ann_is_tensor(ann: ast.expr | None) -> bool:
    return ann is None or bool(_ann_names(ann) & _TENSOR_ANNOTATIONS)


def _qualified_defs(tree: ast.Module
                    ) -> dict[str, ast.FunctionDef | ast.AsyncFunctionDef]:
    """Every def of the module by qualified name (``Cls.meth``,
    ``outer.inner``)."""
    out: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    out.setdefault(name, child)
                visit(child, f"{name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def programs_for(posix: str) -> list[DeviceProgram]:
    """The table's programs whose file `posix` is."""
    return [p for p in DEVICE_PROGRAMS
            if posix.endswith(f"repro_torch/{p.path}")]


class _FnScanner:
    """Taint propagation + flagging over one device-program body."""

    def __init__(self, ctx: FileContext, fn: ast.FunctionDef,
                 aliases: dict[str, tuple[str, ...]],
                 returns: dict[str, Taint], programs: frozenset[str]):
        self.ctx = ctx
        self.fn = fn
        self.aliases = aliases
        self.returns = returns
        self.programs = programs
        self.taint: dict[str, Taint] = {}
        a = fn.args
        for arg in (*a.posonlyargs, *a.args):
            if arg.arg in _NO_TAINT:
                self.taint[arg.arg] = Taint.UNKNOWN
            else:
                self.taint[arg.arg] = (Taint.TRACED
                                       if _ann_is_tensor(arg.annotation)
                                       else Taint.STATIC)
        for arg in a.kwonlyargs:
            # keyword-only parameters are options (use_kernels, with_lse,
            # window) unless annotated as tensors
            self.taint[arg.arg] = (
                Taint.TRACED if arg.annotation is not None
                and _ann_is_tensor(arg.annotation) else Taint.STATIC)

    # -- expression taint --------------------------------------------------
    def eval(self, node: ast.expr) -> Taint:
        if isinstance(node, ast.Name):
            return self.taint.get(node.id, Taint.UNKNOWN)
        if isinstance(node, ast.Constant):
            return Taint.STATIC
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return Taint.STATIC
            return self.eval(node.value)
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            if base is Taint.STATIC:        # shape[0] etc.
                return Taint.STATIC
            return base
        if isinstance(node, (ast.BinOp,)):
            return self._join(self.eval(node.left), self.eval(node.right))
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.BoolOp):
            return self._join(*(self.eval(v) for v in node.values))
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return Taint.STATIC     # identity, dict keys
            return self._join(self.eval(node.left),
                              *(self.eval(c) for c in node.comparators))
        if isinstance(node, (ast.Tuple, ast.List)):
            return self._join(*(self.eval(e) for e in node.elts))
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.IfExp):
            return self._join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        return Taint.UNKNOWN

    def _eval_call(self, node: ast.Call) -> Taint:
        f = node.func
        dd = resolved(f, self.aliases)
        if isinstance(f, ast.Name):
            if f.id in _STATIC_CALLS or f.id in _HOST_FORCERS:
                return Taint.STATIC         # forcers are flagged elsewhere
            if f.id in self.returns:
                return self.returns[f.id]
        if isinstance(f, ast.Attribute):
            if f.attr in _STATIC_METHODS or f.attr in _HOST_METHODS:
                return Taint.STATIC
            if self.eval(f.value) is Taint.TRACED:
                return Taint.TRACED         # x.sum(), x.to(...), d.get(k)
        if dd[:1] == ("torch",):
            return (Taint.STATIC if len(dd) > 1 and dd[1] in _TORCH_HOST
                    else Taint.TRACED)
        if dd and dd[-1] in self.programs:
            return Taint.TRACED
        return Taint.UNKNOWN

    @staticmethod
    def _join(*ts: Taint) -> Taint:
        if any(t is Taint.TRACED for t in ts):
            return Taint.TRACED
        if all(t is Taint.STATIC for t in ts):
            return Taint.STATIC
        return Taint.UNKNOWN

    # -- statement walk ----------------------------------------------------
    def scan(self) -> Iterator[Diagnostic]:
        yield from self._scan_body(self.fn.body)

    def _scan_body(self, body: list[ast.stmt]) -> Iterator[Diagnostic]:
        for node in body:
            yield from self._scan_stmt(node)

    def _bind(self, tgt: ast.expr, t: Taint) -> None:
        elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
        for e in elts:
            if isinstance(e, ast.Starred):
                e = e.value
            if isinstance(e, ast.Name):
                self.taint[e.id] = t

    def _scan_stmt(self, node: ast.stmt) -> Iterator[Diagnostic]:
        if isinstance(node, ast.Assign):
            t = self.eval(node.value)
            for tgt in node.targets:
                self._bind(tgt, t)
            yield from self._scan_expr(node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._bind(node.target, self.eval(node.value))
            yield from self._scan_expr(node.value)
        elif isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Name):
                self.taint[node.target.id] = self._join(
                    self.taint.get(node.target.id, Taint.UNKNOWN),
                    self.eval(node.value))
            yield from self._scan_expr(node.value)
        elif isinstance(node, ast.If):
            if self.eval(node.test) is Taint.TRACED:
                yield self._diag(node, "RPR401",
                                 "Python `if` on a device tensor syncs the "
                                 "host — use torch.where / masks")
            yield from self._scan_expr(node.test)
            yield from self._scan_body(node.body)
            yield from self._scan_body(node.orelse)
        elif isinstance(node, ast.While):
            if self.eval(node.test) is Taint.TRACED:
                yield self._diag(node, "RPR401",
                                 "`while` on a device tensor syncs the host "
                                 "every trip")
            yield from self._scan_expr(node.test)
            yield from self._scan_body(node.body)
            yield from self._scan_body(node.orelse)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            is_range = isinstance(it, ast.Call) \
                and dotted(it.func) == ("range",)
            if is_range and any(self.eval(a) is Taint.TRACED
                                for a in it.args):
                yield self._diag(node, "RPR403",
                                 "range() over a device tensor reads its "
                                 "value back to the host")
            yield from self._scan_expr(it)
            self._bind(node.target,
                       Taint.STATIC if is_range else Taint.UNKNOWN)
            yield from self._scan_body(node.body)
            yield from self._scan_body(node.orelse)
        elif isinstance(node, ast.Assert):
            if self.eval(node.test) is Taint.TRACED:
                yield self._diag(node, "RPR401",
                                 "assert on a device tensor syncs the host "
                                 "— check a static precondition")
            yield from self._scan_expr(node.test)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                yield from self._scan_expr(item.context_expr)
            yield from self._scan_body(node.body)
        elif isinstance(node, ast.Try):
            yield from self._scan_body(node.body)
            for h in node.handlers:
                yield from self._scan_body(h.body)
            yield from self._scan_body(node.orelse)
            yield from self._scan_body(node.finalbody)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested helper: its body is scanned with the enclosing taint
            # still visible for closures.
            yield from self._scan_body(node.body)
        elif isinstance(node, ast.Return) and node.value is not None:
            yield from self._scan_expr(node.value)
        elif isinstance(node, ast.Expr):
            yield from self._scan_expr(node.value)

    def _scan_expr(self, node: ast.expr) -> Iterator[Diagnostic]:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            # float(x) / int(x) / bool(x) on device tensors
            if isinstance(sub.func, ast.Name) \
                    and sub.func.id in _HOST_FORCERS and sub.args:
                if self.eval(sub.args[0]) is Taint.TRACED:
                    yield self._diag(
                        sub, "RPR402",
                        f"{sub.func.id}() of a device tensor syncs the host")
            # x.item(), x.tolist(), x.cpu(), x.numpy() on device tensors
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _HOST_METHODS \
                    and self.eval(sub.func.value) is Taint.TRACED:
                yield self._diag(
                    sub, "RPR402",
                    f".{sub.func.attr}() copies a device tensor to the host")
            # np.asarray(device tensor)
            dd = resolved(sub.func, self.aliases)
            if dd[:1] == ("numpy",) and dd[-1:] in (("asarray",),
                                                    ("array",)) \
                    and sub.args \
                    and self.eval(sub.args[0]) is Taint.TRACED:
                yield self._diag(
                    sub, "RPR402",
                    "np.asarray of a device tensor copies it to the host")
        for sub in ast.walk(node):
            if isinstance(sub, ast.IfExp) \
                    and self.eval(sub.test) is Taint.TRACED:
                yield self._diag(
                    sub, "RPR401",
                    "conditional expression on a device tensor syncs the "
                    "host — use torch.where")

    def _diag(self, node: ast.AST, code: str, msg: str) -> Diagnostic:
        return Diagnostic(self.ctx.display, node.lineno, node.col_offset,
                          code, f"{msg} (in `{self.fn.name}`)")


def _return_taints(defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef]
                   ) -> dict[str, Taint]:
    """Module-level functions with a return annotation: a host type's
    result is static, a tensor's traced."""
    out: dict[str, Taint] = {}
    for name, fn in defs.items():
        if "." in name or fn.returns is None:
            continue
        out[name] = (Taint.TRACED if _ann_is_tensor(fn.returns)
                     else Taint.STATIC)
    return out


@register_checker
class JitPurityChecker(BaseChecker):
    scope = tuple(sorted({f"repro_torch/{p.path}" for p in DEVICE_PROGRAMS}))
    rules = (
        Rule("RPR401", "python-branch-on-device-tensor",
             "no Python branching on device tensors in device programs"),
        Rule("RPR402", "device-tensor-host-sync",
             "no .item()/.tolist()/.cpu()/float() host syncs on device "
             "tensors in device programs"),
        Rule("RPR403", "data-dependent-loop-bound",
             "Python loop bounds in device programs must be host values"),
    )

    def check(self, ctx: FileContext) -> Iterator[Diagnostic]:
        programs = programs_for(ctx.posix)
        if not programs:
            return
        defs = _qualified_defs(ctx.tree)
        aliases = import_aliases(ctx.tree)
        returns = _return_taints(defs)
        names = frozenset(p.functions[0].rsplit(".", 1)[-1]
                          for p in DEVICE_PROGRAMS)
        seen: set[str] = set()
        for p in programs:
            for qual in p.functions:
                fn = defs.get(qual)
                if fn is None or qual in seen:
                    continue
                seen.add(qual)
                yield from _FnScanner(ctx, fn, aliases, returns,
                                      names).scan()
