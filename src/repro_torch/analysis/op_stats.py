"""Per-device op statistics of a step, the port's counterpart of the
reference's trip-count-aware HLO cost analysis (`analysis/hlo_stats.py`).

The port has no compiled program to read, so it counts the work while
the step runs: eagerly, on meta tensors (shapes only, no data), with its
parameters, caches and inputs made DTensors on a mesh over a fake process
group. `OpCounter` is a `TorchDispatchMode` that sees each aten op on the
LOCAL tensors one rank would hold, and derives

    * flops             from `torch.utils.flop_counter.flop_registry`
                        (matmuls, batched matmuls, convolutions, attention)
    * bytes accessed    operand + output bytes of each op
    * bytes written     output bytes of each op
    * collective bytes  output bytes of each `_c10d_functional` collective,
                        by kind in the reference's names

with views, `detach` and allocations skipped, as the reference skips
bitcasts, tuples and parameters. Totals are PER DEVICE, what the per-chip
roofline needs, and every op is counted as often as it runs: the eager
step has no loops to weight.

Two calls are NOT counted, because they are not work of the rank: the
call of an op on DTensors (the counter declines it, so DTensor runs it on
the local shards, which are counted), and the calls DTensor's sharding
propagation makes on global-shape `FakeTensor`s.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
_COLLECTIVE_KIND = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_to_all", "all-to-all"),
                    ("broadcast", "collective-permute"))
# ops that move no data of their own: their outputs alias an input, or are
# allocations a later op writes
_SKIP_BYTES_OPS = {"detach", "alias", "lift_fresh", "empty", "empty_like",
                   "empty_strided", "new_empty", "new_empty_strided",
                   "_unsafe_view", "wait_tensor", "_wrap_tensor_autograd"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree, local shards for DTensors."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree))


@dataclasses.dataclass
class OpStats:
    """The fields of the reference's `HloStats`, per device."""
    flops: float = 0.0
    bytes_accessed: float = 0.0        # upper bound: operands + outputs
    bytes_written: float = 0.0         # lower bound: each buffer written once
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    argument_bytes: float = 0.0

    @property
    def bytes_estimate(self) -> float:
        """Roofline memory-traffic estimate: geometric mean of the
        write-once lower bound (perfect fusion) and the operands+outputs
        upper bound (no reuse), the reference's."""
        lo = self.bytes_written + self.argument_bytes
        hi = max(self.bytes_accessed, lo)
        return (lo * hi) ** 0.5


def _collective_kind(name: str) -> str:
    for key, kind in _COLLECTIVE_KIND:
        if name.startswith(key):
            return kind
    return name


class OpCounter(TorchDispatchMode):
    """Counts one rank's work in `self.stats` while active (see the module
    note). Stack it OUTSIDE any `FlopCounterMode` that should see the
    global (DTensor-level) ops."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on local shards
        out = func(*args, **kwargs)
        ins = tree_leaves((args, kwargs))
        if any(isinstance(a, FakeTensor) for a in ins):
            return out                     # sharding propagation
        self._count(func, ins, args, kwargs, out)
        return out

    def _count(self, func, ins, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        s = self.stats
        name = func.__name__.split(".")[0]
        outs = tree_leaves(out)
        if func.namespace in COLLECTIVE_NS and name not in _SKIP_BYTES_OPS:
            b = sum(_nbytes(t) for t in outs)
            kind = _collective_kind(name)
            s.collective_bytes += b
            s.collectives[kind] = s.collectives.get(kind, 0) + b
            s.n_collectives += 1
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            s.flops += flop(*args, **kwargs, out_val=out)
        if func.is_view or name in _SKIP_BYTES_OPS:
            return
        written = sum(_nbytes(t) for t in outs)
        s.bytes_written += written
        s.bytes_accessed += written + sum(_nbytes(t) for t in ins)
