"""The allocator's lane-batched tier — lazy, torch-free entry point.

This package hosts the ``engine="torch"`` tier of the allocator (the
reference's ``engine="xla"``, a name the facade maps to the same tier):
the hot numeric core of GH Phase-2 ranking and the local search's
candidate screen run as float64 torch programs over device-resident
instance tensors, with every multi-start ordering evaluated in lockstep
as a batch lane.  The numpy engine (`core.agh.agh`) remains the bit-exact
oracle and the default; this tier must only ever match or beat its
objective (enforced by tests/test_torch_tier.py).

Importing *this* module never imports torch — the heavy modules
(`tier_tensors`, `tier_kernels`, `tier_engine`) load on first use via
`load_engine()`, so ``from repro_torch import plan`` stays torch-free
unless ``engine="torch"`` is actually requested.  The tier runs on CUDA
unless the caller passes ``device="cpu"``, and raises without CUDA.
"""
from __future__ import annotations


class EngineUnavailableError(RuntimeError):
    """Raised when `plan()` is asked for an allocator engine this package
    cannot run: the message names the engine and why."""


def load_engine():
    """Import and return the tier's engine module
    (`repro_torch.core.tier_engine`).

    The import happens here, not at package import, so torch is only paid
    for when the tier is requested.  Raises `EngineUnavailableError` when
    torch is absent.
    """
    try:
        from . import tier_engine
    except ImportError as exc:
        raise EngineUnavailableError(
            "engine='torch' requires torch, which is not installed in this "
            "environment; use the default engine='numpy'.") from exc
    return tier_engine


def agh_torch(*args, **kwargs):
    """Convenience delegate to `repro_torch.core.tier_engine.agh_torch`
    (lazy)."""
    return load_engine().agh_torch(*args, **kwargs)


__all__ = ["EngineUnavailableError", "load_engine", "agh_torch"]
