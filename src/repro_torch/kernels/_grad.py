"""Autograd around the ctypes kernels. Autograd cannot see through a
ctypes launch: a kernel either sits inside a `torch.autograd.Function`
whose backward launches its backward kernel, or refuses a gradient
(`refuse_grad`), so that none is dropped without a word. Host-side
checks only: no device sync."""
from __future__ import annotations

import torch

from ._layout import aligned16


def refuse_grad(kernel: str, why: str, *tensors: torch.Tensor | None) -> None:
    """Raise NotImplementedError when grad mode is on and an input requires
    a gradient, which `kernel` cannot give (`why` says why)."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel, and a gradient is asked of "
            f"its inputs: {why}")


def wants_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def unit_last(g: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """An output's gradient as a backward kernel reads it (by 16-byte
    copies): zeros shaped as `like` when autograd passes none, a copy only
    where the layout is not one the kernels take (a gradient broadcast
    from a sum has stride 0; a view may be misaligned)."""
    if g is None:
        return torch.zeros_like(like)
    if min(g.stride()) < 0 or not aligned16(g.shape, g.stride(),
                                            g.element_size(), g.data_ptr()):
        return g.clone(memory_format=torch.contiguous_format)
    return g
