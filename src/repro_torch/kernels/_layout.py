"""The memory layout the kernels read by 16-byte copies (TMA boxes in
prefill, cp.async in decode and in the two scans): a 16-byte-aligned
base, a unit stride on the last axis, and every other stride a multiple
of 16 bytes (or of a smaller piece that a kernel reads: the head_dim
-split decode pair reads 4-lane rows of bf16 by 8-byte loads).
A dimension of extent 1 never moves, so its stride does not count."""
from __future__ import annotations

import torch

from ..device import is_dtensor


def aligned16(shape, strides, itemsize: int, data_ptr: int,
              align: int = 16) -> bool:
    """Whether a tensor of this shape, element strides, element size and
    base address can be read in 16-byte pieces (`align`-byte pieces)."""
    if data_ptr % align or (shape[-1] > 1 and strides[-1] != 1):
        return False
    return all(n == 1 or (s * itemsize) % align == 0
               for n, s in zip(shape[:-1], strides[:-1]))


def check_aligned(kernel: str, align: int = 16,
                  **tensors: torch.Tensor) -> None:
    """Raise ValueError naming the first tensor `kernel` cannot read, and
    TypeError for a DTensor: a kernel reads one rank's local tensors, so
    a sharded caller runs it through `local_map`."""
    for name, t in tensors.items():
        if is_dtensor(t):
            raise TypeError(f"{kernel}: {name} is a DTensor; call the "
                            f"kernel on local shards (local_map)")
        if not aligned16(t.shape, t.stride(), t.element_size(),
                         t.data_ptr(), align):
            raise ValueError(
                f"{kernel}: {name} must have a {align}-byte-aligned base "
                f"and {align}-byte-multiple strides (unit last stride), got "
                f"address {t.data_ptr():#x}, strides {t.stride()}, "
                f"{t.element_size()}-byte elements")
