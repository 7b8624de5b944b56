"""The guard of the kernels that have no backward yet: autograd cannot
see through a ctypes launch, so a gradient asked of one would be dropped
without a word. A host-side check of grad mode and `requires_grad`: no
device sync."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, why: str, *tensors: torch.Tensor | None) -> None:
    """Raise NotImplementedError when grad mode is on and an input requires
    a gradient, which `kernel` cannot give (`why` says what brings it)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel, and a gradient is asked of "
            f"its inputs: {why}")

# What brings the backwards of the kernels that lack one.
ITEM_8B = ("ROADMAP item 8b queues its backward (train rwkv6 and mamba2 / "
           "zamba2 on the CPU, or with use_kernels=False, until then)")
