"""Public flash-attention backward op: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors.

`flash_attention_bwd.launches` counts the kernel's launches (one per call:
the pre-pass and the dK/dV + dQ kernel together), so a training run can
show that its attention gradients went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_bwd_ref


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int = 0):
    """(dq, dk, dv) of `flash_attention(q, k, v, q_pos, k_pos, window)`
    given its output o, its log-sum-exp lse and the output's gradient do.
    For a CUDA tensor this launches the kernel or raises; only a CPU
    tensor takes the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, q_pos, k_pos,
                                       window)
    out = kernel.flash_attention_bwd(q, k, v, o, lse, do, q_pos, k_pos,
                                     window)
    flash_attention_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0
