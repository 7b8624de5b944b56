"""Public flash-attention (prefill) op: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors.

`flash_attention.launches` counts the kernel's launches, so a run can show
that its prefill went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None,
                    window: int = 0) -> torch.Tensor:
    """q [B,H,Tq,hd]; k, v [B,KV,Tk,hd]; q_pos [Tq], k_pos [Tk] int32
    (default: 0..T-1). Any strides: pass the model's [B,T,H,hd] tensors
    as `.transpose(1, 2)` views. For a CUDA tensor this launches the
    kernel or raises; only a CPU tensor takes the plain version."""
    Tq, Tk = q.shape[2], k.shape[2]
    if q_pos is None:
        q_pos = torch.arange(Tq, dtype=torch.int32, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(Tk, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos, k_pos, window=window)
    out = kernel.flash_attention(q, k, v, q_pos, k_pos, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
