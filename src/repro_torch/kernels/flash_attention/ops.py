"""Public flash-attention (prefill) op: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors.

When a gradient is asked for (grad mode on and q, k or v requiring it), a
CUDA call goes through `FlashAttention`, an autograd Function whose
forward launches the kernel with its log-sum-exp output and whose backward
launches the backward kernel (`kernels.flash_attention_bwd`). Inference
takes the forward alone, with no log-sum-exp. A CPU call takes the plain
version, which autograd differentiates through its PyTorch ops.

`flash_attention.launches` counts the forward kernel's launches, so a run
can show that its prefill (or training forward) went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import wants_grad
from .._layout import aligned16
from ..flash_attention_bwd.ops import flash_attention_bwd
from . import kernel
from .ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its LSE, saved for the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window):
        out, lse = kernel.flash_attention(q, k, v, q_pos, k_pos, window,
                                          with_lse=True)
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        if not aligned16(do.shape, do.stride(), do.element_size(),
                         do.data_ptr()):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, q_pos, k_pos,
                                         ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None,
                    window: int = 0) -> torch.Tensor:
    """q [B,H,Tq,hd]; k, v [B,KV,Tk,hd]; q_pos [Tq], k_pos [Tk] int32
    (default: 0..T-1). Any strides: pass the model's [B,T,H,hd] tensors
    as `.transpose(1, 2)` views. For a CUDA tensor this launches the
    kernel (and, under autograd, its backward) or raises; only a CPU
    tensor takes the plain version."""
    Tq, Tk = q.shape[2], k.shape[2]
    if q_pos is None:
        q_pos = torch.arange(Tq, dtype=torch.int32, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(Tk, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_pos, k_pos, window=window)
    if wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, q_pos, k_pos, int(window))
    out = kernel.flash_attention(q, k, v, q_pos, k_pos, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
