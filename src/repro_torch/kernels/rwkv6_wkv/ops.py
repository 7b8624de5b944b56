"""Public RWKV6 WKV op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

When a gradient is asked for (grad mode on and an input requiring it), a
CUDA call goes through `Rwkv6Wkv`, an autograd Function whose forward
launches the kernel with its chunk-state output and whose backward
launches the backward kernel (`kernels.rwkv6_wkv_bwd`). Inference takes
the forward alone, with no chunk states. A CPU call takes the plain
version, which autograd differentiates through its PyTorch ops.

`rwkv6_wkv.launches` counts the forward kernel's launches, so a run can
show that its prefill (or training forward) went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import unit_last, wants_grad
from ..rwkv6_wkv_bwd.ops import rwkv6_wkv_bwd
from . import kernel
from .ref import rwkv6_wkv_ref


class Rwkv6Wkv(torch.autograd.Function):
    """The forward kernel with its chunk states, saved for the backward
    kernel. Both outputs, y and the final state, may carry a gradient."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state):
        y, s_out, states = kernel.rwkv6_wkv(r, k, v, lw, u, state,
                                            with_states=True)
        rwkv6_wkv.launches += 1
        ctx.save_for_backward(r, k, v, lw, u, states)
        ctx.has_state = state is not None
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, lw, u, states = ctx.saved_tensors
        if dstate is not None:
            dstate = dstate.float().contiguous()
        dr, dk, dv, dlw, du, ds_in = rwkv6_wkv_bwd(
            r, k, v, lw, u, states, unit_last(dy, r), dstate)
        return (dr, dk, dv, dlw, du.to(u.dtype),
                ds_in if ctx.has_state else None)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor,
              state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [B,T,H,hd] (lw the log decay, < 0); u [H,hd]; state
    [B,H,hd,hd] f32 carried in (None: zeros). Returns (y [B,T,H,hd] in r's
    dtype, final state [B,H,hd,hd] f32). For a CUDA tensor this launches
    the kernel (and, under autograd, its backward) or raises; only a CPU
    tensor takes the plain version."""
    if r.device.type == "cpu":
        return rwkv6_wkv_ref(r, k, v, lw, u, state)
    if wants_grad(r, k, v, lw, u, state):
        return Rwkv6Wkv.apply(r, k, v, lw, u, state)
    out = kernel.rwkv6_wkv(r, k, v, lw, u, state)
    rwkv6_wkv.launches += 1
    return out


rwkv6_wkv.launches = 0
