"""Public Mamba2 SSD scan op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

When a gradient is asked for (grad mode on and an input requiring it), a
CUDA call goes through `SsmScan`, an autograd Function whose forward
launches the kernel with its chunk-state output and whose backward
launches the backward kernel (`kernels.ssm_scan_bwd`). Inference takes
the forward alone, with no chunk states. A CPU call takes the plain
version, which autograd differentiates through its PyTorch ops.

`ssm_scan.launches` counts the forward kernel's launches, so a run can
show that its prefill (or training forward) went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import unit_last, wants_grad
from ..ssm_scan_bwd.ops import ssm_scan_bwd
from . import kernel
from .ref import ssm_scan_ref


class SsmScan(torch.autograd.Function):
    """The forward kernel with its chunk states, saved for the backward
    kernel. Both outputs, y and the final state, may carry a gradient."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A, D, state):
        y, s_out, states = kernel.ssm_scan(x, Bm, Cm, dt, A, D, state,
                                           with_states=True)
        ssm_scan.launches += 1
        ctx.save_for_backward(x, Bm, Cm, dt, A, D, states)
        ctx.has_state = state is not None
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        x, Bm, Cm, dt, A, D, states = ctx.saved_tensors
        if dstate is not None:
            dstate = dstate.float().contiguous()
        dx, dB, dC, ddt, dA, dD, ds_in = ssm_scan_bwd(
            x, Bm, Cm, dt, A, D, states, unit_last(dy, x), dstate)
        return (dx, dB.to(Bm.dtype), dC.to(Cm.dtype), ddt.to(dt.dtype),
                dA.to(A.dtype), dD.to(D.dtype),
                ds_in if ctx.has_state else None)


def ssm_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,T,nh,hp]; Bm, Cm [B,T,N]; dt [B,T,nh]; A, D [nh]; state
    [B,nh,hp,N] f32 carried in (None: zeros). Returns (y [B,T,nh,hp] in
    x's dtype, D x included; final state [B,nh,hp,N] f32). For a CUDA
    tensor this launches the kernel (and, under autograd, its backward)
    or raises; only a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return ssm_scan_ref(x, Bm, Cm, dt, A, D, state)
    if wants_grad(x, Bm, Cm, dt, A, D, state):
        return SsmScan.apply(x, Bm, Cm, dt, A, D, state)
    out = kernel.ssm_scan(x, Bm, Cm, dt, A, D, state)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
