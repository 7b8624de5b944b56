"""Public Mamba2 SSD scan backward op: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors.

`ssm_scan_bwd.launches` counts the kernel's launches (one per call: the
sweep over the chunks and the fixed-order sums together), so a training
run can show that its scan gradients went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import ssm_scan_bwd_ref


def ssm_scan_bwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 states: torch.Tensor, dy: torch.Tensor,
                 dstate: torch.Tensor | None = None):
    """(dx, dBm, dCm, ddt, dA, dD, dstate_in) of `ssm_scan(x, Bm, Cm, dt,
    A, D, state)` given dy and dstate (None: zeros). `states` [B,nh,
    ceil(T/32),hp,N] f32 holds the state each 32-step chunk starts from,
    as the forward kernel gives it (`ssm_scan.kernel.ssm_scan(...,
    with_states=True)`); the first is the state carried in. For a CUDA
    tensor this launches the kernel or raises; only a CPU tensor takes the
    plain version, which reads the state carried in and recomputes the
    rest. The kernel returns dx, dBm, dCm in x's dtype and the rest in
    f32."""
    if x.device.type == "cpu":
        return ssm_scan_bwd_ref(x, Bm, Cm, dt, A, D, states[:, :, 0], dy,
                                dstate)
    out = kernel.ssm_scan_bwd(x, Bm, Cm, dt, A, D, states, dy, dstate)
    ssm_scan_bwd.launches += 1
    return out


ssm_scan_bwd.launches = 0
