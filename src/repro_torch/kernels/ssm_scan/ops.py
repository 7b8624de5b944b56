"""Public Mamba2 SSD scan op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

`ssm_scan.launches` counts the kernel's launches, so a run can show that
its prefill went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import ITEM_8B, refuse_grad
from . import kernel
from .ref import ssm_scan_ref


def ssm_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,T,nh,hp]; Bm, Cm [B,T,N]; dt [B,T,nh]; A, D [nh]; state
    [B,nh,hp,N] f32 carried in (None: zeros). Returns (y [B,T,nh,hp] in
    x's dtype, D x included; final state [B,nh,hp,N] f32). For a CUDA
    tensor this launches the kernel or raises; only a CPU tensor takes the
    plain version. It has no backward: on CUDA it raises
    NotImplementedError when a gradient is asked of it."""
    if x.device.type == "cpu":
        return ssm_scan_ref(x, Bm, Cm, dt, A, D, state)
    refuse_grad("ssm_scan", ITEM_8B, x, Bm, Cm, dt, A, D, state)
    out = kernel.ssm_scan(x, Bm, Cm, dt, A, D, state)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
