"""Public RWKV6 WKV backward op: the Hopper kernel for CUDA tensors, the
plain version for CPU tensors.

`rwkv6_wkv_bwd.launches` counts the kernel's launches (one per call: the
sweep over the chunks and the fixed-order sum together), so a
training run can show that its WKV gradients went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import rwkv6_wkv_bwd_ref


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor,
                  states: torch.Tensor, dy: torch.Tensor,
                  dstate: torch.Tensor | None = None):
    """(dr, dk, dv, dlw, du, dstate_in) of `rwkv6_wkv(r, k, v, lw, u,
    state)` given dy and dstate (None: zeros). `states` [B,H,ceil(T/32),
    hd,hd] f32 holds the state each 32-step chunk starts from, as the
    forward kernel gives it (`rwkv6_wkv.kernel.rwkv6_wkv(...,
    with_states=True)`); the first is the state carried in. For a CUDA
    tensor this launches the kernel or raises; only a CPU tensor takes the
    plain version, which reads the state carried in and recomputes the
    rest. The kernel returns dr, dk, dv, dlw in r's dtype and the rest in
    f32."""
    if r.device.type == "cpu":
        return rwkv6_wkv_bwd_ref(r, k, v, lw, u, states[:, :, 0], dy,
                                 dstate)
    out = kernel.rwkv6_wkv_bwd(r, k, v, lw, u, states, dy, dstate)
    rwkv6_wkv_bwd.launches += 1
    return out


rwkv6_wkv_bwd.launches = 0
