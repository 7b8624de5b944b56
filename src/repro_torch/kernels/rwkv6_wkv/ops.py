"""Public RWKV6 WKV op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

`rwkv6_wkv.launches` counts the kernel's launches, so a run can show that
its prefill went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import ITEM_8B, refuse_grad
from . import kernel
from .ref import rwkv6_wkv_ref


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor,
              state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [B,T,H,hd] (lw the log decay, < 0); u [H,hd]; state
    [B,H,hd,hd] f32 carried in (None: zeros). Returns (y [B,T,H,hd] in r's
    dtype, final state [B,H,hd,hd] f32). For a CUDA tensor this launches
    the kernel or raises; only a CPU tensor takes the plain version. It
    has no backward: on CUDA it raises NotImplementedError when a gradient
    is asked of it."""
    if r.device.type == "cpu":
        return rwkv6_wkv_ref(r, k, v, lw, u, state)
    refuse_grad("rwkv6_wkv", ITEM_8B, r, k, v, lw, u, state)
    out = kernel.rwkv6_wkv(r, k, v, lw, u, state)
    rwkv6_wkv.launches += 1
    return out


rwkv6_wkv.launches = 0
