"""Public flash-decode op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

`decode_attention.launches` counts the kernel's launches, so a run can show
that its decode went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from . import kernel
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor | None = None,
                     pos: int | None = None, return_lse: bool = False):
    """q [B,KV,G,hd]; k, v [B,KV,S,hd]; k_pos [S] int32 slot -> position
    (default 0..S-1); pos the current position (default S-1). Any
    strides: pass the model's [B,S,KV,hd] cache as a `.transpose(1, 2)`
    view. Returns [B,KV,G,hd] in q's dtype, zeros for a group with no
    admissible slot; with `return_lse`, (that, lse [B,KV,G] f32), the
    log-sum-exp of the group's scaled scores, -inf where it has none.
    For a CUDA tensor this launches the kernel or raises; only a
    CPU tensor takes the plain version. It has no backward: on CUDA
    it raises NotImplementedError when a gradient is asked of it."""
    S = k.shape[2]
    if k_pos is None:
        k_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    if pos is None:
        pos = S - 1
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, k_pos, pos, return_lse)
    refuse_grad("decode_attention", "decoding is not trained (no training "
                "path decodes, and the reference's Pallas kernel has no "
                "VJP either)", q, k, v)
    out = kernel.decode_attention(q, k, v, k_pos, pos,
                                  return_lse=return_lse)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
