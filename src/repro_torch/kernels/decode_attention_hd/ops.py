"""Public ops of the head_dim-split decode: the Hopper kernels for CUDA
tensors, the plain versions for CPU tensors.

`decode_scores_hd.launches` and `decode_softmax_pv_hd.launches` count the
kernels' launches, so a run can show that its decode went through them.
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from . import kernel
from .ref import decode_scores_hd_ref, decode_softmax_pv_hd_ref

_NO_GRAD = ("decoding is not trained (no training path decodes, and the "
            "reference's Pallas kernel has no VJP either)")


def decode_scores_hd(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,KV,G,hl]; k [B,KV,S,hl] (pass the model's [B,S,KV,hl] cache
    shard as a `.transpose(1, 2)` view). Returns [B,KV,G,S] f32, the
    unscaled dot products over these hl lanes of head_dim, for the caller
    to sum over the slices. For a CUDA tensor this launches the kernel or
    raises; only a CPU tensor takes the plain version. No backward: on
    CUDA it raises NotImplementedError when a gradient is asked of it."""
    if q.device.type == "cpu":
        return decode_scores_hd_ref(q, k)
    refuse_grad("decode_scores_hd", _NO_GRAD, q, k)
    out = kernel.decode_scores_hd(q, k)
    decode_scores_hd.launches += 1
    return out


def decode_softmax_pv_hd(s: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, pos: int,
                         scale: float) -> torch.Tensor:
    """s [B,KV,G,S] f32, the scores summed over every slice; v [B,KV,S,hl]
    this slice's lanes (a `.transpose(1, 2)` view of the cache shard);
    k_pos [S] int32; pos the current position; scale the whole head's
    1 / sqrt(hd), never the slice's. Returns [B,KV,G,hl] in v's dtype,
    zeros for a group with no admissible slot. CUDA tensors launch the
    kernel or raise; CPU tensors take the plain version."""
    if s.device.type == "cpu":
        return decode_softmax_pv_hd_ref(s, v, k_pos, pos, scale)
    refuse_grad("decode_softmax_pv_hd", _NO_GRAD, s, v)
    out = kernel.decode_softmax_pv_hd(s, v, k_pos, pos, scale)
    decode_softmax_pv_hd.launches += 1
    return out


decode_scores_hd.launches = 0
decode_softmax_pv_hd.launches = 0
