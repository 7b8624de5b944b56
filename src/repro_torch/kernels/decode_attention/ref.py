"""Plain PyTorch version of the flash-decode kernel, in the reference
kernel's argument layout. The CPU path of `ops.decode_attention`, and what
the CUDA kernel is checked against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, pos: int,
                         return_lse: bool = False):
    """q [B,KV,G,hd] (one token, GQA-packed); k, v [B,KV,S,hd]; k_pos [S]
    slot -> absolute position; pos the current position. Slot s counts
    when k_pos[s] <= pos. Returns [B,KV,G,hd] in q's dtype; with
    `return_lse`, (that, lse [B,KV,G] f32), the natural log of the sum of
    exp(scaled score) over the counted slots.

    Where no slot counts, the output is zeros and lse is -inf, as the
    kernel writes them (the softmax of the -1e30 fill alone would give
    the mean of v): a cache split on its slots over ranks leaves such
    ranks, whose parts then weigh nothing in the merge."""
    s = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    mask = k_pos <= pos
    s = s.masked_fill(~mask[None, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    any_slot = mask.any()
    o = torch.where(any_slot, o, 0.0).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(any_slot, torch.logsumexp(s, dim=-1), -torch.inf)
    return o, lse
