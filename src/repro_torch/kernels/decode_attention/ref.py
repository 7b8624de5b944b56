"""Plain PyTorch version of the flash-decode kernel, in the reference
kernel's argument layout. The CPU path of `ops.decode_attention`, and what
the CUDA kernel is checked against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, pos: int) -> torch.Tensor:
    """q [B,KV,G,hd] (one token, GQA-packed); k, v [B,KV,S,hd]; k_pos [S]
    slot -> absolute position; pos the current position. Slot s counts
    when k_pos[s] <= pos. Returns [B,KV,G,hd] in q's dtype."""
    s = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    s = s.masked_fill(~(k_pos <= pos)[None, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    return o.to(q.dtype)
