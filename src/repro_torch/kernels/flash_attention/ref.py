"""Plain PyTorch version of the flash-attention kernel, in the reference
kernel's argument layout. The CPU path of `ops.flash_attention`, and what
the CUDA kernel is checked against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    """q [B,H,Tq,hd], k/v [B,KV,Tk,hd] (GQA: head h reads KV head h // G);
    q_pos [Tq], k_pos [Tk]. Returns [B,H,Tq,hd] in q's dtype."""
    B, H, Tq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Tq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float()) * (hd ** -0.5)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, Tq, hd).to(q.dtype)
