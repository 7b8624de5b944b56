"""Plain PyTorch version of the flash-attention kernel, in the reference
kernel's argument layout, and of the log-sum-exp its forward writes for
training. The CPU path of `ops.flash_attention`, and what the CUDA kernel
is checked against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    """q [B,H,Tq,hd], k/v [B,KV,Tk,hd] (GQA: head h reads KV head h // G);
    q_pos [Tq], k_pos [Tk]. Returns [B,H,Tq,hd] in q's dtype."""
    B, H, Tq, hd = q.shape
    s, _ = masked_logits(q, k, q_pos, k_pos, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, Tq, hd).to(q.dtype)


def masked_logits(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, window: int = 0):
    """The scaled logits [B,KV,G,Tq,Tk] in f32 with masked pairs at -1e30,
    and the admissibility mask [Tq, Tk] (causal, optionally windowed)."""
    B, H, Tq, hd = q.shape
    KV = k.shape[1]
    qf = q.float().reshape(B, KV, H // KV, Tq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float()) * (hd ** -0.5)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return s.masked_fill(~mask, NEG_INF), mask


def lse_ref(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
            k_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """[B,H,Tq] f32: each row's logsumexp of its scaled logits over the
    admissible keys (natural log), +inf for a row with none: the kernels'
    mark for a row that took the uniform average."""
    B, H, Tq, _ = q.shape
    s, mask = masked_logits(q, k, q_pos, k_pos, window)
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Tq)
    return lse.masked_fill(~mask.any(dim=-1), float("inf"))
