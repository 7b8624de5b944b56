"""Plain PyTorch version of the flash-attention backward kernel: the
explicit formulas in f32, not autograd. What the CUDA kernel is checked
against on the card, and the CPU path of `ops.flash_attention_bwd`."""
from __future__ import annotations

import torch

from ..flash_attention.ref import masked_logits


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            q_pos: torch.Tensor, k_pos: torch.Tensor,
                            window: int = 0):
    """q, o, do [B,H,Tq,hd]; k, v [B,KV,Tk,hd]; lse [B,H,Tq] (natural log,
    +inf for a row with no admissible key); positions [Tq], [Tk]. With s
    the scaled logits, P = exp(s - lse) on admissible pairs (0 elsewhere),
    a row with no admissible key taking P = 1/Tk on every key (the uniform
    average the forward gave it), and D = rowsum(dO * O):
        dV = P^T dO, dP = dO V^T, dS = P (dP - D) (0 on masked pairs and
        on rows with no admissible key, whose logits are constants),
        dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd),
    dK and dV summed over each KV head's G query heads. Returns (dq, dk,
    dv) in the inputs' dtypes."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = H // KV
    s, mask = masked_logits(q, k, q_pos, k_pos, window)   # [B,KV,G,Tq,Tk]
    lse5 = lse.float().reshape(B, KV, G, Tq, 1)
    lost = torch.isinf(lse5)
    p = torch.where(mask, torch.exp(s - torch.where(lost, 0.0, lse5)), 0.0)
    p = torch.where(lost, 1.0 / Tk, p)
    dof = do.float().reshape(B, KV, G, Tq, hd)
    D = (dof * o.float().reshape(B, KV, G, Tq, hd)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dof)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dof, v.float())
    ds = torch.where(mask & ~lost, p * (dp - D), 0.0)
    scale = hd ** -0.5
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds,
                      q.float().reshape(B, KV, G, Tq, hd)) * scale
    return (dq.reshape(B, H, Tq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
