"""Plain PyTorch version of the RWKV6 WKV kernel: the stepwise recurrence,
in the reference kernel's argument layout, with the state carried in and
out. The CPU path of `ops.rwkv6_wkv`, and what the CUDA kernel is checked
against on the card."""
from __future__ import annotations

import torch


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [B,T,H,hd] (lw the log decay, < 0); u [H,hd]; state
    [B,H,hd,hd] (None: zeros). Per step, in f32:
        y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(exp(lw_t)) S + k_t v_t^T
    Returns (y [B,T,H,hd] in r's dtype, final state [B,H,hd,hd] f32)."""
    B, T, H, hd = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw.float())
    uf = u.float()[None, :, :, None]
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float().clone())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S
