"""Plain PyTorch version of the Mamba2 SSD scan kernel: the stepwise
recurrence, in the reference kernel's argument layout, with the state
carried in and out. The CPU path of `ops.ssm_scan`, and what the CUDA
kernel is checked against on the card."""
from __future__ import annotations

import torch


def ssm_scan_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,T,nh,hp]; Bm, Cm [B,T,N]; dt [B,T,nh]; A, D [nh]; state
    [B,nh,hp,N] (None: zeros). Per step, in f32:
        S <- exp(dt_t A) S + dt_t x_t B_t^T,   y_t = S C_t + D x_t
    Returns (y [B,T,nh,hp] in x's dtype, final state [B,nh,hp,N] f32)."""
    B, T, nh, hp = x.shape
    N = Bm.shape[-1]
    xf, Bf, Cf, dtf = x.float(), Bm.float(), Cm.float(), dt.float()
    Af, Df = A.float(), D.float()
    S = (torch.zeros((B, nh, hp, N), dtype=torch.float32, device=x.device)
         if state is None else state.float().clone())
    ys = []
    for t in range(T):
        a = torch.exp(dtf[:, t] * Af)                          # [B, nh]
        S = (S * a[..., None, None] + dtf[:, t, :, None, None]
             * xf[:, t][..., None] * Bf[:, t][:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cf[:, t]))
    y = torch.stack(ys, dim=1) + Df[None, None, :, None] * xf
    return y.to(x.dtype), S
