"""Plain PyTorch version of the RWKV6 WKV backward: the explicit formulas
of the stepwise recurrence in f32, not autograd. What the CUDA kernel is
checked against on the card, and the CPU path of `ops.rwkv6_wkv_bwd`."""
from __future__ import annotations

import torch


def rwkv6_wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lw: torch.Tensor, u: torch.Tensor,
                      state: torch.Tensor | None, dy: torch.Tensor | None,
                      dstate: torch.Tensor | None = None):
    """Gradients of `rwkv6_wkv(r, k, v, lw, u, state)` given dy, the
    gradient of y, and dstate, that of the final state (either None:
    zeros). With w_t = exp(lw_t), y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
    and S_t = diag(w_t) S_{t-1} + k_t v_t^T, the gradient G_t of S_t runs
    backward (G_{T-1} = dstate):
        K_t = G_t + diag(u r_t) 1 dy_t^T   (the gradient of k_t v_t^T),
        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t),
        dk_t = K_t v_t,   dv_t = K_t^T k_t,
        du = sum_{b,t} r_t k_t (v_t . dy_t),
        dlw_t = w_t rowsum(G_t * S_{t-1}),
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate_in = G_{-1}.
    It keeps every S_t: T times the state's bytes. Returns (dr, dk, dv,
    dlw, du, dstate_in), each in its input's dtype (dstate_in f32). The
    math is f32 (f64 for f64 inputs)."""
    wt = torch.float64 if r.dtype == torch.float64 else torch.float32
    B, T, H, hd = r.shape
    rf, kf, vf, lwf = r.to(wt), k.to(wt), v.to(wt), lw.to(wt)
    uf = u.to(wt)
    w = torch.exp(lwf)
    S = (torch.zeros((B, H, hd, hd), dtype=wt, device=r.device)
         if state is None else state.to(wt))
    dyf = torch.zeros_like(rf) if dy is None else dy.to(wt)
    states = [S]                                      # S_{t-1} at index t
    for t in range(T):
        S = (w[:, t, :, :, None] * S
             + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        states.append(S)
    G = torch.zeros_like(S) if dstate is None else dstate.to(wt).clone()
    dr, dk, dv, dlw = (torch.empty_like(t) for t in (rf, kf, vf, lwf))
    du = torch.zeros_like(uf)
    for t in reversed(range(T)):
        S_prev = states[t]
        vdy = (vf[:, t] * dyf[:, t]).sum(-1, keepdim=True)   # [B, H, 1]
        dr[:, t] = (torch.einsum("bhkv,bhv->bhk", S_prev, dyf[:, t])
                    + uf * kf[:, t] * vdy)
        K = G + (uf * rf[:, t])[..., None] * dyf[:, t][:, :, None, :]
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", K, vf[:, t])
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", K, kf[:, t])
        du += (rf[:, t] * kf[:, t] * vdy).sum(0)
        dlw[:, t] = w[:, t] * (G * S_prev).sum(-1)
        G = (w[:, t, :, :, None] * G
             + rf[:, t, :, :, None] * dyf[:, t][:, :, None, :])
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw.to(lw.dtype),
            du.to(u.dtype), G)
