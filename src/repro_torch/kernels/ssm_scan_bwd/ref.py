"""Plain PyTorch version of the Mamba2 SSD scan's backward: the explicit
formulas of the stepwise recurrence in f32, not autograd. What the CUDA
kernel is checked against on the card, and the CPU path of
`ops.ssm_scan_bwd`."""
from __future__ import annotations

import torch


def ssm_scan_bwd_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                     state: torch.Tensor | None, dy: torch.Tensor | None,
                     dstate: torch.Tensor | None = None):
    """Gradients of `ssm_scan(x, Bm, Cm, dt, A, D, state)` given dy, the
    gradient of y, and dstate, that of the final state (either None:
    zeros). With a_t = exp(dt_t A), S_t = a_t S_{t-1} + dt_t x_t B_t^T and
    y_t = S_t C_t + D x_t, the gradient G_t of S_t runs backward:
        G_t = dy_t C_t^T + a_{t+1} G_{t+1}   (G_{T-1} adds dstate)
        dx_t = dt_t G_t B_t + D dy_t,   dB_t = sum_h dt_t G_t^T x_t,
        dC_t = sum_h S_t^T dy_t,   dla_t = a_t <G_t, S_{t-1}>,
        ddt_t = x_t . G_t B_t + A dla_t,   dA = sum_{b,t} dt_t dla_t,
        dD = sum_{b,t} dy_t . x_t,   dstate_in = a_0 G_0.
    It keeps every S_t: T times the state's bytes. Returns (dx, dBm, dCm,
    ddt, dA, dD, dstate_in), each in its input's dtype (dstate_in f32).
    The math is f32 (f64 for f64 inputs)."""
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    B, T, nh, hp = x.shape
    N = Bm.shape[-1]
    xf, Bf, Cf, dtf = x.to(wt), Bm.to(wt), Cm.to(wt), dt.to(wt)
    Af, Df = A.to(wt), D.to(wt)
    S = (torch.zeros((B, nh, hp, N), dtype=wt, device=x.device)
         if state is None else state.to(wt))
    dyf = torch.zeros_like(xf) if dy is None else dy.to(wt)
    states = [S]                                      # S_{t-1} at index t
    a = torch.exp(dtf * Af)                           # [B, T, nh]
    for t in range(T):
        S = (S * a[:, t, :, None, None] + dtf[:, t, :, None, None]
             * xf[:, t][..., None] * Bf[:, t][:, None, None, :])
        states.append(S)
    G = (torch.zeros_like(S) if dstate is None else dstate.to(wt).clone())
    dx, dB, dC, ddt = (torch.empty_like(t) for t in (xf, Bf, Cf, dtf))
    dA = torch.zeros_like(Af)
    for t in reversed(range(T)):
        G = G + dyf[:, t][..., None] * Cf[:, t][:, None, None, :]
        dC[:, t] = torch.einsum("bhpn,bhp->bn", states[t + 1], dyf[:, t])
        GB = torch.einsum("bhpn,bn->bhp", G, Bf[:, t])
        dx[:, t] = dtf[:, t, :, None] * GB + Df[:, None] * dyf[:, t]
        dB[:, t] = torch.einsum("bh,bhpn,bhp->bn", dtf[:, t], G, xf[:, t])
        dla = a[:, t] * (G * states[t]).sum((-2, -1))        # [B, nh]
        ddt[:, t] = (xf[:, t] * GB).sum(-1) + Af * dla
        dA += (dtf[:, t] * dla).sum(0)
        G = G * a[:, t, :, None, None]
    dD = (dyf * xf).sum((0, 1, 3))
    return (dx.to(x.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
            ddt.to(dt.dtype), dA.to(A.dtype), dD.to(D.dtype), G)
