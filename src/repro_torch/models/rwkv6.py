"""RWKV6 ("Finch") token mixer with data-dependent decay, on torch tensors.

Per head (hd = 64): state S [hd, hd],
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with per-channel decay w_t = exp(-exp(w0 + LoRA(x_t))) and token-shift
interpolation on every projection input, as the reference.

A prompt runs the chunked closed form (chunks of CHUNK steps, the last one
may be short): through the Hopper WKV kernel (`kernels.rwkv6_wkv`) by
default, or through `_wkv_chunked`, the plain twin of the reference's
`chunk_step`, when `use_kernels=False`. Decode is the O(1) step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import refuse_dtensor
from ..kernels.rwkv6_wkv.ops import rwkv6_wkv
from .config import ModelConfig

CHUNK = 64
LORA_R = 64
HEAD_DIM = 64


def rwkv6_params(normal, full, cfg: ModelConfig, stacked: int) -> dict:
    """The reference's tree, `stacked` layers on axis 0. `normal(shape,
    fan_in)` draws the random weights, `full(value, shape)` makes the f32
    constants, which are the reference's: w0 = -6, u = mu = 0.5."""
    d, n = cfg.d_model, stacked
    H = d // HEAD_DIM
    return dict(
        wr=normal((n, d, d), d), wk=normal((n, d, d), d),
        wv=normal((n, d, d), d), wg=normal((n, d, d), d),
        wo=normal((n, d, d), d),
        w0=full(-6.0, (n, d)),
        wA=normal((n, d, LORA_R), d), wB=normal((n, LORA_R, d), LORA_R),
        u=full(0.5, (n, H, HEAD_DIM)),
        mu=full(0.5, (n, 5, d)))


def _shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} sequence; x_prev is the last token of the previous call."""
    first = (torch.zeros_like(x[:, :1]) if x_prev is None
             else x_prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, lw, u, S):
    """The reference's `chunk_step` over chunks of CHUNK steps (the last
    may be short: the closed form is exact for any chunk length). All f32;
    r, k, v, lw [B,T,H,hd], u [H,hd], S [B,H,hd,hd]. Returns (y, S)."""
    ys = []
    for c0 in range(0, r.shape[1], CHUNK):
        rq, kq, vq, lq = (a[:, c0:c0 + CHUNK] for a in (r, k, v, lw))
        Q = rq.shape[1]
        cum = torch.cumsum(lq, dim=1)             # inclusive
        cum_excl = cum - lq
        rel = cum_excl[:, :, None] - cum[:, None, :]        # [B,t,s,H,hd]
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                       device=r.device), diagonal=-1)
        dec = torch.where(causal[None, :, :, None, None], torch.exp(rel),
                          0.0)
        att = torch.einsum("bthk,btshk,bshk->bths", rq, dec, kq)
        y = torch.einsum("bths,bshv->bthv", att, vq)
        bonus = torch.einsum("bthk,hk,bthk->bth", rq, u, kq)
        y = y + bonus[..., None] * vq
        y = y + torch.einsum("bthk,bthk,bhkv->bthv", rq, torch.exp(cum_excl),
                             S)
        tail = torch.exp(cum[:, -1:] - cum)                  # [B,Q,H,hd]
        S = (torch.exp(cum[:, -1])[..., None] * S
             + torch.einsum("bshk,bshv->bhkv", tail * kq, vq))
        ys.append(y)
    return torch.cat(ys, dim=1), S


def rwkv6_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict | None, use_kernels: bool = True):
    """x [B,T,d] -> (out [B,T,d], dict(state [B,H,hd,hd] f32, xprev [B,d]
    f32)). `cache` holds the previous call's state and last input."""
    refuse_dtensor("the RWKV6 token mixer", x)
    B, T, d = x.shape
    H, hd = d // HEAD_DIM, HEAD_DIM
    xs = _shift(x, None if cache is None else cache["xprev"])
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x * mu[i] + xs * (1 - mu[i])

    r = (mix(0) @ p["wr"]).reshape(B, T, H, hd).float()
    k = (mix(1) @ p["wk"]).reshape(B, T, H, hd).float()
    v = (mix(2) @ p["wv"]).reshape(B, T, H, hd).float()
    g = F.silu(mix(3) @ p["wg"])
    lw = (p["w0"].float()
          + (mix(4).float() @ p["wA"].float()) @ p["wB"].float())  # [B,T,d]
    logw = -torch.exp(lw).reshape(B, T, H, hd)                     # < 0
    u = p["u"].float()
    S0 = None if cache is None else cache["state"].float().contiguous()

    if T > 1 and use_kernels:
        y, S_out = rwkv6_wkv(r, k, v, logw, u, S0)
    else:
        if S0 is None:
            S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=x.device)
        if T == 1:
            kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]   # [B,H,hd,hd]
            y = torch.einsum("bhk,bhkv->bhv", r[:, 0],
                             S0 + u[..., None] * kv)[:, None]
            S_out = torch.exp(logw[:, 0])[..., None] * S0 + kv
        else:
            y, S_out = _wkv_chunked(r, k, v, logw, u, S0)

    # Per-head group norm, then gate and output projection.
    yn = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    out = (yn.reshape(B, T, d).to(x.dtype) * g) @ p["wo"]
    return out, dict(state=S_out, xprev=x[:, -1].float())


def rwkv6_cache_init(cfg: ModelConfig, B: int,
                     device: torch.device | str) -> dict:
    d = cfg.d_model
    return dict(state=torch.zeros((B, d // HEAD_DIM, HEAD_DIM, HEAD_DIM),
                                  dtype=torch.float32, device=device),
                xprev=torch.zeros((B, d), dtype=torch.float32, device=device))
