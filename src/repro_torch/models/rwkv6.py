"""RWKV6 ("Finch") token mixer with data-dependent decay, on torch tensors.

Per head (hd = 64): state S [hd, hd],
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with per-channel decay w_t = exp(-exp(w0 + LoRA(x_t))) and token-shift
interpolation on every projection input, as the reference.

A prompt runs the chunked closed form (chunks of CHUNK steps, the last one
may be short): through the Hopper WKV kernel (`kernels.rwkv6_wkv`) by
default, or through `_wkv_chunked`, the plain twin of the reference's
`chunk_step`, when `use_kernels=False`. Decode is the O(1) step. On
DTensors the recurrence runs on each rank's heads through `local_map`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..kernels.rwkv6_wkv.ops import rwkv6_wkv
from .config import ModelConfig
from .layers import _ContiguousGrad, _local_map, batch_placements

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


def _wkv_heads(r, k, v, g, lw, u, S0, use_kernels: bool):
    """The recurrence, the per-head group norm and the gate over the heads
    these tensors hold (all of them, or one rank's shard): r, k, v, g, lw
    [B,T,h*64] from the projections, u [h,64], S0 [B,h,64,64] or None.
    Returns (gated y [B,T,h*64] in g's dtype, final state f32)."""
    B, T, dl = r.shape
    H, hd = dl // HEAD_DIM, HEAD_DIM
    r, k, v = (t.reshape(B, T, H, hd).float() for t in (r, k, v))
    logw = -torch.exp(lw).reshape(B, T, H, hd)                     # < 0
    u = u.float()
    S0 = None if S0 is None else S0.float().contiguous()

    if T > 1 and use_kernels:
        y, S_out = rwkv6_wkv(r, k, v, logw, u, S0)
    else:
        if S0 is None:
            S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=r.device)
        if T == 1:
            kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]   # [B,H,hd,hd]
            y = torch.einsum("bhk,bhkv->bhv", r[:, 0],
                             S0 + u[..., None] * kv)[:, None]
            S_out = torch.exp(logw[:, 0])[..., None] * S0 + kv
        else:
            y, S_out = _wkv_chunked(r, k, v, logw, u, S0)

    # Per-head group norm, then the gate.
    yn = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return yn.reshape(B, T, dl).to(g.dtype) * g, S_out


def _sharded_wkv_heads(x, r, k, v, g, lw, u, S0, use_kernels: bool):
    """`_wkv_heads` on DTensors, rank by rank through `local_map`: the
    batch over the axes that split x's, the heads over "model" where they
    divide it (r, k, v, g, lw on their last dim, u sliced to the local
    heads, the state on H), replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = g.device_mesh
    H = g.shape[-1] // HEAD_DIM
    act, hs, st = [], [], []            # [B,T,d], u [H,64], S [B,H,64,64]
    for i, name in enumerate(mesh.mesh_dim_names):
        if x.placements[i].is_shard(0):
            pl = (Shard(0), Replicate(), Shard(0))
        elif name == "model" and H % mesh.size(i) == 0:
            pl = (Shard(2), Shard(0), Shard(1))
        else:
            pl = (Replicate(),) * 3
        for out, p in zip((act, hs, st), pl):
            out.append(p)

    def fn(r, k, v, g, lw, u, S0):
        r, k, v, g, lw = (_ContiguousGrad.apply(t) for t in (r, k, v, g, lw))
        y, S = _wkv_heads(r, k, v, g, lw, u, S0, use_kernels)
        return y.contiguous(), S
    return _local_map(fn, (act, st),
                      (act, act, act, act, act, hs,
                       None if S0 is None else st), mesh,
                      [p.is_shard() for p in act])(
        r, k, v, g, lw, u, S0)


def rwkv6_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict | None, use_kernels: bool = True):
    """x [B,T,d] -> (out [B,T,d], dict(state [B,H,hd,hd] f32, xprev [B,d]
    f32)). `cache` holds the previous call's state and last input. On
    DTensors (`parallel.sharding.distribute_params`) the projections are
    DTensor products (r, k, v, g column-parallel, wo row-parallel) and the
    recurrence runs on each rank's heads (`_sharded_wkv_heads`)."""
    xprev = None if cache is None else cache["xprev"]
    if xprev is not None and is_dtensor(x):
        xprev = xprev.redistribute(x.device_mesh, batch_placements(x))
    xs = _shift(x, xprev)
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x * mu[i] + xs * (1 - mu[i])

    r = mix(0) @ p["wr"]
    k = mix(1) @ p["wk"]
    v = mix(2) @ p["wv"]
    g = F.silu(mix(3) @ p["wg"])
    lw = (p["w0"].float()
          + (mix(4).float() @ p["wA"].float()) @ p["wB"].float())  # [B,T,d]
    S0 = None if cache is None else cache["state"]
    if is_dtensor(x):
        y, S_out = _sharded_wkv_heads(x, r, k, v, g, lw, p["u"], S0,
                                      use_kernels)
    else:
        y, S_out = _wkv_heads(r, k, v, g, lw, p["u"], S0, use_kernels)
    return y @ p["wo"], dict(state=S_out, xprev=x[:, -1].float())


def rwkv6_cache_init(cfg: ModelConfig, B: int,
                     device: torch.device | str) -> dict:
    d = cfg.d_model
    return dict(state=torch.zeros((B, d // HEAD_DIM, HEAD_DIM, HEAD_DIM),
                                  dtype=torch.float32, device=device),
                xprev=torch.zeros((B, d), dtype=torch.float32, device=device))
