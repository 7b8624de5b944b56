"""Mamba2 (SSD) token mixer, on torch tensors.

State-space update per head h with scalar decay a_t = exp(dt_t * A_h):
    S_t = a_t * S_{t-1} + dt_t * (x_t ⊗ B_t)        S: [hp, N]
    y_t = S_t @ C_t + D_h * x_t
as the reference. A prompt runs the chunked SSD closed form: through the
Hopper scan kernel (`kernels.ssm_scan`, which adds D x itself) by default,
or through `_ssd_chunked`, the plain twin of the reference's `chunk_step`
over chunks of CHUNK steps (the last may be short), when
`use_kernels=False`. Decode is the O(1) step. On DTensors the conv and
the scan run on each rank's heads through `local_map`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..kernels.ssm_scan.ops import ssm_scan
from .config import ModelConfig
from .layers import _ContiguousGrad, _local_map

CHUNK = 128
# log(expm1(0.01)) taken in f32, as the reference does, so dt starts at 0.01.
DT_BIAS = torch.log(torch.expm1(torch.tensor(0.01))).item()


def mamba2_params(normal, full, cfg: ModelConfig, stacked: int) -> dict:
    """The reference's tree, `stacked` layers on axis 0. `normal(shape,
    fan_in)` draws the random weights, `full(value, shape)` makes the f32
    constants, which are the reference's: dt_bias = DT_BIAS,
    A_log = 0, D = 1."""
    d, di, N, nh, n = (cfg.d_model, cfg.di, cfg.ssm_state, cfg.ssm_heads,
                       stacked)
    return dict(
        wx=normal((n, d, di), d), wz=normal((n, d, di), d),
        wB=normal((n, d, N), d), wC=normal((n, d, N), d),
        wdt=normal((n, d, nh), d),
        dt_bias=full(DT_BIAS, (n, nh)),
        A_log=full(0.0, (n, nh)),
        D=full(1.0, (n, nh)),
        conv=normal((n, cfg.conv_width, di), cfg.conv_width),
        wo=normal((n, di, d), di))


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 conv_state: torch.Tensor | None):
    """Depthwise causal conv. x [B,T,di]; kernel [W,di]; conv_state
    [B,W-1,di], the previous call's trailing inputs. Returns (silu(out),
    the new trailing inputs)."""
    W = kernel.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # [B, T+W-1, di]
    T = x.shape[1]
    out = xp[:, 0:T] * kernel[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * kernel[i]
    return F.silu(out), xp[:, -(W - 1):]


def _ssd_chunked(la, x, Bm, Cm, dt, S):
    """The reference's `chunk_step` over chunks of CHUNK steps (the last
    may be short: the closed form is exact for any chunk length). All f32;
    la = dt A [B,T,nh], x [B,T,nh,hp], Bm, Cm [B,T,N], dt [B,T,nh], S
    [B,nh,hp,N]. Returns (y without D x, S)."""
    ys = []
    for c0 in range(0, x.shape[1], CHUNK):
        lac, xc, Bc, Cc, dtc = (a[:, c0:c0 + CHUNK]
                                for a in (la, x, Bm, Cm, dt))
        Q = xc.shape[1]
        cum = torch.cumsum(lac, dim=1)                   # [B, Q, nh]
        rel = cum[:, :, None, :] - cum[:, None, :, :]    # [B, Q, Q, nh]
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                       device=x.device))
        decay = torch.where(causal[None, :, :, None], torch.exp(rel), 0.0)
        cb = torch.einsum("bqn,bsn->bqs", Cc, Bc)        # [B, Q, Q]
        M = decay * cb[..., None] * dtc[:, None, :, :]   # [B, Q, Q, nh]
        y = torch.einsum("bqsh,bshp->bqhp", M, xc)
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", Cc, S, torch.exp(cum))
        tail = torch.exp(cum[:, -1:, :] - cum)           # [B, Q, nh]
        S = (S * torch.exp(cum[:, -1])[..., None, None]
             + torch.einsum("bsh,bshp,bsn->bhpn", tail * dtc, xc, Bc))
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _ssd_heads(cfg: ModelConfig, z, xr, conv, conv_state, Bm, Cm, dt_raw,
               dt_bias, A_log, D, S0, use_kernels: bool):
    """The causal conv, the scan and the gate over the heads these tensors
    hold (all of them, or one rank's shard): z, xr [B,T,h*hp] (z after its
    silu), conv [W,h*hp], conv_state [B,W-1,h*hp] or None, Bm, Cm [B,T,N]
    f32 (every head reads all of N), dt_raw [B,T,h] f32 before its bias,
    dt_bias, A_log, D [h], S0 [B,h,hp,N] or None. Returns (gated y
    [B,T,h*hp] in z's dtype, final state f32, the conv's trailing
    inputs)."""
    B, T, dil = xr.shape
    hp = cfg.ssm_head_dim
    nh = dil // hp
    xin, conv_state = _causal_conv(xr, conv, conv_state)
    dt = F.softplus(dt_raw + dt_bias)                    # [B, T, nh]
    A = -torch.exp(A_log.float())                        # [nh]
    D = D.float()
    xh = xin.reshape(B, T, nh, hp).float()
    S0 = None if S0 is None else S0.float().contiguous()

    if T > 1 and use_kernels:
        y, S_out = ssm_scan(xh, Bm, Cm, dt, A, D, S0)   # adds D x itself
    else:
        if S0 is None:
            S0 = torch.zeros((B, nh, hp, cfg.ssm_state), dtype=torch.float32,
                             device=xr.device)
        if T == 1:
            a = torch.exp(dt[:, 0] * A)                  # [B, nh]
            S_out = (S0 * a[..., None, None]
                     + dt[:, 0, :, None, None] * xh[:, 0][..., None]
                     * Bm[:, 0][:, None, None, :])
            y = torch.einsum("bhpn,bn->bhp", S_out, Cm[:, 0])[:, None]
        else:
            y, S_out = _ssd_chunked(dt * A, xh, Bm, Cm, dt, S0)
        y = y + D[:, None] * xh
    return y.reshape(B, T, dil).to(z.dtype) * z, S_out, conv_state


def _sharded_ssd_heads(x, cfg: ModelConfig, *args, use_kernels: bool):
    """`_ssd_heads` on DTensors, rank by rank through `local_map`: the
    batch over the axes that split x's, the SSM heads over "model" where
    they divide it (z, xr, dt and the conv on their last dim, the state on
    nh, dt_bias, A_log and D sliced to the local heads), Bm and Cm
    replicated, since every head's scan needs all of N."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    act, vec, conv, st, rep = [], [], [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        if x.placements[i].is_shard(0):
            pl = (Shard(0), Replicate(), Replicate(), Shard(0), Shard(0))
        elif name == "model" and cfg.ssm_heads % mesh.size(i) == 0:
            pl = (Shard(2), Shard(0), Shard(1), Shard(1), Replicate())
        else:
            pl = (Replicate(),) * 5
        for out, p in zip((act, vec, conv, st, rep), pl):
            out.append(p)
    z, xr, cw, cs, Bm, Cm, dt_raw, dt_bias, A_log, D, S0 = args

    def fn(z, xr, cw, cs, Bm, Cm, dt_raw, dt_bias, A_log, D, S0):
        z, xr, cw, Bm, Cm, dt_raw = (_ContiguousGrad.apply(t)
                                     for t in (z, xr, cw, Bm, Cm, dt_raw))
        y, S, c = _ssd_heads(cfg, z, xr, cw, cs, Bm, Cm, dt_raw, dt_bias,
                             A_log, D, S0, use_kernels)
        return y.contiguous(), S, c.contiguous()
    return _local_map(fn, (act, st, act),
                      (act, act, conv, None if cs is None else act, rep, rep,
                       act, vec, vec, vec, None if S0 is None else st),
                      mesh, [p.is_shard() for p in act])(*args)


def mamba2_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: dict | None, use_kernels: bool = True):
    """x [B,T,d] -> (out [B,T,d], dict(ssm [B,nh,hp,N] f32, conv
    [B,W-1,di])). `cache` holds the previous call's states. On DTensors
    (`parallel.sharding.distribute_params`) the projections are DTensor
    products (wx, wz, wdt column-parallel, wo row-parallel) and the conv
    and the scan run on each rank's heads (`_sharded_ssd_heads`)."""
    args = (F.silu(x @ p["wz"]), x @ p["wx"], p["conv"],
            None if cache is None else cache["conv"],
            (x @ p["wB"]).float(), (x @ p["wC"]).float(),   # [B, T, N]
            (x @ p["wdt"]).float(), p["dt_bias"], p["A_log"], p["D"],
            None if cache is None else cache["ssm"])
    if is_dtensor(x):
        y, S_out, conv_state = _sharded_ssd_heads(x, cfg, *args,
                                                  use_kernels=use_kernels)
    else:
        y, S_out, conv_state = _ssd_heads(cfg, *args, use_kernels)
    return y @ p["wo"], dict(ssm=S_out, conv=conv_state)


def mamba2_cache_init(cfg: ModelConfig, B: int, dtype: torch.dtype,
                      device: torch.device | str) -> dict:
    return dict(
        ssm=torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((B, cfg.conv_width - 1, cfg.di), dtype=dtype,
                         device=device))
