"""Neural-network primitives of the dense GQA decoder, on torch tensors.

Attention has two paths with the same math:
  * the Hopper kernels (`kernels.flash_attention` for prefill,
    `kernels.decode_attention` for decode), which `attention_apply` calls
    by default: they launch on CUDA tensors and fall to their plain
    versions only on CPU tensors;
  * `attention`, the plain chunked online-softmax version that the
    reference model runs, taken when `use_kernels=False`.
Under autograd on CUDA the prefill kernel's op runs its backward kernel
too (`kernels.flash_attention`'s autograd Function). `chunked_ce_loss` is
the training loss over sequence chunks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig

NEG_INF = -1e30
EMPTY_SLOT = 2 ** 30    # position of a cache slot never written


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: [..., T] (broadcastable)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs              # [..., T, hd/2]
    ang = ang[..., None, :]                                 # [..., T, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain chunked online softmax; the kernels' twin)
# ---------------------------------------------------------------------------

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: int) -> torch.Tensor:
    """[Tq, Tk] boolean mask: causal, optionally sliding-window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
              block_q: int = 256, block_k: int = 1024) -> torch.Tensor:
    """Grouped-query attention with streaming (online-softmax) blocking.
    q: [B, Tq, H, hd]; k, v: [B, Tk, KV, hd]; positions: [Tq], [Tk].
    Peak memory is O(B * H * block_q * block_k). The last query chunk and
    the last key block may be short, so any Tq and Tk are taken."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Tq, KV, G, hd)
    outs = []
    for q0 in range(0, Tq, block_q):
        qc = qg[:, q0:q0 + block_q].float()          # [B, c, KV, G, hd]
        qp = q_pos[q0:q0 + block_q]
        c = qc.shape[1]
        m_run = q.new_full((B, KV, G, c), NEG_INF, dtype=torch.float32)
        l_run = q.new_zeros((B, KV, G, c), dtype=torch.float32)
        o_run = q.new_zeros((B, KV, G, c, hd), dtype=torch.float32)
        for k0 in range(0, Tk, block_k):
            kb = k[:, k0:k0 + block_k].float()
            vb = v[:, k0:k0 + block_k].float()
            logits = torch.einsum("bqkgh,bskh->bkgqs", qc, kb) * scale
            msk = _mask(qp, k_pos[k0:k0 + block_k], window)
            logits = logits.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            o_run = (o_run * alpha[..., None]
                     + torch.einsum("bkgqs,bskh->bkgqh", p, vb))
            m_run = m_new
        out = o_run / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Tq, H, hd)


def _prefill_attention(q, k, v, q_pos, k_pos, window: int,
                       use_kernels: bool) -> torch.Tensor:
    """[B,T,H,hd] x [B,Tk,KV,hd] -> [B,T,H,hd]. The kernel reads the
    model's tensors as [B,H,T,hd] views and writes its output in the
    model's layout, so neither side is copied."""
    if not use_kernels:
        return attention(q, k, v, q_pos, k_pos, window=window)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), q_pos.to(torch.int32),
                          k_pos.to(torch.int32), window=window)
    return out.transpose(1, 2)


def decode_key_positions(S: int, pos0: int, window: int,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """[S] int32: the absolute position each cache slot holds once position
    `pos0` is written, EMPTY_SLOT for a slot never written. With a window,
    slots that fell out of it are marked empty too, because the decode
    kernel masks only k_pos > pos. The map is the same for every layer of
    a decode step."""
    slots = torch.arange(S, dtype=torch.int32, device=device)
    if window > 0 and S == window:
        # Absolute position stored in ring slot s: the largest
        # p <= pos0 with p % S == s; negative -> never written.
        k_pos = pos0 - ((pos0 - slots) % S)
        k_pos = torch.where(k_pos < 0, EMPTY_SLOT, k_pos)
    else:
        k_pos = torch.where(slots <= pos0, slots, EMPTY_SLOT)
    if window > 0:
        k_pos = torch.where(k_pos > pos0 - window, k_pos, EMPTY_SLOT)
    return k_pos


def _decode_attention(q, kc, vc, pos: int, k_pos, window: int,
                      use_kernels: bool) -> torch.Tensor:
    """One query position `pos` against the cache. q [B,1,H,hd]; kc, vc
    [B,S,KV,hd]; k_pos [S] int32 from `decode_key_positions`."""
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    if not use_kernels:
        q_pos = torch.full((1,), pos, dtype=k_pos.dtype, device=q.device)
        return attention(q, kc, vc, q_pos, k_pos, window=window)
    out = decode_attention(q.reshape(B, KV, H // KV, hd), kc.transpose(1, 2),
                           vc.transpose(1, 2), k_pos, pos)
    return out.reshape(B, 1, H, hd)


def attention_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    cache_kv: tuple[torch.Tensor, torch.Tensor] | None,
                    pos0: int, window: int | None = None,
                    use_kernels: bool = True,
                    k_pos: torch.Tensor | None = None):
    """Apply one attention block.
    x: [B, T, d].  cache_kv: (k_cache, v_cache) each [B, S, KV, hd] holding
    positions [0, pos0); the block writes the new T keys/values into it IN
    PLACE (the reference returns new arrays) and returns the same tensors.
    k_pos: for a decode step, `decode_key_positions(S, pos0, window)`,
    built here when not given.
    Returns (out [B, T, d], cache_kv); with no cache, the fresh (k, v).
    """
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if window is None:
        window = cfg.sliding_window
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    q_pos = pos0 + torch.arange(T, device=x.device)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    if cache_kv is None:
        out = _prefill_attention(q, k, v, q_pos, q_pos, window, use_kernels)
        new_cache = (k, v)
    elif T > 1:
        # Prefill (pos0 == 0 by convention): attend over the fresh K/V with
        # the causal(+window) mask, then write them into the cache.
        out = _prefill_attention(q, k, v, q_pos, q_pos, window, use_kernels)
        kc, vc = cache_kv
        S = kc.shape[1]
        if window > 0 and S == window:
            # Ring buffer: keep only the last S keys (slots are unique).
            keep = min(T, S)
            slot = q_pos[-keep:] % S
            kc[:, slot] = k[:, -keep:]
            vc[:, slot] = v[:, -keep:]
        else:
            _write(kc, vc, k, v, pos0)
        new_cache = (kc, vc)
    else:
        # Decode: append one position, attend against the cache.
        kc, vc = cache_kv
        S = kc.shape[1]
        if window > 0 and S == window:
            slot = pos0 % S
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
        else:
            _write(kc, vc, k, v, pos0)
        if k_pos is None:
            k_pos = decode_key_positions(S, pos0, window, x.device)
        out = _decode_attention(q, kc, vc, pos0, k_pos, window, use_kernels)
        new_cache = (kc, vc)
    out = out.reshape(B, T, H * hd) @ p["wo"]
    return out, new_cache


def _write(kc, vc, k, v, pos0: int) -> None:
    """Write k, v [B,T,KV,hd] into the caches at positions pos0.. in place."""
    T, S = k.shape[1], kc.shape[1]
    if pos0 + T > S:
        raise ValueError(f"cache of {S} positions cannot take positions "
                         f"{pos0}..{pos0 + T - 1}")
    kc[:, pos0:pos0 + T] = k
    vc[:, pos0:pos0 + T] = v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes [B, S, V] logits)
# ---------------------------------------------------------------------------

def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target."""
    for c in range(min(S, target), 0, -1):
        if S % c == 0:
            return c
    return S


def _chunk_nll(head: torch.Tensor, xc: torch.Tensor,
               tc: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one chunk: the product rounded in the model's dtype,
    then f32, as the reference."""
    logits = (xc @ head).float()                        # [B, c, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_ce_loss(head: torch.Tensor, xs: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """head: [d, V]; xs: [B, S, d]; targets: [B, S] int. Mean NLL over
    chunks of `_pick_chunk(S, chunk)` positions, summed in order into an
    f32 total as the reference's scan. Under autograd each chunk is
    checkpointed: its [B, c, V] f32 logits are recomputed in the backward
    rather than kept (10 GB at B 8, S 2048, V 151,936)."""
    B, S, d = xs.shape
    chunk = _pick_chunk(S, chunk)
    grad = torch.is_grad_enabled() and (xs.requires_grad
                                        or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=xs.device)
    for c0 in range(0, S, chunk):
        xc, tc = xs[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        part = (checkpoint(_chunk_nll, head, xc, tc, use_reentrant=False)
                if grad else _chunk_nll(head, xc, tc))
        total = total + part
    return total / (B * S)
