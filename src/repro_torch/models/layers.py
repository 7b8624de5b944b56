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

`cfg.seq_shard_attention` (prefill, T > 1) is the reference's
context-parallel variant: off a mesh its prefill attention is
`attention_unchunked`, the single-einsum form, except on CUDA with the
kernels, where the flash kernel runs (it takes any query positions). On
DTensor activations (`parallel.sharding.distribute_params`) the kernels and
the in-place cache writes run on each rank's local shards through
`local_map` with declared placements: batch over the batch axes where it
divides; over `model`, the query rows under `seq_shard_attention` where T
divides (the keys and values replicated, each shard reading its own query
positions), else whole KV heads where they divide, else replicated, since a
kernel needs whole heads. A decode cache that the rules split on its slots
(KV heads that do not divide `model`) stays split: each rank attends over
its own slots and the partial softmaxes are merged by their log-sum-exps
(`merge_decode_parts`), as GSPMD runs the reference's decode there. A
decode cache that the rules split on head_dim (`prefer_hd`) stays split
too: each rank scores its own lanes (`kernels.decode_attention_hd`), the
partial scores are all-reduced, and each rank runs the softmax and P V on
its lanes; only the step's output is gathered back to whole heads.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import decode_attention_ref
from ..kernels.decode_attention_hd.ops import (decode_scores_hd,
                                               decode_softmax_pv_hd)
from ..kernels.decode_attention_hd.ref import (decode_scores_hd_ref,
                                               decode_softmax_pv_hd_ref)
from ..kernels.flash_attention.ops import flash_attention
from ..parallel.sharding import batch_spec, to_placements
from .config import ModelConfig

NEG_INF = -1e30
EMPTY_SLOT = 2 ** 30    # position of a cache slot never written


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def replicated_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t, which every rank holds whole, as a replicated DTensor on the mesh
    of `like` when that is a DTensor (a DTensor op takes no plain tensor,
    in the forward or in the backward); else t itself."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def batch_placements(x) -> list:
    """DTensor x's placements with only its batch (dim 0) sharding kept:
    `Shard(0)` where x is split on dim 0, `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]


def whole_heads(t, n_heads: int):
    """t [..., n_heads * hd]; a DTensor split on its last dim over a mesh
    dim whose size does not divide n_heads (qwen2-0.5b's 14 heads on a
    "model" axis of 4 or 16, whose projection the rules split by columns)
    is gathered there, so that its view into heads keeps whole heads."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    last, mesh = t.ndim - 1, t.device_mesh
    pl = [Replicate() if p.is_shard(last) and n_heads % mesh.size(i) else p
          for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def _flat_heads(out, n_heads: int):
    """out [B, T, H, hd] -> [B, T, H * hd] for the output projection; on a
    DTensor, its gradient split by columns over a mesh dim that does not
    divide the heads is gathered first (`whole_heads`), so that the
    flatten's backward, a view into heads, keeps whole heads."""
    B, T = out.shape[:2]
    flat = out.reshape(B, T, -1)
    return _WholeHeadsGrad.apply(flat, n_heads) if is_dtensor(flat) else flat


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity, whose backward passes the gradient through
    `whole_heads`."""

    @staticmethod
    def forward(ctx, x, n_heads):
        ctx.n_heads = n_heads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return whole_heads(g, ctx.n_heads), None


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
    cos, sin = replicated_like(torch.cos(ang), x), replicated_like(
        torch.sin(ang), x)
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


def attention_unchunked(q, k, v, q_pos, k_pos, window: int = 0):
    """Single-einsum attention: materializes [B, KV, G, Tq, Tk] logits.
    The reference's form for the seq-sharded (context-parallel) prefill,
    where the query rows are split across the `model` axis."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    s = s * (hd ** -0.5)
    m = _mask(q_pos, k_pos, window)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Tq, H, hd).to(q.dtype)


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
                       use_kernels: bool, unchunked: bool = False
                       ) -> torch.Tensor:
    """[B,T,H,hd] x [B,Tk,KV,hd] -> [B,T,H,hd]. The kernel reads the
    model's tensors as [B,H,T,hd] views and writes its output in the
    model's layout, so neither side is copied. `unchunked`: the
    seq-sharded variant's single einsum, unless the kernel runs on CUDA."""
    if use_kernels and (q.is_cuda or not unchunked):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), q_pos.to(torch.int32),
                              k_pos.to(torch.int32), window=window)
        return out.transpose(1, 2)
    if unchunked:
        return attention_unchunked(q, k, v, q_pos, k_pos, window=window)
    return attention(q, k, v, q_pos, k_pos, window=window)


def _placements(mesh, B: int, KV: int, T: int | None = None):
    """Placements of a kernel's operands over [B, T|S, H|KV, hd]: (q and
    the output, k/v or the cache, the query positions [T]). T is given for
    the seq-sharded prefill."""
    from torch.distributed.tensor import Replicate, Shard
    bx = batch_spec(mesh, (B,))[0]
    batch = {bx} if isinstance(bx, str) else set(bx or ())
    qp, kvp, posp = [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if name in batch:
            pl = (Shard(0), Shard(0), Replicate())
        elif name == "model" and T is not None and T % n == 0:
            pl = (Shard(1), Replicate(), Shard(0))
        elif name == "model" and KV % n == 0:
            pl = (Shard(2), Shard(2), Replicate())
        else:
            pl = (Replicate(),) * 3
        for out, p in zip((qp, kvp, posp), pl):
            out.append(p)
    return tuple(qp), tuple(kvp), tuple(posp)


def _local_map(fn, out_placements, in_placements, mesh, split=None):
    """`local_map` of fn; out_placements is a tuple with one entry per
    output. `split[i]` says that fn's work is divided over mesh dim i (a
    batch or head shard per rank): an input replicated there is read by
    every rank for its own part, so its gradient is the sum over the ranks
    (`Partial()`), not any one rank's."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    if len(out_placements) == 1:    # one output: its placements, a list
        out_placements = list(out_placements[0])
    grad = None
    if split is not None:
        grad = tuple(None if pl is None else tuple(
            Partial() if cut and p.is_replicate() else p
            for p, cut in zip(pl, split)) for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grad,
                     device_mesh=mesh, redistribute_inputs=True)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    DTensor's gradient is built from the local one with the strides of the
    forward's (contiguous) tensor."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sharded_prefill(q, k, v, q_pos, k_pos, window: int, use_kernels: bool,
                     unchunked: bool):
    """`_prefill_attention` on DTensor q, k, v, rank by rank."""
    mesh = q.device_mesh
    qp, kvp, posp = _placements(mesh, q.shape[0], k.shape[2],
                                q.shape[1] if unchunked else None)
    q_pos = replicated_like(q_pos, q)

    def fn(q, k, v, q_pos, k_pos):
        # Local tensors, and their gradients, contiguous as DTensor takes
        # them to be (copies only where they are not).
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return _prefill_attention(q, k, v, q_pos, k_pos, window, use_kernels,
                                  unchunked).contiguous()
    out = _local_map(fn, (qp,), (qp, kvp, kvp, posp, None), mesh)(
        q, k, v, q_pos, k_pos)
    if unchunked:
        # query rows back to the unsharded variant's layout, for the
        # output projection (which may not flatten a sharded T into B T)
        out = out.redistribute(mesh, _placements(mesh, q.shape[0],
                                                 k.shape[2])[0])
    return out


def decode_key_positions(S: int, pos0: int, window: int,
                         device: torch.device | str | None = None,
                         start: int = 0, length: int | None = None
                         ) -> torch.Tensor:
    """[S] int32: the absolute position each cache slot holds once position
    `pos0` is written, EMPTY_SLOT for a slot never written. With a window,
    slots that fell out of it are marked empty too, because the decode
    kernel masks only k_pos > pos. The map is the same for every layer of
    a decode step. `start`, `length`: the map of slots start .. start +
    length of the S only (one rank's shard), in a tensor of its own."""
    length = S - start if length is None else length
    slots = torch.arange(start, start + length, dtype=torch.int32,
                         device=device)
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
                      use_kernels: bool, return_lse: bool = False):
    """One query position `pos` against the cache. q [B,1,H,hd]; kc, vc
    [B,S,KV,hd]; k_pos [S] int32 from `decode_key_positions`. With
    `return_lse`, (out, lse [B,1,H] f32), the kernel's or its plain
    version's, for a merge over slot ranges."""
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    args = (q.reshape(B, KV, H // KV, hd), kc.transpose(1, 2),
            vc.transpose(1, 2), k_pos, pos)
    if return_lse:
        out, lse = (decode_attention if use_kernels else decode_attention_ref)(
            *args, return_lse=True)
        return out.reshape(B, 1, H, hd), lse.reshape(B, 1, H)
    if not use_kernels:
        q_pos = torch.full((1,), pos, dtype=k_pos.dtype, device=q.device)
        return attention(q, kc, vc, q_pos, k_pos, window=window)
    return decode_attention(*args).reshape(B, 1, H, hd)


def _all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """t all-reduced (`op`: "sum" or "max") over each mesh dim of `dims`
    that holds more than one rank, in turn."""
    from torch.distributed import _functional_collectives as funcol
    for i in dims:
        if mesh.size(i) > 1:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
    return t


def merge_decode_parts(o: torch.Tensor, lse: torch.Tensor,
                       dim: int | None = None, mesh=None,
                       mesh_dims: tuple[int, ...] = ()) -> torch.Tensor:
    """The attention over a union of disjoint slot ranges from its parts
    over each range: o [..., hd] and lse [...] (o's dims but the last),
    each part's output and log-sum-exp (-inf, with o zero, for a range
    with no admissible slot). The parts are stacked on dim `dim` of both,
    or, with no `dim`, held one a rank over `mesh_dims` of `mesh` (the
    mesh dims that split the cache's slots). In f32: M = max lse, w =
    exp(lse - M), out = sum(o w) / sum(w); zeros where every part is
    empty. Over a mesh: an all-reduce of the max, then one all-reduce of
    o w and w packed together, per mesh dim. Returns f32."""
    def reduce(t, op: str):
        if dim is not None:
            return t.amax(dim) if op == "max" else t.sum(dim)
        return _all_reduce(t, op, mesh, mesh_dims)
    lse = lse.float()
    m = reduce(lse, "max")
    m = torch.where(m > -torch.inf, m, 0.0)    # all parts empty: w = 0
    w = torch.exp(lse - (m if dim is None else m.unsqueeze(dim)))
    ow = reduce(torch.cat([o.float() * w[..., None], w[..., None]], -1),
                "sum")
    return ow[..., :-1] / ow[..., -1:].clamp_min(1e-30)


def _sharded_decode(q, kc, vc, pos: int, k_pos, window: int,
                    use_kernels: bool):
    """`_decode_attention` on a DTensor q and cache, rank by rank. Over a
    mesh dim that splits the cache's slots (dim 1), q is replicated, each
    rank attends over its own slots with their key positions, and the
    parts are merged there (`merge_decode_parts`). Over a mesh dim that
    splits the cache's head_dim (dim 3), q is split there too (a local
    slice), each rank scores its own lanes, the partial scores are
    all-reduced in f32, and each rank runs the softmax and P V on its
    lanes (`_hd_split_decode`); the output's lanes are then gathered to
    whole heads, the layout of `_flat_heads`. No rank gathers the cache."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    qp, kvp, _ = _placements(mesh, q.shape[0], kc.shape[2])
    slot_dims = tuple(i for i, p in enumerate(kc.placements)
                      if p.is_shard(1))
    hd_dims = tuple(i for i, p in enumerate(kc.placements) if p.is_shard(3))
    qp_local = tuple(Replicate() if i in slot_dims else
                     Shard(3) if i in hd_dims else p
                     for i, p in enumerate(qp))
    kvp = tuple(Shard(1) if i in slot_dims else Shard(3) if i in hd_dims
                else p for i, p in enumerate(kvp))
    if slot_dims:
        k_pos = decode_key_positions(kc.shape[1], pos, window, k_pos.device,
                                     _shard_start(kc, 1),
                                     kc.to_local().shape[1])
    # the whole head's scale (q is the global DTensor here, its last dim
    # cfg.hd), never that of a rank's slice of head_dim
    scale = q.shape[-1] ** -0.5

    def fn(q, kc, vc):
        if hd_dims:
            return _hd_split_decode(q, kc, vc, pos, k_pos, scale,
                                    use_kernels, mesh, hd_dims)
        if not slot_dims:
            return _decode_attention(q, kc, vc, pos, k_pos, window,
                                     use_kernels)
        o, lse = _decode_attention(q, kc, vc, pos, k_pos, window,
                                   use_kernels, return_lse=True)
        return merge_decode_parts(o, lse, mesh=mesh,
                                  mesh_dims=slot_dims).to(q.dtype)
    out = _local_map(fn, (qp_local,), (qp_local, kvp, kvp), mesh)(q, kc, vc)
    return out.redistribute(mesh, qp) if hd_dims else out


def _hd_split_decode(q, kc, vc, pos: int, k_pos, scale: float,
                     use_kernels: bool, mesh, hd_dims: tuple[int, ...]):
    """One rank's part of a decode over a cache split on head_dim: q
    [B,1,H,hl], kc, vc [B,S,KV,hl] its lanes. Its partial scores
    (`hd_slice_scores`) summed over `hd_dims` of `mesh` in f32, then its
    lanes of the output (`hd_slice_attend`). Returns [B,1,H,hl] in v's
    dtype."""
    s = _all_reduce(hd_slice_scores(q, kc, use_kernels), "sum", mesh,
                    hd_dims)
    return hd_slice_attend(s, vc, pos, k_pos, scale, use_kernels)


def hd_slice_scores(q, kc, use_kernels: bool = True) -> torch.Tensor:
    """The partial scores [B,KV,G,S] f32 of one slice of head_dim's lanes:
    q [B,1,H,hl] and the cache's kc [B,S,KV,hl], as a rank holds them
    where the cache is split on head_dim. The kernel on CUDA tensors
    (`use_kernels`), else its plain version."""
    B, _, H, hl = q.shape
    KV = kc.shape[2]
    return (decode_scores_hd if use_kernels else decode_scores_hd_ref)(
        q.reshape(B, KV, H // KV, hl), kc.transpose(1, 2))


def hd_slice_attend(s, vc, pos: int, k_pos, scale: float,
                    use_kernels: bool = True) -> torch.Tensor:
    """One slice's lanes of the decode output [B,1,H,hl], in vc's dtype:
    the masked softmax of s [B,KV,G,S] f32, the scores summed over every
    slice, at the whole head's `scale`, weighing the slice's lanes of vc
    [B,S,KV,hl]. The kernel on CUDA tensors (`use_kernels`), else its
    plain version."""
    B, KV, G, _ = s.shape
    o = (decode_softmax_pv_hd if use_kernels else decode_softmax_pv_hd_ref)(
        s, vc.transpose(1, 2), k_pos, pos, scale)
    return o.reshape(B, 1, KV * G, vc.shape[-1])


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
    built here when not given. x, the weights and the cache may be
    DTensors: the kernels and the cache writes then run on local shards.
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
    q = whole_heads(q, H).reshape(B, T, H, hd)
    k = whole_heads(k, KV).reshape(B, T, KV, hd)
    v = whole_heads(v, KV).reshape(B, T, KV, hd)
    q_pos = pos0 + torch.arange(T, device=x.device)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    sharded = is_dtensor(q)
    if T > 1 or cache_kv is None:
        # Prefill (pos0 == 0 by convention when there is a cache): attend
        # over the fresh K/V with the causal(+window) mask.
        unchunked = cfg.seq_shard_attention and T > 1
        out = (_sharded_prefill if sharded else _prefill_attention)(
            q, k, v, q_pos, q_pos, window, use_kernels, unchunked)
    if cache_kv is None:
        return _flat_heads(out, H) @ p["wo"], (k, v)
    kc, vc = cache_kv
    S = kc.shape[1]
    if sharded:
        kc, vc = _sharded_write(kc, vc, k, v, pos0, window)
    else:
        _write(kc, vc, k, v, pos0, window)
    if T == 1:
        # Decode: one position against the cache.
        if k_pos is None:
            k_pos = decode_key_positions(S, pos0, window, x.device)
        out = (_sharded_decode if sharded else _decode_attention)(
            q, kc, vc, pos0, k_pos, window, use_kernels)
    out = _flat_heads(out, H) @ p["wo"]
    return out, (kc, vc)


def _write(kc, vc, k, v, pos0: int, window: int, s0: int = 0,
           S: int | None = None):
    """Write k, v [B,T,KV,hd] (positions pos0..) into the caches in place
    and return them. A ring of `window` slots keeps the last S keys (slots
    are unique); otherwise a write past the cache's end raises. The caches
    may be one rank's shard of S slots: global slots s0 .. s0 + their
    length."""
    T, S_l = k.shape[1], kc.shape[1]
    S = S_l if S is None else S
    if window > 0 and S == window:
        # the last `keep` positions land on slots a, a+1, .. (mod S): two
        # runs of slots, [a, S) then [0, ..), each written where it meets
        # this shard's slots
        keep = min(T, S)
        a = (pos0 + T - keep) % S
        first = min(keep, S - a)
        for j0, j1, slot0 in ((0, first, a), (first, keep, 0)):
            lo, hi = max(slot0, s0), min(slot0 + j1 - j0, s0 + S_l)
            if lo < hi:
                src = T - keep + j0 + lo - slot0
                kc[:, lo - s0:hi - s0] = k[:, src:src + hi - lo]
                vc[:, lo - s0:hi - s0] = v[:, src:src + hi - lo]
        return kc, vc
    if pos0 + T > S:
        raise ValueError(f"cache of {S} positions cannot take positions "
                         f"{pos0}..{pos0 + T - 1}")
    lo, hi = max(pos0, s0), min(pos0 + T, s0 + S_l)
    if lo < hi:
        kc[:, lo - s0:hi - s0] = k[:, lo - pos0:hi - pos0]
        vc[:, lo - s0:hi - s0] = v[:, lo - pos0:hi - pos0]
    return kc, vc


def _shard_start(t, dim: int) -> int:
    """The first index along `dim` of this rank's shard of DTensor t (even
    shards, mesh dims major to minor)."""
    start, size = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            size //= t.device_mesh.size(i)
            start += t.device_mesh.get_local_rank(i) * size
    return start


def _sharded_write(kc, vc, k, v, pos0: int, window: int):
    """`_write` into DTensor caches, each rank into its own shard, in
    place: k, v arrive replicated along the cache's sharded slots and
    sharded as the cache on every other dim."""
    from torch.distributed.tensor import Replicate
    pl = kc.placements
    kvp = tuple(Replicate() if p.is_shard(1) else p for p in pl)
    fn = functools.partial(_write, pos0=pos0, window=window,
                           s0=_shard_start(kc, 1), S=kc.shape[1])
    return _local_map(fn, (pl, pl), (pl, pl, kvp, kvp), kc.device_mesh)(
        kc, vc, k, v)


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
    return torch.sum(logz - _gold(logits, tc))


def _gold(logits: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """logits [B, c, V] at the targets tc [B, c]."""
    return torch.gather(logits, -1, tc[..., None].long())[..., 0]


def _shard_gold(logits: torch.Tensor, tc: torch.Tensor,
                v0: int) -> torch.Tensor:
    """`_gold` on one rank's vocabulary shard, entries v0 on: a target
    outside it reads 0."""
    t = tc.long() - v0
    V = logits.shape[-1]
    g = _gold(logits, t.clamp(0, V - 1))
    return torch.where((t >= 0) & (t < V), g, 0.0)


def _fsdp_gathered(w):
    """DTensor w (the head [d, V], the embedding table [..., V, d]) with
    its split of d over the batch (FSDP) axes gathered and its "model"
    split kept: once per call, where a product or a lookup on the
    batch-split activations would move the activations at every chunk.
    Its gradient, a partial sum over the batch axes, is reduce-scattered
    back onto that split."""
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    pl = [Replicate() if p.is_shard() and name != "model" else p
          for name, p in zip(mesh.mesh_dim_names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(mesh, pl)


class _LossPlan:
    """How one rank computes a chunk's NLL from its local shards of x
    [B, c, d] (batch over the batch axes, replicated elsewhere) and of a
    gathered head [d, V]: the mesh dims that split the
    batch (`batch`), V (`vocab`: the log-sum-exp and the gold logit are
    merged there) or d (`rows`: the logits are partial sums there, the
    fallback where V does not divide "model"); the local_map placements
    of x, the head and the targets; v0, this rank's first vocabulary
    entry. Built once per loss call, from the gathered head
    (`_fsdp_gathered`)."""

    def __init__(self, head, xs):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = mesh = head.device_mesh
        self.batch, self.vocab, self.rows, self.split = [], [], [], []
        self.xp, self.tp = [], []
        for i, (hp, xp) in enumerate(zip(head.placements, xs.placements)):
            big = mesh.size(i) > 1
            if xp.is_shard(0):
                self.xp.append(Shard(0))
                self.tp.append(Shard(0))
                kind = self.batch
            else:
                if not xp.is_replicate():
                    raise ValueError(f"loss activations placed {xs.placements}"
                                     f": want the batch layout")
                self.xp.append(Shard(2) if hp.is_shard(0) else Replicate())
                self.tp.append(Replicate())
                kind = (self.rows if hp.is_shard(0) else
                        self.vocab if hp.is_shard(1) else None)
            if big and kind is not None:
                kind.append(i)
            self.split.append(big and xp.is_shard(0))
        self.hp = list(head.placements)
        self.v0 = _shard_start(head, 1)

    def logits(self, x, head):
        """The chunk's f32 logits [B_local, c, V_local], from the product
        in the model's dtype; over `rows` the partial products are summed
        in f32 and rounded to the model's dtype, as the whole product."""
        out = (x @ head).float()
        if self.rows:
            out = _all_reduce(out, "sum", self.mesh, self.rows)
            out = out.to(x.dtype).float()
        return out


class _VocabParallelNLL(torch.autograd.Function):
    """A chunk's summed NLL on one rank's local shards (`_LossPlan`),
    whole on every rank: no rank builds the logits of another's rows or
    vocabulary. Forward: the local logits; over `vocab` an all-reduce of
    the row maxima, then one of the sums of exponentials and the gold
    logits packed together, [B_local, c, 2]; the rows' NLL summed and
    all-reduced over `batch`. Only the log-sum-exps [B_local, c] are kept:
    the backward recomputes the logits (as the plain path's checkpoint
    does), forms dlogits = (softmax - onehot) * g on the local slice, and
    takes dx and dhead through the product's own backward; dx is
    all-reduced over `vocab` (in f32), dhead stays a partial sum over the
    batch (the caller's placements reduce-scatter it). Where nothing
    splits V the arithmetic is the plain path's (`torch.logsumexp` and
    its backward), so a one-device mesh gives its bits."""

    @staticmethod
    def forward(ctx, x, head, tc, plan: _LossPlan):
        logits = plan.logits(x, head)
        if plan.vocab:
            m = _all_reduce(logits.amax(-1), "max", plan.mesh, plan.vocab)
            s = torch.exp(logits - m[..., None]).sum(-1)
            sg = _all_reduce(torch.stack([s, _shard_gold(logits, tc,
                                                         plan.v0)], -1),
                             "sum", plan.mesh, plan.vocab)
            logz, gold = torch.log(sg[..., 0]) + m, sg[..., 1]
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = _shard_gold(logits, tc, plan.v0)
        ctx.save_for_backward(x, head, tc, logz)
        ctx.plan = plan
        return _all_reduce(torch.sum(logz - gold), "sum", plan.mesh,
                           plan.batch)

    @staticmethod
    def backward(ctx, g):
        x, head, tc, logz = ctx.saved_tensors
        plan = ctx.plan
        want = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xg = x.detach().requires_grad_(want[0])
            hg = head.detach().requires_grad_(want[1])
            prod = (xg @ hg).float()
        with torch.no_grad():
            logits = prod.detach()
            if plan.rows:
                logits = _all_reduce(logits, "sum", plan.mesh, plan.rows)
                logits = logits.to(x.dtype).float()
            dl = g * torch.exp(logits - logz[..., None])
            t, V = tc.long() - plan.v0, dl.shape[-1]
            hit = torch.where((t >= 0) & (t < V), -g, 0.0)
            dl.scatter_add_(-1, t.clamp(0, V - 1)[..., None], hit[..., None])
        grads = iter(torch.autograd.grad(
            prod, [a for a, w in zip((xg, hg), want) if w], dl))
        dx, dhead = (next(grads) if w else None for w in want)
        if dx is not None and plan.vocab:
            dx = _all_reduce(dx.float(), "sum", plan.mesh,
                             plan.vocab).to(x.dtype)
        return (None if dx is None else dx.contiguous(),
                None if dhead is None else dhead.contiguous(), None, None)


def chunked_ce_loss(head: torch.Tensor, xs: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """head: [d, V]; xs: [B, S, d]; targets: [B, S] int. Mean NLL over
    chunks of `_pick_chunk(S, chunk)` positions, summed in order into an
    f32 total as the reference's scan. Under autograd each chunk's [B, c,
    V] f32 logits are recomputed in the backward rather than kept (10 GB
    at B 8, S 2048, V 151,936): the plain path checkpoints the chunk.
    On DTensors (xs in the batch layout, the head as the reference's rule
    places it) the head is gathered over the FSDP axes once
    (`_fsdp_gathered`) and each chunk runs on local shards
    (`_VocabParallelNLL`): every rank's logits are its own rows and its
    own slice of V, whose log-sum-exps are merged, so no rank builds the
    whole batch's [B, c, V]."""
    B, S, d = xs.shape
    chunk = _pick_chunk(S, chunk)
    grad = torch.is_grad_enabled() and (xs.requires_grad
                                        or head.requires_grad)
    sharded = is_dtensor(xs)
    if sharded:
        from torch.distributed.tensor import Replicate
        head = _fsdp_gathered(head)
        plan = _LossPlan(head, xs)
        targets = replicated_like(targets, xs)
        sharded_nll = _local_map(
            lambda x, h, t: _VocabParallelNLL.apply(x, h, t, plan),
            ([Replicate()] * plan.mesh.ndim,), (plan.xp, plan.hp, plan.tp),
            plan.mesh, plan.split)
    total = replicated_like(
        torch.zeros((), dtype=torch.float32, device=xs.device), xs)
    for c0 in range(0, S, chunk):
        xc, tc = xs[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        if sharded:
            part = sharded_nll(xc, head, tc)
        elif grad:
            part = checkpoint(_chunk_nll, head, xc, tc, use_reentrant=False)
        else:
            part = _chunk_nll(head, xc, tc)
        total = total + part
    return total / (B * S)


# ---------------------------------------------------------------------------
# The token embedding on DTensors (each rank's rows on its slice of the table)
# ---------------------------------------------------------------------------

class _EmbedPlan:
    """How one rank looks up tokens [B, T] (or [B, T, nq]) on its local
    shard of a table [V, d] (or codebooks [nq, V, d]), per mesh dim, from
    the table's placements there:
    - whole: the rank's own rows of the batch layout (`rows`: B over the
      batch axes where it divides), whose work is `split` there (the
      table's gradient is a partial sum over those ranks);
    - V split (`vocab`): the rows that the other dims give, an id outside
      this rank's slice looking up zeros, summed over the slice's ranks;
    - d split: every row that the other dims give, on this rank's columns,
      which the caller then moves to the batch layout (`out`: split on the
      last dim there).
    The local_map placements of the table (`tablep`), the tokens (`tokp`)
    and the output (`out`), and v0, this rank's first vocabulary entry. A
    table split otherwise raises: there is no replicated fallback."""

    def __init__(self, table, B: int):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = mesh = table.device_mesh
        vdim, ddim = table.ndim - 2, table.ndim - 1
        self.rows = to_placements(batch_spec(mesh, (B,)), mesh)
        self.vocab, self.split, self.tokp, self.out = [], [], [], []
        for i, (tp, bp) in enumerate(zip(table.placements, self.rows)):
            if tp.is_replicate():
                tok = out = bp
            elif tp.is_shard(vdim) and not bp.is_shard():
                tok = out = Replicate()
                if mesh.size(i) > 1:
                    self.vocab.append(i)
            elif tp.is_shard(ddim):
                tok, out = Replicate(), Shard(2)
            else:
                raise ValueError(
                    f"embedding table placed {table.placements} on mesh "
                    f"dims {mesh.mesh_dim_names}: V may be split only "
                    f"where the batch is not")
            self.tokp.append(tok)
            self.out.append(out)
            self.split.append(mesh.size(i) > 1 and tok.is_shard())
        self.tablep = list(table.placements)
        self.v0 = _shard_start(table, vdim)


def _slice_rows(table: torch.Tensor, ids: torch.Tensor,
                masked: bool) -> torch.Tensor:
    """table[ids] on one rank's slice of V, rows [V_l, d]; `masked`: an id
    equal to V_l (outside the slice) looks up zeros."""
    if not masked:
        return F.embedding(ids, table)
    n = table.shape[0]
    return F.embedding(ids.clamp(max=n - 1), table).masked_fill(
        (ids == n)[..., None], 0)


class _VocabParallelEmbed(torch.autograd.Function):
    """The token embedding on one rank's local shards (`_EmbedPlan`).
    Forward: each codebook's rows looked up on the local slice (zeros for
    an id outside it), summed over `vocab` (exact: one term is not zero),
    then added in the reference's order ((0 + e0) + e1) + ... in the
    table's dtype. Backward: the rows' gradients index-added into the
    local slice (`embedding_dense_backward`, `F.embedding`'s own
    backward). Where nothing splits V the arithmetic is `F.embedding`'s,
    so a one-device mesh gives its bits."""

    @staticmethod
    def forward(ctx, table, tokens, plan: _EmbedPlan):
        books = table.ndim == 3
        V = table.shape[-2]
        t = tokens
        if plan.vocab:
            t = tokens - plan.v0
            t = torch.where((t >= 0) & (t < V), t, V)
        pairs = (zip(table.unbind(0), t.unbind(-1)) if books
                 else ((table, t),))
        parts = [_slice_rows(w, i, bool(plan.vocab)) for w, i in pairs]
        if plan.vocab:
            parts = _all_reduce(torch.stack(parts), "sum", plan.mesh,
                                plan.vocab).unbind(0)
        ctx.save_for_backward(t)
        ctx.plan, ctx.books, ctx.V = plan, books, V
        return sum(parts) if books else parts[0]

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        V = ctx.V
        # an id outside the slice (== V) names a padding row, which
        # gathers no gradient
        n, pad = (V + 1, V) if ctx.plan.vocab else (V, -1)
        grads = [torch.ops.aten.embedding_dense_backward(g, i, n, pad,
                                                         False)[:V]
                 for i in (t.unbind(-1) if ctx.books else (t,))]
        dw = torch.stack(grads) if ctx.books else grads[0]
        return dw.contiguous(), None, None


def _table_moves(table, B: int, T: int) -> bool:
    """Whether gathering the table's FSDP split of d moves fewer bytes
    than moving the looked-up rows: the table's local rows (over all its
    codebooks) against the rows [B_local, T] of a rank's output."""
    mesh = table.device_mesh
    rows = to_placements(batch_spec(mesh, (B,)), mesh)
    mine = B * T
    for i, p in enumerate(rows):
        mine //= mesh.size(i) if p.is_shard() else 1
    local = table.to_local().shape
    return local[:-1].numel() <= mine


def vocab_parallel_embed(table, tokens: torch.Tensor):
    """table[tokens] for a DTensor table [V, d] (or codebooks [nq, V, d],
    their rows summed) placed by the reference's rule, and tokens [B, T]
    (or [B, T, nq]) that every rank holds whole: [B, T, d] in the batch
    layout (B over the batch axes where it divides, replicated elsewhere).
    Each rank looks up rows on its own slice of the table
    (`_VocabParallelEmbed`). Where the rule splits d over the FSDP axes,
    the smaller of two moves is made: the table is gathered there once a
    call (each rank then looks up its own rows, and the gradient is
    reduce-scattered back onto the split), or the table stays and the
    looked-up rows move (each rank looks up its group's rows on its
    columns, and an all-to-all puts them in the batch layout, its
    gradient back; the gradient is then whole on each shard). V over
    "model" sums the lookups there; d over "model" (a V that does not
    divide it) gathers the columns; a table whole over the batch axes
    has its gradient summed there. No rank moves a whole [V, d]."""
    B, T = tokens.shape[:2]
    if _table_moves(table, B, T):
        table = _fsdp_gathered(table)
    plan = _EmbedPlan(table, B)
    x = _local_map(
        lambda w, t: _VocabParallelEmbed.apply(w, t, plan), (plan.out,),
        (plan.tablep, plan.tokp), plan.mesh, plan.split)(
            table, replicated_like(tokens, table))
    return x.redistribute(plan.mesh, plan.rows)
