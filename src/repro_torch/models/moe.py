"""Mixture-of-Experts channel mixer (scatter-dispatch, capacity-based), on
torch tensors.

Tokens are routed in f32 (softmax, top-k, gates renormalised), ranked
within their expert in token order, and copied into dense
per-expert buffers [E, C, d]; the expert SwiGLU runs as three batched
products over the stacked expert weights, and the results are gathered
back and weighted by their gates. A copy ranked past the capacity C is
dropped, as in the reference. With `moe_w8a8` the expert weights are int8
with per-expert, per-output-channel f32 scales, activations are quantised
per row on the fly, and the three products are int8 x int8 -> int32 on
the port's grouped int8 GEMM (`kernels/int8_grouped_matmul`).

The int8 expert weights keep the reference's shape [n, E, d_in, d_out]
and values, in a K-major storage: each is `.transpose(-1, -2)` of a
contiguous [n, E, d_out, d_in], so its stride on d_in (the products' K)
is 1. The int8 `wgmma` takes its shared-memory operands K-major only
(`kernels/csrc/int8_grouped_matmul_wgmma.cu`). It is a layout of the
port, not a change of shape: every value, comparison and checkpoint is
the reference's.

Nothing here reads a tensor back to the host: the capacity comes from the
shapes, and drops are masks, so a decode step issues its launches without
waiting for the device.

On DTensor activations (`parallel.sharding.distribute_params`) the
routed experts run rank by rank (`_sharded_experts`) on the weights'
shards as the reference's rule places them: E over "model" where it
divides (expert parallelism), else plain TP on the experts' f, and f over
the FSDP axes. No expert weight moves: where the weights split f over a
mesh dim, the tokens come to them (gathered there), each rank runs its
experts over its slice of f, and the output is a partial sum there. The
capacity and the drops are the global batch's. Each rank builds the
dispatch buffers of its own experts only, so its buffers and the
products' output are E over "model" and whole over the data axes by
construction: the layout that the reference's hint
`cfg.moe_expert_shard_constraint` pins. In the port the flag therefore
changes nothing, with a mesh or without one (without one it does nothing
in the reference either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..kernels.int8_grouped_matmul.ops import int8_grouped_matmul
from ..kernels.int8_grouped_matmul.ref import int8_grouped_matmul_ref
from .config import ModelConfig
from .layers import _ContiguousGrad, _local_map, mlp_apply

EXPERT_WEIGHTS = ("w1", "w3", "w2")


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 weights with one f32 scale per output channel: w [...,
    d_in, d_out] (any float dtype) -> (int8 [..., d_in, d_out], f32 [..., 1,
    d_out]), the reference's rounding (half to even) and order."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    q = torch.round(w / torch.clamp(scale, min=1e-9)).to(torch.int8)
    return q, scale


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """w [..., d_in, d_out] with the same shape and values, stored K-major
    (unit stride on d_in); w itself when it already is."""
    if w.stride(-2) == 1:
        return w
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def kmajor_experts(tree):
    """A parameter tree whose W8A8 expert weights (the int8 w1/w3/w2 of a
    MoE node, the one with `w1_s`) are stored K-major; every other leaf as
    it was."""
    if not isinstance(tree, dict):
        return tree
    out = {k: kmajor_experts(v) for k, v in tree.items()}
    if "w1_s" in tree:
        for name in EXPERT_WEIGHTS:
            if out[name].dtype == torch.int8:
                out[name] = kmajor(out[name])
    return out


def moe_params(normal, full, cfg: ModelConfig, n: int) -> dict:
    """The reference's MoE tree for `n` stacked layers: router [n,d,E] f32
    (drawn in the model's dtype, then widened), w1/w3 [n,E,d,f] and w2
    [n,E,f,d], and `shared` (w1, w3, w2) when `shared_expert_ff` is set.
    With `moe_w8a8`, w1/w3/w2 are int8 beside f32 scales `*_s` [n,E,1,out],
    each expert quantised from its own draw in the model's dtype, so no
    layer of unquantised experts is ever held, into the K-major storage
    (see the module note); on the meta device nothing is drawn.
    `normal(shape, fan_in)` and `full(value, shape)` are the decoder's
    drawing functions (the MoE tree has no constant leaves, so `full` goes
    unused)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = dict(router=normal((n, d, E), d).float())
    dev = p["router"].device
    for name, (d_in, d_out) in zip(EXPERT_WEIGHTS, ((d, f), (d, f), (f, d)),
                                   strict=True):
        if not cfg.moe_w8a8:
            p[name] = normal((n, E, d_in, d_out), d_in)
            continue
        q = torch.empty((n, E, d_out, d_in), dtype=torch.int8,
                        device=dev).transpose(-1, -2)
        s = torch.empty((n, E, 1, d_out), dtype=torch.float32, device=dev)
        for i in range(n if dev.type != "meta" else 0):
            for e in range(E):
                q[i, e], s[i, e] = quantize_weight(normal((d_in, d_out),
                                                          d_in))
        p[name], p[name + "_s"] = q, s
    if cfg.shared_expert_ff:
        sf = cfg.shared_expert_ff
        p["shared"] = dict(w1=normal((n, d, sf), d), w3=normal((n, d, sf), d),
                           w2=normal((n, sf, d), sf))
    return p


def _quant_act(x: torch.Tensor, row_max=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantisation of activations.
    `row_max` takes the rows' local maxima [..., 1] to the whole rows'
    when x holds a slice of each row (the ranks' slices of f)."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (amax if row_max is None else row_max(amax)) / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-9)).to(torch.int8)
    return q, scale


def _w8a8_ffn(p: dict, buf: torch.Tensor, use_kernels: bool = True,
              row_max=None) -> torch.Tensor:
    """Expert SwiGLU with int8 x int8 -> int32 products (W8A8): buf [E,C,d]
    -> [E,C,d] in buf's dtype. `use_kernels` picks the grouped int8 GEMM
    op (its plain version on CPU tensors) or the plain version; the two
    are equal bit for bit. Weights that hold a slice of f quantise the
    hidden rows with `row_max` (`_quant_act`) and give a partial sum."""
    matmul = int8_grouped_matmul if use_kernels else int8_grouped_matmul_ref
    qb, bs = _quant_act(buf)                                # [E,C,d], [E,C,1]
    h1 = matmul(qb, p["w1"]).float() * bs * p["w1_s"]
    h3 = matmul(qb, p["w3"]).float() * bs * p["w3_s"]
    qh, hs = _quant_act(F.silu(h1) * h3, row_max)
    del qb, h1, h3
    ho = matmul(qh, p["w2"])
    return (ho.float() * hs * p["w2_s"]).to(buf.dtype)


def route(p: dict, cfg: ModelConfig, xf: torch.Tensor):
    """Top-k routing of xf [N, d] in f32: (gate [N,k] renormalised, expert
    index [N,k] int64). Ties go to the lower expert index, as
    `jax.lax.top_k` orders them: a stable descending sort."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :cfg.top_k], idx[:, :cfg.top_k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), idx


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a batch of `n_tokens`, the reference's formula."""
    return max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def dispatch_slots(idx: torch.Tensor, C: int,
                   offset: torch.Tensor | None = None):
    """Each (token, choice) copy's rank within its expert, in token order,
    and whether it fits the capacity: (slot [N*k] int64, keep [N*k] bool).
    `offset` [E]: copies of each expert in the batch before these tokens
    (a data rank's predecessors), added to the ranks.
    The reference counts ranks with a cumulative sum of one-hots [N*k, E];
    the same ranks come from a stable sort of the copies by expert: a
    copy's place in its expert's run. That moves N*k indices instead of
    N*k*E counts (at kimi-k2's prefill the cumulative sum took 24 ms on
    an H100, PERF.md)."""
    e_flat = idx.reshape(-1)
    sorted_e, order = torch.sort(e_flat, stable=True)
    run_start = torch.searchsorted(sorted_e, sorted_e)
    rank = torch.arange(e_flat.numel(), device=idx.device) - run_start
    slot = torch.empty_like(rank).scatter_(0, order, rank)
    if offset is not None:
        slot = slot + offset[e_flat]
    return slot, slot < C


def _experts(cfg: ModelConfig, xf: torch.Tensor, gate, idx, w1, w3, w2,
             scales: dict, use_kernels: bool, C: int, offset=None,
             e0: int = 0, row_max=None) -> torch.Tensor:
    """The routed experts of tokens xf [N, d], routed to (gate, idx)
    [N, k]: rank, dispatch into [E_l, C, d] buffers of the experts
    w1/w3/w2 hold (E_l of them from expert e0 on: all E, or one rank's),
    the SwiGLU products, and the combine of those experts' copies,
    weighted by their gates. `offset` [E]: copies of each expert before
    these tokens in the batch whose capacity C is. Only the E_l experts'
    buffer rows are built. Weights that hold a slice of f give a partial
    sum; `row_max` is then W8A8's (`_quant_act`)."""
    N, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    E_l = w1.shape[0]
    slot, keep = dispatch_slots(idx, C, offset)
    # Dispatch: copy the kept copies into row e * C + slot of the flat
    # buffer; dropped copies, and copies for experts held elsewhere, go
    # to one spare row past the end, sliced off.
    e = idx.reshape(-1) - e0
    if E_l < E:
        keep = keep & (e >= 0) & (e < E_l)
    row = torch.where(keep, e * C + slot, E_l * C)
    buf = xf.new_zeros((E_l * C + 1, d))
    buf.index_copy_(0, row, xf[:, None].expand(N, k, d).reshape(N * k, d))
    buf = buf[:E_l * C].view(E_l, C, d)

    if scales:
        ho = _w8a8_ffn(dict(w1=w1, w3=w3, w2=w2, **scales), buf, use_kernels,
                       row_max)
    else:
        h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
        del buf                 # the buffers are the block's largest tensors
        ho = torch.bmm(h, w2)

    # Combine: gather each copy's result, weight by its gate.
    out_k = ho.reshape(E_l * C, d)[torch.where(keep, row, 0)]
    out_k = torch.where(keep[:, None], out_k, 0)
    return (out_k.reshape(N, k, d) * gate[..., None].to(xf.dtype)).sum(dim=1)


def _scales(p: dict, cfg: ModelConfig) -> dict:
    """The W8A8 experts' scales (w1_s, w3_s, w2_s); none for bf16 ones."""
    if not (cfg.moe_w8a8 and "w1_s" in p):
        return {}
    return {n + "_s": p[n + "_s"] for n in EXPERT_WEIGHTS}


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
    """x [B, T, d] -> [B, T, d]. On DTensors the routed experts run rank
    by rank (`_sharded_experts`) and the shared expert is DTensor
    products."""
    B, T, d = x.shape
    if is_dtensor(x):
        out = _sharded_experts(p, cfg, x, use_kernels)
        return out + mlp_apply(p["shared"], x) if "shared" in p else out
    xf = x.reshape(B * T, d)
    gate, idx = route(p, cfg, xf)
    out = _experts(cfg, xf, gate, idx, p["w1"], p["w3"], p["w2"],
                   _scales(p, cfg), use_kernels, capacity(cfg, B * T))
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xf)
    return out.reshape(B, T, d)


def _batch_offsets(idx: torch.Tensor, E: int, mesh, batch_dims: list):
    """This data rank's expert choices idx [N, k]. Returns (each expert's
    copies on the data ranks before this one, in the global batch's token
    order, [E]; the number of data ranks): the per-expert counts [E] are
    all-gathered over the mesh dims that split the batch, minor to major,
    so rank r of the batch is row r (DTensor splits a dim over several
    mesh dims major to minor)."""
    from torch.distributed import _functional_collectives as funcol
    e_flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, e_flat, torch.ones_like(e_flat))
    g, me, n = counts[None], 0, 1
    for i in reversed(batch_dims):
        g = funcol.all_gather_tensor(g, 0, (mesh, i))
        if isinstance(g, funcol.AsyncCollectiveTensor):
            g = g.wait()
        me += mesh.get_local_rank(i) * n
        n *= mesh.size(i)
    return g[:me].sum(dim=0), n


def _sharded_experts(p: dict, cfg: ModelConfig, x, use_kernels: bool):
    """The routed experts on DTensor x [B,T,d] (batch over the batch axes,
    replicated over "model"), rank by rank through `local_map`.

    Each mesh dim is read from the expert weights' placements, which the
    reference's rule sets, and no weight is gathered:
    * f split (the FSDP axes; "model" in the TP fallback, where E does not
      divide it): the tokens come to the weights. Each rank routes its own
      tokens; x and its routes are gathered there, and each rank runs its
      experts over the whole batch's copies on its slice of f: h @ w2 is
      a partial sum there. W8A8 takes the hidden rows' int8 scales from
      their maxima over all of f (an all-reduce of the row maxima), so
      its int8 activations are the unsharded run's.
    * E split over "model" (expert parallelism): x is whole there; each
      rank fills only its own experts' buffer rows and its output is a
      partial sum.
    * Weights whole over a batch dim (f does not divide the FSDP axes):
      each data rank keeps its own tokens. The capacity is the global
      batch's, as in the reference's program: each data rank counts its
      copies per expert, the counts are all-gathered over those dims, and
      a copy's slot is its rank in the whole batch's token order; a
      rank's buffers hold the global C slots, its own copies among them.
    Where x is split on the batch and the output is a partial sum, the
    output is reduce-scattered back onto the batch; it stays partial over
    "model" (the shared expert's output is too), for
    `decoder._batch_layout`."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    E = cfg.n_experts
    scales = _scales(p, cfg)
    R = Replicate()
    # per mesh dim: placements of (x, w1/w3, w2, w1_s/w3_s, w2_s), output
    xp, w13, w2p, s13, s2p, out, split = [], [], [], [], [], [], []
    f_dims, tok_dims, e0 = [], [], 0
    for i, wp in enumerate(p["w1"].placements):
        if wp.is_shard(2):
            f_dims.append(i)
            pl, o = (R, Shard(2), Shard(1), Shard(2), R), Partial()
        elif wp.is_shard(0):
            pl, o = (R, Shard(0), Shard(0), Shard(0), Shard(0)), Partial()
            e0 = mesh.get_local_rank(i) * (E // mesh.size(i))
        elif x.placements[i].is_shard(0):
            tok_dims.append(i)
            pl, o = (Shard(0), R, R, R, R), Shard(0)
        else:
            pl, o = (R,) * 5, R
        for lst, q in zip((xp, w13, w2p, s13, s2p), pl):
            lst.append(q)
        out.append(o)
        split.append(not (pl[0].is_replicate() and pl[1].is_replicate()))
    s_in = tuple(s2p if n == "w2_s" else s13 for n in scales)

    def row_max(m):
        for i in f_dims:
            if mesh.size(i) > 1:
                m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
        return m

    def route_fn(x, router):
        x = _ContiguousGrad.apply(x)
        B, T, d = x.shape
        gate, idx = route(dict(router=router), cfg, x.reshape(B * T, d))
        return gate.reshape(B, T, -1), idx.reshape(B, T, -1)
    bp = list(x.placements)
    gate, idx = _local_map(route_fn, (bp, bp), (bp, [R] * mesh.ndim), mesh,
                           [q.is_shard() for q in bp])(x, p["router"])

    def fn(x, gate, idx, w1, w3, w2, *sc):
        x = _ContiguousGrad.apply(x)
        B, T, d = x.shape
        xf, idx = x.reshape(B * T, d), idx.reshape(B * T, -1)
        offset, n_ranks = (_batch_offsets(idx, E, mesh, tok_dims)
                           if tok_dims else (None, 1))
        o = _experts(cfg, xf, gate.reshape(B * T, -1), idx, w1, w3, w2,
                     dict(zip(scales, sc)), use_kernels,
                     capacity(cfg, B * T * n_ranks), offset, e0,
                     row_max if f_dims else None)
        return o.reshape(B, T, d)
    y = _local_map(fn, (out,), (xp, xp, xp, w13, w13, w2p, *s_in), mesh,
                   split)(x, gate, idx, p["w1"], p["w3"], p["w2"],
                          *scales.values())
    back = [x.placements[i] if o.is_partial() and x.placements[i].is_shard()
            else o for i, o in enumerate(out)]
    return y if back == out else y.redistribute(mesh, back)


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Switch-style auxiliary loss (exported for a training loop)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.bincount(idx.reshape(-1), minlength=E) / idx.numel()
    return E * torch.sum(me * ce)
