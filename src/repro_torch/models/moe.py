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

The reference's sharding hint `cfg.moe_expert_shard_constraint`
(`with_sharding_constraint` of the dispatch buffers to the `model` axis)
does nothing without a device mesh, and here nothing at all: on DTensor
activations `moe_apply` raises NotImplementedError until the MoE runs
under a mesh (ROADMAP item 9c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import refuse_dtensor
from ..kernels.int8_grouped_matmul.ops import int8_grouped_matmul
from ..kernels.int8_grouped_matmul.ref import int8_grouped_matmul_ref
from .config import ModelConfig
from .layers import mlp_apply

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
    (see the module note). `normal(shape, fan_in)` and
    `full(value, shape)` are the decoder's drawing functions (the MoE tree
    has no constant leaves, so `full` goes unused)."""
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
        for i in range(n):
            for e in range(E):
                q[i, e], s[i, e] = quantize_weight(normal((d_in, d_out),
                                                          d_in))
        p[name], p[name + "_s"] = q, s
    if cfg.shared_expert_ff:
        sf = cfg.shared_expert_ff
        p["shared"] = dict(w1=normal((n, d, sf), d), w3=normal((n, d, sf), d),
                           w2=normal((n, sf, d), sf))
    return p


def _quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantisation of activations."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-9)).to(torch.int8)
    return q, scale


def _w8a8_ffn(p: dict, buf: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
    """Expert SwiGLU with int8 x int8 -> int32 products (W8A8): buf [E,C,d]
    -> [E,C,d] in buf's dtype. `use_kernels` picks the grouped int8 GEMM
    op (its plain version on CPU tensors) or the plain version; the two
    are equal bit for bit."""
    matmul = int8_grouped_matmul if use_kernels else int8_grouped_matmul_ref
    qb, bs = _quant_act(buf)                                # [E,C,d], [E,C,1]
    h1 = matmul(qb, p["w1"]).float() * bs * p["w1_s"]
    h3 = matmul(qb, p["w3"]).float() * bs * p["w3_s"]
    qh, hs = _quant_act(F.silu(h1) * h3)
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


def dispatch_slots(idx: torch.Tensor, C: int):
    """Each (token, choice) copy's rank within its expert, in token order,
    and whether it fits the capacity: (slot [N*k] int64, keep [N*k] bool).
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
    return slot, slot < C


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              use_kernels: bool = True) -> torch.Tensor:
    """x [B, T, d] -> [B, T, d]."""
    refuse_dtensor("the MoE channel mixer", x)
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * T
    xf = x.reshape(N, d)
    gate, idx = route(p, cfg, xf)
    C = capacity(cfg, N)
    slot, keep = dispatch_slots(idx, C)
    # Dispatch: copy the kept copies into row e * C + slot of the flat
    # buffer; dropped copies go to one spare row past the end, sliced off.
    row = torch.where(keep, idx.reshape(-1) * C + slot, E * C)
    buf = x.new_zeros((E * C + 1, d))
    buf.index_copy_(0, row, xf[:, None].expand(N, k, d).reshape(N * k, d))
    buf = buf[:E * C].view(E, C, d)

    if cfg.moe_w8a8 and "w1_s" in p:
        ho = _w8a8_ffn(p, buf, use_kernels)
    else:
        h = F.silu(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
        del buf                 # the buffers are the block's largest tensors
        ho = torch.bmm(h, p["w2"])

    # Combine: gather each copy's result, weight by its gate.
    out_k = ho.reshape(E * C, d)[torch.where(keep, row, 0)]
    out_k = torch.where(keep[:, None], out_k, 0)
    out = (out_k.reshape(N, k, d) * gate[..., None].to(x.dtype)).sum(dim=1)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xf)
    return out.reshape(B, T, d)


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Switch-style auxiliary loss (exported for a training loop)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.bincount(idx.reshape(-1), minlength=E) / idx.numel()
    return E * torch.sum(me * ce)
