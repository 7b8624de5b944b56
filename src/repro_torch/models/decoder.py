"""Composable decoder on torch tensors: dense GQA attention, RWKV6, Mamba2
and the Mamba2 + shared-attention hybrid (zamba2) token mixers; a dense
SwiGLU or a Mixture-of-Experts channel mixer (`moe.py`); one vocabulary or
several codebooks (musicgen: embeddings summed over the codebooks, one head
each), and prefix embeddings (a vlm or audio frontend's, projected and put
before the tokens).

Parameters are a dict with the reference's tree and layout: weights are
`x @ W` with W [d_in, d_out], and every per-layer tensor is stacked on
axis 0 under `params["layers"]`. The hybrid stacks its n_super *
attn_every Mamba2 layers under `layers`, the remaining ones under `tail`,
and holds the one shared attention block under `shared_attn`. The layer
stack runs as a Python loop where the reference scans; the cache (KV
cache, recurrent states) is updated in place.

Public entry points:
    init_params(gen, cfg)
    param_tree(cfg, normal, full)                    # the tree, any leaves
    init_cache(cfg, B, max_len, device)
    prefill(params, cfg, tokens[, prefix], max_len)  # -> (last_logits, cache)
    decode_step(params, cfg, cache, tokens, pos)     # -> (logits, cache)
    train_loss(params, cfg, batch)                   # -> mean next-token NLL

Training runs a cache-free layer stack; with `cfg.remat` each layer (each
super-block in the hybrid) is checkpointed, as the reference's
`jax.checkpoint`, so its activations are recomputed in the backward.

Sharded: the three entry points take parameters made DTensors by
`parallel.sharding.distribute_params`, for every family. `prefill`
places its cache by `cache_specs`, each rank looks up embeddings on its
slice of the table and they come out placed by `batch_spec`
(`layers.vocab_parallel_embed`), the tensors a step builds (positions)
enter as replicated DTensors, each mixer's output enters the residual
stream in that batch layout (`_batch_layout`), and the kernels run on
local shards: the attention kernels (`layers.py`), the RWKV6 and Mamba2
recurrences on each rank's heads (`rwkv6.py`, `mamba2.py`), the MoE's
experts on each rank's experts (`moe.py`). Each layer's new recurrent
state is placed as its cache before it is written there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor
from ..parallel.sharding import batch_spec, distribute_cache, to_placements
from .config import ModelConfig
from .layers import (attention_apply, chunked_ce_loss, decode_key_positions,
                     mlp_apply, replicated_like, rms_norm,
                     vocab_parallel_embed)
from .mamba2 import mamba2_apply, mamba2_cache_init, mamba2_params
from .moe import moe_apply, moe_params
from .rwkv6 import rwkv6_apply, rwkv6_cache_init, rwkv6_params

TOKEN_MIXERS = ("attention", "mamba2", "rwkv6")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this decoder does not run yet."""
    missing = [what for what, used in (
        (f"token mixer {cfg.token_mixer!r}",
         cfg.token_mixer not in TOKEN_MIXERS),
        ("shared attention over a non-mamba2 stack",
         bool(cfg.attn_every) and cfg.token_mixer != "mamba2")) if used]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not run {', '.join(missing)} yet")


def _hybrid_shape(cfg: ModelConfig) -> tuple[int, int]:
    """(#super-blocks, #tail mamba layers) of an attn_every hybrid."""
    n_super = cfg.n_layers // cfg.attn_every
    return n_super, cfg.n_layers - n_super * cfg.attn_every


# ---------------------------------------------------------------------------
# Parameters and cache
# ---------------------------------------------------------------------------

def _attn_params(normal, cfg: ModelConfig, stacked: int | None) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = () if stacked is None else (stacked,)
    p = dict(wq=normal((*lead, d, H * hd), d),
             wk=normal((*lead, d, KV * hd), d),
             wv=normal((*lead, d, KV * hd), d),
             wo=normal((*lead, H * hd, d), H * hd))
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((*lead, width), dtype=cfg.torch_dtype,
                                  device=p["wq"].device)
    return p


def _layer_params(normal, full, cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    p = dict(ln1=full(1.0, (n, d)), ln2=full(1.0, (n, d)))
    if cfg.token_mixer == "attention":
        p["attn"] = _attn_params(normal, cfg, n)
    elif cfg.token_mixer == "mamba2":
        p["mamba"] = mamba2_params(normal, full, cfg, n)
    else:
        p["rwkv"] = rwkv6_params(normal, full, cfg, n)
    if cfg.n_experts:
        p["moe"] = moe_params(normal, full, cfg, n)
    else:
        p["mlp"] = dict(w1=normal((n, d, cfg.d_ff), d),
                        w3=normal((n, d, cfg.d_ff), d),
                        w2=normal((n, cfg.d_ff, d), cfg.d_ff))
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights drawn from `gen` on its device: normal / sqrt(fan_in)
    in f32, cast to the config's dtype; norms are f32 ones, the QKV biases
    zeros and the recurrent mixers' constants the reference's (whose
    numbers differ: another generator). A stacked weight is drawn one
    matrix at a time (one layer's, or one layer's expert's), so no f32
    copy of a whole stack is ever held."""
    dev, dt = gen.device, cfg.torch_dtype

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out.view(-1, *shape[-2:]) if len(shape) > 2 else (out,)):
            w = torch.randn(part.shape, generator=gen, device=dev,
                            dtype=torch.float32)
            part.copy_(w * fan_in ** -0.5)
        return out

    def full(value, shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return param_tree(cfg, normal, full)


def param_tree(cfg: ModelConfig, normal, full) -> dict:
    """The reference's parameter tree, its leaves made by `normal(shape,
    fan_in)` (weights, in the config's dtype) and `full(value, shape)`
    (the f32 constants); `init_params` draws them, `launch.specs` makes
    them on the meta device."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    params = dict(embed=normal((*nq, V, d), d), head=normal((*nq, d, V), d),
                  final_norm=full(1.0, (d,)))
    if cfg.attn_every:
        n_super, tail = _hybrid_shape(cfg)
        params["layers"] = _layer_params(normal, full, cfg,
                                         n_super * cfg.attn_every)
        if tail:
            params["tail"] = _layer_params(normal, full, cfg, tail)
        params["shared_attn"] = dict(attn=_attn_params(normal, cfg, None),
                                     ln=full(1.0, (d,)))
    else:
        params["layers"] = _layer_params(normal, full, cfg, cfg.n_layers)
    if cfg.n_prefix_embeds:
        params["prefix_proj"] = normal((d, d), d)
    return params


def _stacked_zeros(tree: dict, lead: tuple[int, ...]) -> dict:
    return {k: torch.zeros((*lead, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device: torch.device | str) -> dict:
    """The reference's cache tree, zeroed, per layer stacked on axis 0:
    - attention: dict(layers=(k, v)), each [n_layers, B, S, KV, hd], S =
      max_len (a ring of `sliding_window` slots when that is shorter);
    - rwkv6: dict(layers=dict(state [n,B,H,64,64] f32, xprev [n,B,d] f32));
    - mamba2: dict(layers=dict(ssm [n,B,nh,hp,N] f32, conv [n,B,W-1,di]));
    - hybrid: dict(mamba=<mamba2 leaves on [n_super, attn_every]>,
      attn=(k, v) [n_super, B, S, KV, hd], one slot per shared-attention
      invocation, tail=<mamba2 leaves on [tail]> or None)."""
    check_supported(cfg)
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dt = cfg.torch_dtype

    def attn_cache(n):
        shape = (n, B, S, cfg.n_kv_heads, cfg.hd)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    if cfg.token_mixer == "attention":
        return dict(layers=attn_cache(cfg.n_layers))
    if cfg.token_mixer == "rwkv6":
        return dict(layers=_stacked_zeros(rwkv6_cache_init(cfg, B, device),
                                          (cfg.n_layers,)))
    m = mamba2_cache_init(cfg, B, dt, device)
    if not cfg.attn_every:
        return dict(layers=_stacked_zeros(m, (cfg.n_layers,)))
    n_super, tail = _hybrid_shape(cfg)
    return dict(mamba=_stacked_zeros(m, (n_super, cfg.attn_every)),
                attn=attn_cache(n_super),
                tail=_stacked_zeros(m, (tail,)) if tail else None)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer(tree: dict, i: int) -> dict:
    """Layer i's parameters (or cache): views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else _stack(v)[i]
            for k, v in tree.items()}


def _stack(t: torch.Tensor) -> torch.Tensor:
    """A stacked tensor whose layer dim may be indexed: a DTensor split on
    it (the rules put "model" there on a MoE's shared expert when the
    layer count divides it, as the reference's do) is gathered on it."""
    if not (is_dtensor(t) and any(p.is_shard(0) for p in t.placements)):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(0) else p
                                          for p in t.placements])


def _gather_stacks(params: dict) -> dict:
    """The parameters with the leaves of their layer stacks ("layers" and
    the hybrid's "tail") gathered on the layer dim by `_stack`: once per
    step, where `_layer` alone would gather a split stack once per layer."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t if t is None else _stack(t)
    return {k: walk(v) if k in ("layers", "tail") else v
            for k, v in params.items()}


def _channel_mix(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    h = rms_norm(x, lp["ln2"])
    if cfg.n_experts:
        return x + _batch_layout(moe_apply(lp["moe"], cfg, h, use_kernels))
    return x + _batch_layout(mlp_apply(lp["mlp"], h))


def _layer_body(lp: dict, cfg: ModelConfig, x: torch.Tensor, cache_l,
                pos0: int, use_kernels: bool,
                k_pos: torch.Tensor | None) -> torch.Tensor:
    """One layer: token mixer, then the channel mixer (SwiGLU or MoE). The
    token mixer's new cache (keys/values, or the recurrent states) is
    written into `cache_l` in place."""
    h = rms_norm(x, lp["ln1"])
    if cfg.token_mixer == "attention":
        out, _ = attention_apply(lp["attn"], cfg, h, cache_l, pos0,
                                 use_kernels=use_kernels, k_pos=k_pos)
    else:
        if cfg.token_mixer == "mamba2":
            out, new = mamba2_apply(lp["mamba"], cfg, h, cache_l, use_kernels)
        else:
            out, new = rwkv6_apply(lp["rwkv"], cfg, h, cache_l, use_kernels)
        for name, t in new.items():
            c = cache_l[name]
            if is_dtensor(c) and tuple(t.placements) != tuple(c.placements):
                t = t.redistribute(c.device_mesh, c.placements)
            c.copy_(t)
    return _channel_mix(lp, cfg, x + _batch_layout(out), use_kernels)


def _run_hybrid(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, pos0: int, use_kernels: bool,
                k_pos: torch.Tensor | None) -> torch.Tensor:
    """Super-blocks of attn_every Mamba2 layers, each followed by the one
    shared attention block (its own KV slot per invocation), then the
    tail Mamba2 layers."""
    n_super, tail = _hybrid_shape(cfg)
    sa = params["shared_attn"]
    kc, vc = cache["attn"]
    for g in range(n_super):
        group = _layer(cache["mamba"], g)
        for e in range(cfg.attn_every):
            x = _layer_body(_layer(params["layers"], g * cfg.attn_every + e),
                            cfg, x, _layer(group, e), pos0, use_kernels,
                            None)
        out, _ = attention_apply(sa["attn"], cfg, rms_norm(x, sa["ln"]),
                                 (kc[g], vc[g]), pos0,
                                 use_kernels=use_kernels, k_pos=k_pos)
        x = x + _batch_layout(out)
    for e in range(tail):
        x = _layer_body(_layer(params["tail"], e), cfg, x,
                        _layer(cache["tail"], e), pos0, use_kernels, None)
    return x


def _run_layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, pos0: int, use_kernels: bool) -> torch.Tensor:
    """The layer stack; writes each layer's cache in place."""
    attn = (cache["attn"] if cfg.attn_every else
            cache["layers"] if cfg.token_mixer == "attention" else None)
    # A decode step's slot -> position map is built once for all layers.
    k_pos = (decode_key_positions(attn[0].shape[2], pos0, cfg.sliding_window,
                                  x.device)
             if attn is not None and x.shape[1] == 1 else None)
    params = _gather_stacks(params)
    if cfg.attn_every:
        return _run_hybrid(params, cfg, x, cache, pos0, use_kernels, k_pos)
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        cache_l = ((layers[0][i], layers[1][i]) if attn is not None
                   else _layer(layers, i))
        x = _layer_body(_layer(params["layers"], i), cfg, x, cache_l, pos0,
                        use_kernels, k_pos)
    return x


# ---------------------------------------------------------------------------
# Training: the cache-free layer stack
# ---------------------------------------------------------------------------

def _unstack(tree: dict, n: int) -> list[dict]:
    """The n layers' parameter dicts, from one `unbind(0)` of each stacked
    leaf: their backward is one `stack`, where indexing layer by layer
    would add each layer's gradient into a zero tensor the size of the
    whole stack."""
    cols = {k: _unstack(v, n) if isinstance(v, dict) else _stack(v).unbind(0)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _train_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    """One layer with no cache: token mixer, then channel mixer."""
    h = rms_norm(x, lp["ln1"])
    if cfg.token_mixer == "attention":
        out, _ = attention_apply(lp["attn"], cfg, h, None, 0,
                                 use_kernels=use_kernels)
    elif cfg.token_mixer == "mamba2":
        out, _ = mamba2_apply(lp["mamba"], cfg, h, None, use_kernels)
    else:
        out, _ = rwkv6_apply(lp["rwkv"], cfg, h, None, use_kernels)
    return _channel_mix(lp, cfg, x + _batch_layout(out), use_kernels)


def _train_super_block(group: list[dict], sa: dict, cfg: ModelConfig,
                       x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """attn_every Mamba2 layers, then the shared attention block."""
    for lp in group:
        x = _train_layer(lp, cfg, x, use_kernels)
    out, _ = attention_apply(sa["attn"], cfg, rms_norm(x, sa["ln"]), None, 0,
                             use_kernels=use_kernels)
    return x + _batch_layout(out)


def _remat(fn, *args):
    """fn(*args), checkpointed when autograd is recording."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _train_layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  use_kernels: bool) -> torch.Tensor:
    """The layer stack without a cache, as the reference's
    `_scan_layers(..., None, ...)`: with `cfg.remat` each layer (each
    super-block of the hybrid; its tail layers are not) is recomputed in
    the backward."""
    run = _remat if cfg.remat else (lambda fn, *a: fn(*a))
    if not cfg.attn_every:
        for lp in _unstack(params["layers"], cfg.n_layers):
            x = run(_train_layer, lp, cfg, x, use_kernels)
        return x
    n_super, tail = _hybrid_shape(cfg)
    E = cfg.attn_every
    layers = _unstack(params["layers"], n_super * E)
    for g in range(n_super):
        x = run(_train_super_block, layers[g * E:(g + 1) * E],
                params["shared_attn"], cfg, x, use_kernels)
    for lp in (_unstack(params["tail"], tail) if tail else ()):
        x = _train_layer(lp, cfg, x, use_kernels)
    return x


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for what `train_loss` cannot differentiate: int8 expert
    weights, on every device and path (the reference's `jax.grad` refuses
    integer leaves too). Every other config passes: on CUDA with the
    kernels the attention layers run the flash backward kernel and the
    recurrent mixers (rwkv6, mamba2, the zamba2 hybrid) the scans'
    backward kernels. What has trained on an H100 (`chip_smoke.py`):
    qwen2-0.5b whole, rwkv6-7b (4 layers), zamba2-7b (7), llama4-scout
    (1 layer, its vocabulary cut to 32,768), internvl2-26b (4 layers,
    with its prefix) and musicgen-medium whole (prefix and codebooks).
    kimi-k2 and the dense deepseek-7b, qwen2-1.5b and qwen2-72b have
    trained only on the CPU at smoke size."""
    if cfg.moe_w8a8:
        raise NotImplementedError(
            f"{cfg.name} with moe_w8a8: int8 expert weights are not "
            f"trainable")


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           prefix: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings [B, T, d], after the projected prefix when one is
    given. Codebook tokens [B, T, nq] sum their embeddings in the model's
    dtype, in the reference's order ((0 + e0) + e1) + ... On a DTensor
    table each rank looks up on its own slice of the table
    (`layers.vocab_parallel_embed`) and projects its own prefix rows; the
    result is in the batch layout."""
    table = params["embed"]
    if is_dtensor(table):
        x = vocab_parallel_embed(table, tokens)
    elif cfg.n_codebooks:
        x = sum(F.embedding(tokens[..., q], table[q])
                for q in range(cfg.n_codebooks))
    else:
        x = F.embedding(tokens, table)
    if prefix is not None:
        pre = _batch_layout(replicated_like(prefix, table))
        pre = _batch_layout(pre.to(x.dtype) @ params["prefix_proj"])
        x = torch.cat([pre, x], dim=1)
    return x


def _batch_layout(x: torch.Tensor) -> torch.Tensor:
    """DTensor activations [B, ...] with the batch over the batch axes
    where it divides (`batch_spec`, as the reference places its tokens),
    replicated on every other mesh dim, and their gradient placed so too;
    plain tensors as they are. A mixer's output (a partial sum over
    "model" after a row-parallel product) is put so before it joins the
    residual stream, which then stays replicated over "model" both ways:
    a partial residual, or a partial gradient of one, would reach the next
    product, whose cheapest DTensor strategy then gathers the batch."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return _BatchLayout.apply(x, to_placements(batch_spec(mesh, x.shape),
                                               mesh))


class _BatchLayout(torch.autograd.Function):
    """x.redistribute(mesh, pl), whose backward redistributes the gradient
    to pl too (DTensor's own would hand it back partial)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The served logits [B, T, V] (or [B, T, nq, V]). On DTensors they
    come out as the reference's program returns them: B over the batch
    axes where it divides, V over "model" where the head splits it, and
    replicated elsewhere; the head stays where it is: a step's few
    positions move (gathered over the FSDP axes, the partial logits
    reduce-scattered onto the batch), not the head. A DTensor's codebook
    heads are products one by one: DTensor's einsum strategy would move
    the head to split d over "model"."""
    h = rms_norm(h, params["final_norm"])
    if not is_dtensor(h):
        if cfg.n_codebooks:
            return torch.einsum("btd,qdv->btqv", h, params["head"])
        return h @ params["head"]
    if cfg.n_codebooks:
        out = torch.stack([h @ w for w in params["head"].unbind(0)], dim=2)
    else:
        out = h @ params["head"]
    from torch.distributed.tensor import Replicate
    mesh = out.device_mesh
    pl = [b if b.is_shard() else Replicate() if p.is_partial() else p
          for b, p in zip(to_placements(batch_spec(mesh, out.shape), mesh),
                          out.placements)]
    return out if pl == list(out.placements) else out.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            prefix: torch.Tensor | None = None, max_len: int | None = None,
            *, use_kernels: bool = True):
    """Process the prompt: tokens [B, T] (codebook tokens [B, T, nq]) after
    an optional prefix of embeddings [B, P, d_model], which takes cache
    positions 0..P-1. Returns (last-position logits [B, 1, V] or
    [B, 1, nq, V], filled cache)."""
    B = tokens.shape[0]
    T = tokens.shape[1] + (0 if prefix is None else prefix.shape[1])
    cache = init_cache(cfg, B, max_len or T, tokens.device)
    if is_dtensor(params["embed"]):
        cache = distribute_cache(cache, params["embed"].device_mesh)
    x = _batch_layout(_embed(params, cfg, tokens, prefix))
    h = _run_layers(params, cfg, x, cache, 0, use_kernels)
    return _logits(params, cfg, h[:, -1:]), cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int, use_kernels: bool = True):
    """One autoregressive step. tokens: [B, 1] (or [B, 1, nq]); pos: the
    number of positions already in the cache (prefix included). Updates
    `cache` in place and returns (logits [B, 1, V] or [B, 1, nq, V],
    cache)."""
    x = _batch_layout(_embed(params, cfg, tokens, None))
    h = _run_layers(params, cfg, x, cache, int(pos), use_kernels)
    return _logits(params, cfg, h), cache


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               use_kernels: bool = True) -> torch.Tensor:
    """Next-token cross-entropy (f32 scalar, a plain tensor on every rank
    when the parameters are DTensors, whose gradients are then DTensors:
    `full_tensor()` gives one whole). batch: tokens [B,S] (or [B,S,nq]),
    targets the same shape, optional prefix [B,P,d_model] whose rows are
    dropped before the loss; codebook configs average one CE per
    codebook."""
    tokens = batch["tokens"]
    check_trainable(cfg)
    prefix = batch.get("prefix")
    x = _batch_layout(_embed(params, cfg, tokens, prefix))
    h = _train_layers(params, cfg, x, use_kernels)
    h = rms_norm(h, params["final_norm"])
    P = 0 if prefix is None else prefix.shape[1]
    h = h[:, P:]
    if cfg.n_codebooks:
        heads = params["head"].unbind(0)
        losses = [chunked_ce_loss(heads[q], h, batch["targets"][..., q],
                                  cfg.loss_chunk)
                  for q in range(cfg.n_codebooks)]
        loss = torch.mean(torch.stack(losses))
    else:
        loss = chunked_ce_loss(params["head"], h, batch["targets"],
                               cfg.loss_chunk)
    # sharded: the whole loss on every rank, a plain scalar to step on
    return loss.full_tensor() if is_dtensor(loss) else loss
