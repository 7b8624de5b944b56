"""Composable decoder on torch tensors: dense GQA attention, RWKV6, Mamba2
and the Mamba2 + shared-attention hybrid (zamba2), with one vocabulary and
no prefix embeddings or MoE.

Parameters are a dict with the reference's tree and layout: weights are
`x @ W` with W [d_in, d_out], and every per-layer tensor is stacked on
axis 0 under `params["layers"]`. The hybrid stacks its n_super *
attn_every Mamba2 layers under `layers`, the remaining ones under `tail`,
and holds the one shared attention block under `shared_attn`. The layer
stack runs as a Python loop where the reference scans; the cache (KV
cache, recurrent states) is updated in place.

Public entry points:
    init_params(gen, cfg)
    init_cache(cfg, B, max_len, device)
    prefill(params, cfg, tokens, max_len)          # -> (last_logits, cache)
    decode_step(params, cfg, cache, tokens, pos)   # -> (logits, cache)
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (attention_apply, decode_key_positions, mlp_apply,
                     rms_norm)
from .mamba2 import mamba2_apply, mamba2_cache_init, mamba2_params
from .rwkv6 import rwkv6_apply, rwkv6_cache_init, rwkv6_params

TOKEN_MIXERS = ("attention", "mamba2", "rwkv6")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this decoder does not run yet."""
    missing = [what for what, used in (
        (f"token mixer {cfg.token_mixer!r}",
         cfg.token_mixer not in TOKEN_MIXERS),
        ("shared attention over a non-mamba2 stack",
         bool(cfg.attn_every) and cfg.token_mixer != "mamba2"),
        ("MoE", bool(cfg.n_experts)),
        ("multi-codebook io", bool(cfg.n_codebooks)),
        ("prefix embeddings", bool(cfg.n_prefix_embeds))) if used]
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
    p["mlp"] = dict(w1=normal((n, d, cfg.d_ff), d),
                    w3=normal((n, d, cfg.d_ff), d),
                    w2=normal((n, cfg.d_ff, d), cfg.d_ff))
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights drawn from `gen` on its device: normal / sqrt(fan_in)
    in f32, cast to the config's dtype; norms are f32 ones, the QKV biases
    zeros and the recurrent mixers' constants the reference's (whose
    numbers differ: another generator). A stacked weight is drawn one
    layer at a time, so no full-depth f32 copy is ever held."""
    check_supported(cfg)
    dev, dt = gen.device, cfg.torch_dtype

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out if len(shape) == 3 else (out,)):
            w = torch.randn(part.shape, generator=gen, device=dev,
                            dtype=torch.float32)
            part.copy_(w * fan_in ** -0.5)
        return out

    def full(value, shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    d = cfg.d_model
    params = dict(embed=normal((cfg.vocab_size, d), d),
                  head=normal((d, cfg.vocab_size), d),
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
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layer_body(lp: dict, cfg: ModelConfig, x: torch.Tensor, cache_l,
                pos0: int, use_kernels: bool,
                k_pos: torch.Tensor | None) -> torch.Tensor:
    """One layer: token mixer, then the SwiGLU channel mixer. The mixer's
    new cache (keys/values, or the recurrent states) is written into
    `cache_l` in place."""
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
            cache_l[name].copy_(t)
    x = x + out
    return x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]))


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
        x = x + out
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
    if cfg.attn_every:
        return _run_hybrid(params, cfg, x, cache, pos0, use_kernels, k_pos)
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        cache_l = ((layers[0][i], layers[1][i]) if attn is not None
                   else _layer(layers, i))
        x = _layer_body(_layer(params["layers"], i), cfg, x, cache_l, pos0,
                        use_kernels, k_pos)
    return x


def _embed(params: dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return rms_norm(h, params["final_norm"]) @ params["head"]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, use_kernels: bool = True):
    """Process the prompt tokens [B, T]; return (last-position logits
    [B, 1, V], filled cache)."""
    B, T = tokens.shape
    cache = init_cache(cfg, B, max_len or T, tokens.device)
    x = _embed(params, cfg, tokens)
    h = _run_layers(params, cfg, x, cache, 0, use_kernels)
    return _logits(params, cfg, h[:, -1:]), cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int, use_kernels: bool = True):
    """One autoregressive step. tokens: [B, 1]; pos: the number of
    positions already in the cache. Updates `cache` in place and returns
    (logits [B, 1, V], cache)."""
    x = _embed(params, cfg, tokens)
    h = _run_layers(params, cfg, x, cache, int(pos), use_kernels)
    return _logits(params, cfg, h), cache
