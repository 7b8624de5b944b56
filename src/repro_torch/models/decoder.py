"""Dense GQA decoder (`token_mixer="attention"`, one vocabulary, no prefix
embeddings, no MoE), on torch tensors.

Parameters are a dict with the reference's tree and layout: weights are
`x @ W` with W [d_in, d_out], and every per-layer tensor is stacked on
axis 0 under `params["layers"]`. The layer stack runs as a Python loop
where the reference scans.

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


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this decoder does not run yet."""
    missing = [what for what, used in (
        (f"token mixer {cfg.token_mixer!r}", cfg.token_mixer != "attention"),
        ("hybrid shared attention", bool(cfg.attn_every)),
        ("MoE", bool(cfg.n_experts)),
        ("multi-codebook io", bool(cfg.n_codebooks)),
        ("prefix embeddings", bool(cfg.n_prefix_embeds))) if used]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not run {', '.join(missing)} yet")


# ---------------------------------------------------------------------------
# Parameters and cache
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights drawn from `gen` on its device: normal / sqrt(fan_in)
    in f32, cast to the config's dtype; norms are f32 ones and the QKV
    biases zeros, as in the reference (whose numbers differ: another
    generator)."""
    check_supported(cfg)
    dev, dt = gen.device, cfg.torch_dtype
    d, H, KV, hd, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.n_layers)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dt)

    attn = dict(wq=normal((n, d, H * hd), d), wk=normal((n, d, KV * hd), d),
                wv=normal((n, d, KV * hd), d),
                wo=normal((n, H * hd, d), H * hd))
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            attn[name] = torch.zeros((n, width), dtype=dt, device=dev)
    mlp = dict(w1=normal((n, d, cfg.d_ff), d), w3=normal((n, d, cfg.d_ff), d),
               w2=normal((n, cfg.d_ff, d), cfg.d_ff))
    ones = dict(dtype=torch.float32, device=dev)
    return dict(
        embed=normal((cfg.vocab_size, d), d),
        head=normal((d, cfg.vocab_size), d),
        final_norm=torch.ones((d,), **ones),
        layers=dict(ln1=torch.ones((n, d), **ones),
                    ln2=torch.ones((n, d), **ones), attn=attn, mlp=mlp))


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device: torch.device | str) -> dict:
    """KV cache sized for `max_len` total positions (a ring of
    `sliding_window` slots when that is shorter): per layer stacked on
    axis 0, [n_layers, B, S, KV, hd] for keys and for values."""
    check_supported(cfg)
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    return dict(layers=(
        torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        torch.zeros(shape, dtype=cfg.torch_dtype, device=device)))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer(tree: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, pos0: int, use_kernels: bool) -> torch.Tensor:
    """The layer stack; writes each layer's keys/values into `cache`."""
    kc, vc = cache["layers"]
    # A decode step's slot -> position map is built once for all layers.
    k_pos = (decode_key_positions(kc.shape[2], pos0, cfg.sliding_window,
                                  x.device) if x.shape[1] == 1 else None)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln1"])
        out, _ = attention_apply(lp["attn"], cfg, h, (kc[i], vc[i]), pos0,
                                 use_kernels=use_kernels, k_pos=k_pos)
        x = x + out
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]))
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
