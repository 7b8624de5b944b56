"""The port's configs, layers, token mixers and decoder against the JAX
package, on the same inputs and the same weights (the JAX parameter tree,
carried over by `params_from_numpy`). f32 throughout; inputs come from
numpy.

Tolerances: layers 2e-5 (one op chain in f32, summed in another order);
the smoke decoder's logits 1e-4 (two layers of such chains); the
recurrent mixers (RWKV6, Mamba2) 1e-4, outputs and every cache leaf: the
states sum up to 256 steps, taken stepwise, chunk by chunk (64 steps in
the port, the reference's CHUNK there) or in one step, in f32.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import decoder as ref_decoder  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import decoder, layers, mamba2, rwkv6  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

ATTENTION_ARCHS = ["qwen2-0.5b", "qwen2-1.5b", "qwen2-72b", "deepseek-7b"]
RECURRENT_ARCHS = ["rwkv6-7b", "zamba2-7b"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _leaves(tree, prefix="") -> dict:
    """Every array leaf of a (JAX or port) parameter or cache tree, by its
    path; None subtrees have no leaves."""
    if tree is None:
        return {}
    if isinstance(tree, (dict, tuple, list)):
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree))
        out = {}
        for k, v in items:
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().numpy()
    return np.asarray(leaf, np.float32)


def _dtype(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def _close_trees(got, want, tol: float):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in w:
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(_np(g[name]), _np(w[name]), atol=tol,
                                   rtol=tol, err_msg=name)


def _shared_params(arch, seed=0, **replace):
    """JAX init of the smoke config (with `replace`d fields), with random
    QKV biases so the bias path is exercised: (reference cfg, port cfg,
    JAX tree, port params)."""
    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    ref_cfg = dataclasses.replace(ref_cfg, **replace)
    cfg = dataclasses.replace(cfg, **replace)
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in tree["layers"].get("attn", {}):
            shape = tree["layers"]["attn"][name].shape
            tree["layers"]["attn"][name] = (
                0.1 * rng.normal(size=shape)).astype(np.float32)
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, cfg, "cpu"))


# --------------------------------------------------------------- configs

def test_config_registry_matches_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        port, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
        assert (dataclasses.asdict(port.smoke())
                == dataclasses.asdict(ref.smoke())), arch
        assert port.param_count() == ref.param_count()
        assert port.torch_dtype == getattr(torch, ref.jdtype.name)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
                                  "musicgen-medium", "internvl2-26b"])
def test_formerly_refused_configs_build(arch):
    """The MoE and io configs, refused before the port had them, build:
    `init_params` and `init_cache` give the reference's shapes."""
    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    want = _leaves(ref_decoder.init_params(jax.random.PRNGKey(0), ref_cfg))
    got = _leaves(decoder.init_params(torch.Generator().manual_seed(0), cfg))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
    want = _leaves(ref_decoder.init_cache(ref_cfg, 1, 8))
    got = _leaves(decoder.init_cache(cfg, 1, 8, "cpu"))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name


# ---------------------------------------------------------------- layers

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(scale)),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 2e-5)
    pos = np.arange(5, 14, dtype=np.int32)
    _close(layers.apply_rope(_t(x), torch.from_numpy(pos), 1e6),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 2e-5)
    _close(layers.rope_freqs(32, 1e4), ref_layers.rope_freqs(32, 1e4), 2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_chunked_attention_matches_reference(window):
    rng = np.random.default_rng(window)
    B, T, H, KV, hd = 2, 256, 4, 2, 32
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    want = ref_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(pos),
                                window=window, block_q=64, block_k=128)
    for bq, bk in ((64, 128), (100, 96)):       # the second is ragged
        got = layers.attention(_t(q), _t(k), _t(v), torch.from_numpy(pos),
                               torch.from_numpy(pos), window=window,
                               block_q=bq, block_k=bk)
        _close(got, want, 2e-5)


def _attn_case(window, S, T, pos0, seed):
    """One attention block's configs (reference, port), params, input and
    prior cache, as numpy."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").smoke(),
                                  sliding_window=window)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              sliding_window=window)
    rng = np.random.default_rng(seed)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = dict(wq=rng.normal(size=(d, H * hd)) * d ** -0.5,
             wk=rng.normal(size=(d, KV * hd)) * d ** -0.5,
             wv=rng.normal(size=(d, KV * hd)) * d ** -0.5,
             wo=rng.normal(size=(H * hd, d)) * (H * hd) ** -0.5,
             bq=0.1 * rng.normal(size=(H * hd,)),
             bk=0.1 * rng.normal(size=(KV * hd,)),
             bv=0.1 * rng.normal(size=(KV * hd,)))
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.normal(size=(2, T, d)).astype(np.float32)
    kc = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    return ref_cfg, cfg, p, x, kc, vc


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("path,window,S,T,pos0", [
    ("none", 0, 0, 24, 0),
    ("none", 8, 0, 24, 0),
    ("prefill", 0, 40, 24, 0),
    ("prefill-ring", 16, 16, 24, 0),
    ("decode", 0, 40, 1, 23),
    ("decode-window", 8, 40, 1, 23),
    ("decode-ring", 16, 16, 1, 37),
    ("decode-ring-unfilled", 16, 16, 1, 9),
])
def test_attention_apply_matches_reference(path, window, S, T, pos0,
                                           use_kernels):
    """The three cache paths of attention_apply, ring buffer included;
    `use_kernels` picks the kernels' plain versions (on CPU tensors) or
    the chunked twin."""
    ref_cfg, cfg, p, x, kc, vc = _attn_case(window, S, T, pos0, seed=S + T + pos0)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    cache_j = None if path == "none" else (jnp.asarray(kc), jnp.asarray(vc))
    cache_t = None if path == "none" else (_t(kc), _t(vc))
    want, (wk, wv) = ref_layers.attention_apply(
        jp, ref_cfg, jnp.asarray(x), cache_j, jnp.int32(pos0))
    got, (gk, gv) = layers.attention_apply(tp, cfg, _t(x), cache_t, pos0,
                                           use_kernels=use_kernels)
    _close(got, want, 2e-5)
    _close(gk, wk, 2e-5)
    _close(gv, wv, 2e-5)
    if cache_t is not None:              # updated in place
        assert gk is cache_t[0] and gv is cache_t[1]


@pytest.mark.parametrize("S,pos0,window", [
    (40, 23, 0), (40, 0, 0), (40, 23, 8), (16, 37, 16), (16, 9, 16),
    (16, 15, 16),
])
def test_decode_key_positions_match_written_slots(S, pos0, window):
    """The slot -> position map a decode step builds once for all layers:
    each slot holds the last position written to it (slot p % S in a
    ring of `window` slots, slot p otherwise), EMPTY_SLOT when none was
    or when it is out of the window."""
    ring = window > 0 and S == window
    want = np.full(S, layers.EMPTY_SLOT)
    for p in range(pos0 + 1):
        want[p % S if ring else p] = p
    if window > 0:
        want[want <= pos0 - window] = layers.EMPTY_SLOT
    got = layers.decode_key_positions(S, pos0, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- decoder

def test_smoke_decoder_logits_match_reference():
    """qwen2-0.5b smoke, JAX weights: prefill and three decode steps give
    the reference's last logits within 1e-4."""
    ref_cfg, cfg, jparams, tparams = _shared_params("qwen2-0.5b")
    rng = np.random.default_rng(1)
    B, T, n_dec = 2, 13, 3
    toks = rng.integers(0, cfg.vocab_size, size=(B, T + n_dec)).astype(np.int32)
    max_len = T + n_dec
    want, jcache = ref_decoder.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :T]),
                                       max_len=max_len)
    got, tcache = decoder.prefill(tparams, cfg,
                                  torch.from_numpy(toks[:, :T]).long(),
                                  max_len=max_len)
    _close(got, want, 1e-4)
    for t in range(T, T + n_dec):
        want, jcache = ref_decoder.decode_step(
            jparams, ref_cfg, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        got, tcache = decoder.decode_step(
            tparams, cfg, tcache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        _close(got, want, 1e-4)
    _close(tcache["layers"][0], jcache["layers"][0], 1e-4)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS + RECURRENT_ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Mirror of test_models_smoke: decoding token by token after a
    prefill reproduces one big forward pass (f32 smoke: 1e-4)."""
    cfg = get_config(arch).smoke()
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    B, S = 1, 12
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S)))
    full_logits, _ = decoder.prefill(params, cfg, toks, max_len=S + 2)
    cut = S - 3
    _, cache = decoder.prefill(params, cfg, toks[:, :cut], max_len=S + 2)
    for t in range(cut, S):
        lg, cache = decoder.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
    _close(lg[:, -1], full_logits[:, -1].numpy(), 1e-4)


def test_sliding_window_cache_ring():
    """Mirror of test_models_smoke: with window < seq, ring-buffer decode
    matches a fresh windowed forward pass."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                              sliding_window=8)
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    B, S = 1, 20
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S)))
    _, cache = decoder.prefill(params, cfg, toks[:, :-1], max_len=S)
    assert cache["layers"][0].shape[2] == 8
    lg, _ = decoder.decode_step(params, cfg, cache, toks[:, -1:], S - 1)
    full, _ = decoder.prefill(params, cfg, toks, max_len=S)
    _close(lg[:, -1], full[:, -1].numpy(), 1e-4)


def test_kernel_and_chunked_paths_agree_on_decoder():
    """`use_kernels=False` (the chunked twin) and the kernels' plain
    versions give the same decoder logits on the CPU."""
    cfg = get_config("qwen2-0.5b").smoke()
    params = decoder.init_params(torch.Generator().manual_seed(3), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 10)))
    outs = []
    for use_kernels in (True, False):
        lg, cache = decoder.prefill(params, cfg, toks, max_len=12,
                                    use_kernels=use_kernels)
        lg2, _ = decoder.decode_step(params, cfg, cache, toks[:, :1], 10,
                                     use_kernels=use_kernels)
        outs.append((lg, lg2))
    for a, b in zip(*outs, strict=True):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ------------------------------------------------- RWKV6, Mamba2, hybrid

def _mixer_case(mixer, seed):
    """One token mixer of the smoke config: (reference cfg, port cfg, JAX
    params, port params) with the JAX init's weights."""
    arch = "rwkv6-7b" if mixer == "rwkv6" else "zamba2-7b"
    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    init = (ref_rwkv6.rwkv6_params if mixer == "rwkv6"
            else ref_mamba2.mamba2_params)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), ref_cfg))
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree),
            {n: _t(a) for n, a in tree.items()})


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("mixer", ["rwkv6", "mamba2"])
def test_recurrent_mixer_matches_reference(mixer, T, use_kernels):
    """rwkv6_apply / mamba2_apply: a prefill of T tokens from no cache,
    then a decode step on the returned cache; outputs and every cache leaf
    against the reference. `use_kernels` picks the kernel op (its plain
    stepwise version on CPU tensors) or the chunked twin."""
    ref_cfg, cfg, jp, tp = _mixer_case(mixer, seed=T)
    ref_apply, apply = ((ref_rwkv6.rwkv6_apply, rwkv6.rwkv6_apply)
                        if mixer == "rwkv6"
                        else (ref_mamba2.mamba2_apply, mamba2.mamba2_apply))
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T + 1, cfg.d_model)).astype(np.float32)
    want, jcache = ref_apply(jp, ref_cfg, jnp.asarray(x[:, :T]), None)
    got, tcache = apply(tp, cfg, _t(x[:, :T]), None, use_kernels=use_kernels)
    _close(got, want, 1e-4)
    _close_trees(tcache, jcache, 1e-4)
    want, jcache = ref_apply(jp, ref_cfg, jnp.asarray(x[:, T:]), jcache)
    got, tcache = apply(tp, cfg, _t(x[:, T:]), tcache,
                        use_kernels=use_kernels)
    _close(got, want, 1e-4)
    _close_trees(tcache, jcache, 1e-4)


RECURRENT_CASES = {
    "rwkv6-7b": ("rwkv6-7b", {}),
    "zamba2-7b": ("zamba2-7b", {}),                   # 1 super-block, no tail
    "zamba2-7b-tail": ("zamba2-7b", dict(n_layers=5)),   # 2 + a tail layer
    "mamba2-stack": ("zamba2-7b", dict(attn_every=0)),   # no shared attention
}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("case", list(RECURRENT_CASES))
def test_recurrent_decoder_logits_match_reference(case, use_kernels):
    """Smoke decoders of the recurrent families, JAX weights: prefill and
    four decode steps give the reference's logits within 1e-4, and the
    final cache matches the reference's leaf by leaf."""
    arch, replace = RECURRENT_CASES[case]
    ref_cfg, cfg, jparams, tparams = _shared_params(arch, **replace)
    rng = np.random.default_rng(2)
    B, T, n_dec = 2, 13, 4
    toks = rng.integers(0, cfg.vocab_size,
                        size=(B, T + n_dec)).astype(np.int32)
    max_len = T + n_dec
    want, jcache = ref_decoder.prefill(jparams, ref_cfg,
                                       jnp.asarray(toks[:, :T]),
                                       max_len=max_len)
    got, tcache = decoder.prefill(tparams, cfg,
                                  torch.from_numpy(toks[:, :T]).long(),
                                  max_len=max_len, use_kernels=use_kernels)
    _close(got, want, 1e-4)
    for t in range(T, T + n_dec):
        want, jcache = ref_decoder.decode_step(
            jparams, ref_cfg, jcache, jnp.asarray(toks[:, t:t + 1]),
            jnp.int32(t))
        got, tcache = decoder.decode_step(
            tparams, cfg, tcache, torch.from_numpy(toks[:, t:t + 1]).long(),
            t, use_kernels=use_kernels)
        _close(got, want, 1e-4)
    _close_trees(tcache, jcache, 1e-4)


@pytest.mark.parametrize("case", list(RECURRENT_CASES))
def test_recurrent_init_matches_reference_tree(case):
    """`init_params` and `init_cache` build the reference's trees: the
    same leaves with the same shapes and dtypes, and the recurrent mixers'
    constants (decay bias, bonus, lerp, dt bias, A_log, D) equal to 1e-6:
    the reference takes log(expm1(0.01)) in f64 when another module of
    the process has turned on jax_enable_x64, one f32 ulp (2e-7) off its
    f32 value."""
    arch, replace = RECURRENT_CASES[case]
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(), **replace)
    cfg = dataclasses.replace(get_config(arch).smoke(), **replace)
    jtree = ref_decoder.init_params(jax.random.PRNGKey(0), ref_cfg)
    ttree = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    want, got = _leaves(jtree), _leaves(ttree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        if name.rsplit("/", 1)[-1] in ("w0", "u", "mu", "dt_bias", "A_log",
                                       "D", "ln1", "ln2", "ln",
                                       "final_norm"):
            np.testing.assert_allclose(_np(got[name]), _np(w), rtol=1e-6,
                                       err_msg=name)
    # The cache in bf16, where the states stay f32 and the rest follows
    # the config's dtype.
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jcache = ref_decoder.init_cache(ref_cfg, 2, 16)
    tcache = decoder.init_cache(cfg, 2, 16, "cpu")
    want, got = _leaves(jcache), _leaves(tcache)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert _dtype(got[name]) == _dtype(w), name
        assert not _np(got[name]).any(), name


def test_recurrent_kernel_and_chunked_paths_agree_on_decoder():
    """`use_kernels=False` (the chunked twins) and the scan kernels' plain
    versions give the same zamba2 and rwkv6 logits on the CPU, at a
    prompt longer than one chunk and not a multiple of it."""
    for arch in RECURRENT_ARCHS:
        cfg = get_config(arch).smoke()
        params = decoder.init_params(torch.Generator().manual_seed(3), cfg)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, size=(2, 150)))
        outs = []
        for use_kernels in (True, False):
            lg, cache = decoder.prefill(params, cfg, toks, max_len=152,
                                        use_kernels=use_kernels)
            lg2, _ = decoder.decode_step(params, cfg, cache, toks[:, :1],
                                         150, use_kernels=use_kernels)
            outs.append((lg, lg2))
        for a, b in zip(*outs, strict=True):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
