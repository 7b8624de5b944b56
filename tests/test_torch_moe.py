"""The port's MoE channel mixer, W8A8 experts and io variants (codebooks,
prefix embeddings) against the JAX package, on the same inputs (numpy, from
a seed) and the same weights (the JAX parameter tree, carried over by
`params_from_numpy`). f32 smoke configs on the CPU.

Tolerances: `moe_apply` 2e-5 (the same f32 op chains, summed in another
order); routes, slots, drops, the int8 weights, their scales and the int32
products bitwise (integer or exactly rounded arithmetic); the W8A8 module
within one step of its second activation quantisation (an ulp of silu can
move h / scale across a rounding boundary); `load_balance_loss` 1e-6; the
smoke decoders' logits and caches 1e-4, as in tests/test_torch_models.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import decoder as ref_decoder  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels.int8_grouped_matmul.ops import \
    int8_grouped_matmul  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decoder, moe  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"]
IO_ARCHS = ["internvl2-26b", "musicgen-medium"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, tol: float):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _leaves(tree, prefix="") -> dict:
    if tree is None:
        return {}
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _dtype(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def _cfgs(arch, **replace):
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(), **replace)
    cfg = dataclasses.replace(get_config(arch).smoke(), **replace)
    return ref_cfg, cfg


def _moe_case(arch, seed=0, **replace):
    """(reference cfg, port cfg, JAX MoE params, port MoE params) of one
    unstacked MoE block of the smoke config, the JAX init's weights."""
    ref_cfg, cfg = _cfgs(arch, **replace)
    tree = jax.tree.map(np.asarray, ref_moe.moe_params(
        jax.random.PRNGKey(seed), ref_cfg))
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, cfg, "cpu"))


def _x(cfg, B=2, T=32, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, T, cfg.d_model))
            * scale).astype(np.float32)


def _ref_routes(jp, ref_cfg, x):
    """The reference moe_apply's routing lines (moe.py:84-95) on x."""
    E, k = ref_cfg.n_experts, ref_cfg.top_k
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.clip(gate.sum(-1, keepdims=True), 1e-9)
    N = xf.shape[0]
    C = max(1, int(N * k * ref_cfg.capacity_factor / E))
    e_flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos, e_flat[:, None], axis=1)[:, 0]
    return (np.asarray(gate), np.asarray(idx), C, np.asarray(slot),
            np.asarray(slot < C))


# ------------------------------------------------------------ moe_apply

@pytest.mark.parametrize("router", ["random", "zero", "tied-columns"])
@pytest.mark.parametrize("full_capacity", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, full_capacity, router):
    """kimi-k2 smoke (4 experts, top-2, a shared expert) and llama4-scout
    smoke (top-1): at the default capacity factor 1.25, where copies drop
    (28 tokens of each sequence repeat its second, so that token's
    experts overflow), and at n_experts, where none does; with a random router, a
    zero one (every probability tied) and one whose expert 2 ties expert 0
    on every token. Top-k indices, slots and drops are the reference's
    exactly; the output within 2e-5."""
    replace = ({"capacity_factor": 4.0} if full_capacity else {})
    ref_cfg, cfg, jp, tp = _moe_case(arch, **replace)
    if router != "random":
        r = np.array(jp["router"])
        if router == "zero":
            r[:] = 0.0
        else:
            r[:, 2] = r[:, 0]
        jp = dict(jp, router=jnp.asarray(r))
        tp = dict(tp, router=_t(r))
    x = _x(cfg)
    x[:, 2:30] = x[:, 1:2]
    gate, idx, C, slot, keep = _ref_routes(jp, ref_cfg, x)
    tgate, tidx = moe.route(tp, cfg, _t(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(tidx.numpy(), idx)
    _close(tgate, gate, 2e-5)
    assert moe.capacity(cfg, x.shape[0] * x.shape[1]) == C
    tslot, tkeep = moe.dispatch_slots(tidx, C)
    np.testing.assert_array_equal(tslot.numpy(), slot)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if router == "zero":
        assert (idx[:, 0] == 0).all()
    assert keep.all() == full_capacity
    _close(moe.moe_apply(tp, cfg, _t(x)),
           ref_moe.moe_apply(jp, ref_cfg, jnp.asarray(x)), 2e-5)


def test_top_k_ties_take_the_lower_index():
    """torch.topk orders tied values its own way; the router's stable
    descending sort orders them as jax.lax.top_k does."""
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").smoke(),
                              top_k=2)
    p = {"router": torch.zeros(8, 4)}
    gate, idx = moe.route(p, cfg, torch.ones(3, 8))
    assert idx.tolist() == [[0, 1]] * 3
    want = jax.lax.top_k(jnp.full((1, 4), 0.25), 2)[1]
    assert idx[:1].tolist() == np.asarray(want).tolist()
    torch.testing.assert_close(gate, torch.full((3, 2), 0.5))


def test_moe_capacity_active_flops_shape():
    """Mirror of test_models_smoke: the block's output is finite and of
    x's shape, and the capacity is N * top_k * capacity_factor / E."""
    _, cfg, _, tp = _moe_case("kimi-k2-1t-a32b")
    x = _t(_x(cfg, T=32))
    y = moe.moe_apply(tp, cfg, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert moe.capacity(cfg, 64) == int(64 * 2 * 1.25 / 4)


# ----------------------------------------------------------------- W8A8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_weights_and_scales_match_reference_bitwise(dtype):
    """Quantising the same pre-quantisation weights (the reference's own
    draw in the model's dtype) gives the reference's int8 weights and f32
    scales bit for bit; init_params builds the same tree."""
    ref_cfg, cfg = _cfgs("kimi-k2-1t-a32b", dtype=dtype)
    key = jax.random.PRNGKey(3)
    plain = ref_moe.moe_params(key, ref_cfg)
    quant = ref_moe.moe_params(key, dataclasses.replace(ref_cfg,
                                                        moe_w8a8=True))
    for name in moe.EXPERT_WEIGHTS:
        w = np.asarray(plain[name].astype(jnp.float32))
        src = _t(w).to(cfg.torch_dtype)
        q, s = moe.quantize_weight(src)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(quant[name]))
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(quant[name + "_s"]))


def test_w8a8_int32_products_match_reference_bitwise():
    """The activation quantisation and the three int8 x int8 -> int32
    products of _w8a8_ffn, through the int8 op's plain version (CPU
    tensors), equal the reference's einsums bit for bit."""
    _, cfg, jp, tp = _moe_case("kimi-k2-1t-a32b", moe_w8a8=True)
    rng = np.random.default_rng(5)
    buf = rng.normal(size=(cfg.n_experts, 7, cfg.d_model)).astype(np.float32)
    buf[1, 3] = 0.0                      # an all-zero row: scale 0 -> 1e-9
    qb, bs = moe._quant_act(_t(buf))
    jqb, jbs = ref_moe._quant_act(jnp.asarray(buf))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))
    for name in moe.EXPERT_WEIGHTS[:2]:
        got = int8_grouped_matmul(qb, tp[name])
        want = jnp.einsum("ecd,edf->ecf", jqb, jp[name],
                          preferred_element_type=jnp.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    qh = rng.integers(-127, 128, size=(cfg.n_experts, 7, cfg.d_ff)
                      ).astype(np.int8)
    want = jnp.einsum("ecf,efd->ecd", jnp.asarray(qh), jp["w2"],
                      preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(int8_grouped_matmul(_t(qh), tp["w2"]
                                                      ).numpy(),
                                  np.asarray(want))


def _second_quant_step(tp, cfg, buf) -> float:
    """The largest change one step of the second activation quantisation
    can make to an expert output: max row scale of h times max |w2|."""
    qb, bs = moe._quant_act(buf)
    h1 = int8_grouped_matmul(qb, tp["w1"]).float() * bs * tp["w1_s"]
    h3 = int8_grouped_matmul(qb, tp["w3"]).float() * bs * tp["w3_s"]
    _, hs = moe._quant_act(torch.nn.functional.silu(h1) * h3)
    return float(hs.max()) * float((127.0 * tp["w2_s"]).max())


@pytest.mark.parametrize("full_capacity", [False, True])
def test_w8a8_moe_matches_reference_within_one_step(full_capacity):
    """_w8a8_ffn and the W8A8 moe_apply against the reference's: within
    one second-quantisation step (plus 2e-5), the largest change one
    flipped rounding of h / scale can make; each output row is a
    gate-weighted mean of expert rows, so the bound carries over.
    `use_kernels=False` (the plain int8 product) gives the same output."""
    replace = {"moe_w8a8": True}
    if full_capacity:
        replace["capacity_factor"] = 4.0
    ref_cfg, cfg, jp, tp = _moe_case("kimi-k2-1t-a32b", **replace)
    rng = np.random.default_rng(6)
    buf = rng.normal(size=(cfg.n_experts, 9, cfg.d_model)).astype(np.float32)
    step = _second_quant_step(tp, cfg, _t(buf))
    assert step > 0
    _close(moe._w8a8_ffn(tp, _t(buf)), ref_moe._w8a8_ffn(jp, jnp.asarray(buf)),
           step + 2e-5)
    x = _x(cfg, scale=0.5)
    got = moe.moe_apply(tp, cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref_moe.moe_apply(jp, ref_cfg, jnp.asarray(x))), atol=step + 2e-5,
        rtol=2e-5)
    torch.testing.assert_close(moe.moe_apply(tp, cfg, _t(x),
                                             use_kernels=False), got,
                               atol=0, rtol=0)


def test_w8a8_moe_close_to_bf16():
    """Mirror of test_perf_variants: from the same generator state the
    W8A8 init quantises the same pre-quantisation weights, and its output
    is within 15 % (of the largest) of the unquantised block's, not
    equal."""
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").smoke(),
                              dtype="float32", n_layers=1)
    cfg_q = dataclasses.replace(cfg, moe_w8a8=True)
    p = decoder._layer(decoder.init_params(
        torch.Generator().manual_seed(0), cfg)["layers"]["moe"], 0)
    pq = decoder._layer(decoder.init_params(
        torch.Generator().manual_seed(0), cfg_q)["layers"]["moe"], 0)
    torch.testing.assert_close(pq["router"], p["router"], atol=0, rtol=0)
    for name in moe.EXPERT_WEIGHTS:
        q, s = moe.quantize_weight(p[name])
        assert torch.equal(pq[name], q) and torch.equal(pq[name + "_s"], s)
    x = torch.from_numpy(_x(cfg, T=16, seed=1, scale=0.5))
    ref = moe.moe_apply(p, cfg, x)
    out = moe.moe_apply(pq, cfg_q, x)
    err = float((out - ref).abs().max())
    assert err / float(ref.abs().max()) < 0.15
    assert err > 0.0


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(40, 6)).astype(np.float32)
    idx = rng.integers(0, 6, size=(40, 2)).astype(np.int32)
    want = ref_moe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                     6)
    got = moe.load_balance_loss(_t(logits), _t(idx).long(), 6)
    _close(got, want, 1e-6)


# -------------------------------------------------------------- decoder

def _batch(cfg, B, S, seed):
    """Tokens ([B, S] or [B, S, nq]) and the prefix (or None), numpy."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    prefix = (rng.normal(size=(B, cfg.n_prefix_embeds, cfg.d_model)
                         ).astype(np.float32)
              if cfg.n_prefix_embeds else None)
    return toks, prefix


@pytest.mark.parametrize("arch", MOE_ARCHS + IO_ARCHS)
def test_decoder_logits_match_reference(arch):
    """Smoke decoders with JAX weights: prefill (after the prefix, with the
    codebook tokens) and three decode steps give the reference's logits
    within 1e-4, and the final caches match leaf by leaf. The MoE configs
    run at the default capacity, so prefill and decode drop copies, as the
    reference does."""
    ref_cfg, cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, cfg, "cpu")
    B, T, n_dec = 2, 13, 3
    toks, prefix = _batch(cfg, B, T + n_dec, seed=2)
    P = 0 if prefix is None else prefix.shape[1]
    max_len = P + T + n_dec
    want, jcache = ref_decoder.prefill(
        jparams, ref_cfg, jnp.asarray(toks[:, :T]),
        None if prefix is None else jnp.asarray(prefix), max_len=max_len)
    got, tcache = decoder.prefill(
        tparams, cfg, _t(toks[:, :T]).long(),
        None if prefix is None else _t(prefix), max_len=max_len)
    assert got.shape == want.shape
    _close(got, want, 1e-4)
    for t in range(T, T + n_dec):
        want, jcache = ref_decoder.decode_step(
            jparams, ref_cfg, jcache, jnp.asarray(toks[:, t:t + 1]),
            jnp.int32(P + t))
        got, tcache = decoder.decode_step(
            tparams, cfg, tcache, _t(toks[:, t:t + 1]).long(), P + t)
        _close(got, want, 1e-4)
    g, w = _leaves(tcache), _leaves(jcache)
    assert g.keys() == w.keys()
    for name in w:
        _close(g[name], np.asarray(w[name], np.float32), 1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_shapes(arch):
    """Mirror of test_models_smoke for every config: logits of shape [B, 1,
    V] (or [B, 1, nq, V]) and finite, after a prefix where the config has
    one."""
    cfg = get_config(arch).smoke()
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 16
    toks, prefix = _batch(cfg, B, S, seed=0)
    P = cfg.n_prefix_embeds
    logits, cache = decoder.prefill(
        params, cfg, _t(toks).long(), None if prefix is None else _t(prefix),
        max_len=S + P + 8)
    nq = cfg.n_codebooks
    want = (B, 1, nq, cfg.vocab_size) if nq else (B, 1, cfg.vocab_size)
    assert tuple(logits.shape) == want and torch.isfinite(logits).all()
    lg, cache = decoder.decode_step(params, cfg, cache, _t(toks[:, :1]).long(),
                                    S + P)
    assert tuple(lg.shape) == want and torch.isfinite(lg).all()


@pytest.mark.parametrize("arch", MOE_ARCHS + IO_ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Mirror of test_models_smoke: decoding token by token after a prefill
    (and its prefix) reproduces one big forward pass (f32 smoke: 1e-4).
    Capacity drops depend on the co-batched tokens, so the MoE configs run
    with capacity_factor = n_experts, as the reference's test does."""
    cfg = get_config(arch).smoke()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    B, S = 1, 12
    toks, prefix = _batch(cfg, B, S, seed=5)
    toks = _t(toks).long()
    prefix = None if prefix is None else _t(prefix)
    P = cfg.n_prefix_embeds
    full_logits, _ = decoder.prefill(params, cfg, toks, prefix,
                                     max_len=P + S + 2)
    cut = S - 3
    _, cache = decoder.prefill(params, cfg, toks[:, :cut], prefix,
                               max_len=P + S + 2)
    for t in range(cut, S):
        lg, cache = decoder.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                        P + t)
    _close(lg[:, -1], full_logits[:, -1].numpy(), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["kimi-k2-1t-a32b", "kimi-k2-w8a8",
                                  "llama4-scout-17b-a16e", "internvl2-26b",
                                  "musicgen-medium"])
def test_init_params_tree_matches_reference(case, dtype):
    """`init_params` builds the reference's tree: the same leaves, shapes
    and dtypes (the router f32, W8A8 experts int8 beside f32 scales),
    norms of ones; `init_cache` the reference's cache."""
    arch = "kimi-k2-1t-a32b" if case == "kimi-k2-w8a8" else case
    ref_cfg, cfg = _cfgs(arch, dtype=dtype,
                         moe_w8a8=case == "kimi-k2-w8a8")
    jtree = ref_decoder.init_params(jax.random.PRNGKey(0), ref_cfg)
    ttree = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    want, got = _leaves(jtree), _leaves(ttree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert _dtype(got[name]) == str(w.dtype), name
        if name.rsplit("/", 1)[-1] in ("ln1", "ln2", "final_norm"):
            assert torch.equal(got[name], torch.ones_like(got[name]))
    want = _leaves(ref_decoder.init_cache(ref_cfg, 2, 16))
    got = _leaves(decoder.init_cache(cfg, 2, 16, "cpu"))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert _dtype(got[name]) == str(w.dtype), name


# ------------------------------------------------------ engine, launcher

def _requests(cfg, lens, new_tokens):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n
                                               ).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "internvl2-26b"])
def test_engine_matches_reference_greedy_tokens(arch):
    """The engine on MoE and prefix-capable smoke configs (text-only
    prompts, as the reference serves them): identical ragged, left-padded
    batch and weights give the reference engine's greedy tokens."""
    from repro.serving.engine import Engine as RefEngine
    from repro.serving.engine import Request as RefRequest

    ref_cfg, cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    lens, new = [8, 5, 11], 6
    want = RefEngine(ref_cfg, jax.tree.map(jnp.asarray, tree), max_len=48,
                     max_batch=4).generate(
        [RefRequest(r.rid, r.prompt, r.max_new_tokens)
         for r in _requests(cfg, lens, new)])
    got = Engine(cfg, params_from_numpy(tree, cfg, "cpu"), max_len=48,
                 max_batch=4).generate(_requests(cfg, lens, new))
    for g, w in zip(got, want, strict=True):
        assert len(g.output) == new
        assert g.output == w.output


def test_launcher_serves_moe_on_cpu(capsys):
    assert serve.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--device",
                       "cpu", "--requests", "2", "--prompt-len", "9",
                       "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests on kimi-k2-1t-a32b-smoke" in out


def test_launcher_refuses_codebook_tokens():
    with pytest.raises(NotImplementedError, match="codebook"):
        serve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                    "cpu", "--requests", "1"])
