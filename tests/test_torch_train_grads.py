"""The port's training loss and its gradients against the JAX package's,
on the same inputs (numpy, from seeds) and the same weights (the JAX
parameter tree through `params_from_numpy`), f32 throughout, on the CPU.

- `chunked_ce_loss`: loss and d/dxs, d/dhead against
  `jax.value_and_grad` of the reference's, S not a multiple of the chunk;
  rtol 1e-5 (one f32 logsumexp per row, summed in another order).
- The attention backward's plain version (`flash_attention_bwd_ref`, the
  explicit formulas) against torch autograd through `attention_ref` and
  `jax.vjp` of the reference's `kernels/flash_attention/ref.attention_ref`,
  and `lse_ref` against the logsumexp: f32 1e-5, at hd 16 and at the
  kernel's hd 32 and 112. The backward takes every head dim the forward
  takes, and a CPU gradient through `flash_attention` runs the plain path.
- `decoder.train_loss` and every gradient leaf against
  `jax.value_and_grad(repro.models.decoder.train_loss)` on seven smoke
  configs at T 64: loss rtol 1e-5, each leaf relative L2 <= 1e-5 (a
  reduction over a few hundred f32 terms per element, in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.models import decoder as ref_decoder  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, lse_ref)
from repro_torch.kernels.flash_attention_bwd.ref import \
    flash_attention_bwd_ref  # noqa: E402
from repro_torch.models import decoder, layers  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------ chunked CE

@pytest.mark.parametrize("S,chunk", [(100, 64), (96, 32), (7, 64)])
def test_chunked_ce_loss_and_grads_match_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, d, V = 3, 24, 77
    head = (rng.normal(size=(d, V)) * d ** -0.5).astype(np.float32)
    xs = rng.normal(size=(B, S, d)).astype(np.float32)
    tg = rng.integers(0, V, size=(B, S)).astype(np.int32)
    want, (wh, wx) = jax.value_and_grad(
        lambda h, x: ref_layers.chunked_ce_loss(h, x, jnp.asarray(tg), chunk),
        argnums=(0, 1))(jnp.asarray(head), jnp.asarray(xs))
    assert layers._pick_chunk(S, chunk) == ref_layers._pick_chunk(S, chunk)
    h, x = _t(head).requires_grad_(), _t(xs).requires_grad_()
    got = layers.chunked_ce_loss(h, x, torch.from_numpy(tg).long(), chunk)
    gh, gx = torch.autograd.grad(got, (h, x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                               atol=1e-7)
    with torch.no_grad():       # no autograd: the same value, no recompute
        assert layers.chunked_ce_loss(
            h, x, torch.from_numpy(tg).long(), chunk).item() == got.item()


# ------------------------------------------------ attention backward, plain

@pytest.mark.parametrize("hd", [16, 32, 112])
@pytest.mark.parametrize("name,B,H,KV,Tq,Tk,window,lost", [
    ("gqa7", 2, 14, 2, 40, 40, 0, False),
    ("window", 1, 4, 2, 50, 50, 9, False),
    ("ragged", 2, 4, 1, 23, 61, 0, False),
    ("lost-row", 1, 6, 2, 30, 45, 12, True),
])
def test_attention_bwd_plain_matches_autograd_and_reference(
        name, B, H, KV, Tq, Tk, window, lost, hd):
    rng = np.random.default_rng(Tq + Tk)
    q = rng.normal(size=(B, H, Tq, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, Tk, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, Tk, hd)).astype(np.float32)
    do = rng.normal(size=(B, H, Tq, hd)).astype(np.float32)
    qp = np.arange(Tk - Tq, Tk, dtype=np.int32)
    if lost:
        qp[4] = -3                          # precedes every key
    kp = np.arange(Tk, dtype=np.int32)
    qpt, kpt = torch.from_numpy(qp), torch.from_numpy(kp)

    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = attention_ref(*leaves, qpt, kpt, window)
    want = torch.autograd.grad(o, leaves, _t(do))
    lse = lse_ref(_t(q), _t(k), qpt, kpt, window)
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o.detach(), lse,
                                  _t(do), qpt, kpt, window)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(
        a, b, c, jnp.asarray(qp), jnp.asarray(kp), window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)

    # lse_ref: the masked logits' logsumexp, +inf on a row with no key.
    s = np.einsum("bhqd,bhkd->bhqk", np.repeat(q, 1, 1),
                  np.repeat(k, H // KV, 1)) * hd ** -0.5
    adm = (kp[None, :] <= qp[:, None])
    if window:
        adm &= kp[None, :] > qp[:, None] - window
    s = np.where(adm, s, -np.inf)
    with np.errstate(divide="ignore"):
        m = s.max(-1, keepdims=True)
        want_lse = (m + np.log(np.exp(s - np.where(np.isfinite(m), m, 0))
                               .sum(-1, keepdims=True)))[..., 0]
    want_lse = np.where(adm.any(-1), want_lse, np.inf)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    assert np.isinf(lse.numpy()).any() == lost


# ------------------------------------------------ train_loss and gradients

TRAIN_ARCHS = [
    "qwen2-0.5b",
    "llama4-scout-17b-a16e",        # MoE top-1 + shared expert
    "kimi-k2-1t-a32b",              # MoE top-2 (smoke) + shared expert
    "internvl2-26b",                # a prefix
    "musicgen-medium",              # codebooks
    "rwkv6-7b",                     # the CPU's plain scans
    "zamba2-7b",
]


def _train_case(arch, B=2, T=64, seed=0):
    ref_cfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed + 1)
    shape = (B, T, cfg.n_codebooks) if cfg.n_codebooks else (B, T)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    batch = dict(tokens=toks, targets=tgts)
    if cfg.n_prefix_embeds:
        batch["prefix"] = rng.normal(
            size=(B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, tree, batch


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    ref_cfg, cfg, tree, batch = _train_case(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, wgrads = jax.value_and_grad(
        lambda p: ref_decoder.train_loss(p, ref_cfg, jbatch))(
        jax.tree.map(jnp.asarray, tree))

    params = params_from_numpy(tree, cfg, "cpu")
    flat = _leaves(params)
    for t in flat.values():
        t.requires_grad_()
    tbatch = {k: torch.from_numpy(v) if v.dtype != np.float32 else _t(v)
              for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    tbatch["targets"] = tbatch["targets"].long()
    got = decoder.train_loss(params, cfg, tbatch)
    grads = dict(zip(flat, torch.autograd.grad(got, list(flat.values()))))

    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    wflat = {k: np.asarray(v, np.float32) for k, v in _leaves(wgrads).items()}
    assert grads.keys() == wflat.keys()
    # A leaf whose exact gradient is zero has only rounding noise to
    # compare: top-1 routing renormalises its one gate to p / p = 1, so
    # the router gets nothing (~1e-10 on both sides). Such a leaf (norm
    # below 1e-7 of the whole gradient's) must stay as small in the port.
    total = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2)
                        for w in wflat.values()))
    for name, g in grads.items():
        w = wflat[name]
        assert g.shape == w.shape, name
        if np.linalg.norm(w) < 1e-7 * total:
            assert np.linalg.norm(g.numpy()) < 1e-7 * total, name
            continue
        assert _rel_l2(g.numpy(), w) <= 1e-5, (name, _rel_l2(g.numpy(), w))


@pytest.mark.parametrize("remat", [True, False])
def test_remat_changes_no_value(remat):
    """cfg.remat recomputes each layer in the backward; the loss and the
    gradients are those of the plain stack, bit for bit."""
    _, cfg, tree, batch = _train_case("qwen2-0.5b", seed=3)
    cfg = dataclasses.replace(cfg, remat=remat)
    plain = dataclasses.replace(cfg, remat=False)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    out = []
    for c in (cfg, plain):
        params = params_from_numpy(tree, c, "cpu")
        leaves = list(_leaves(params).values())
        for t in leaves:
            t.requires_grad_()
        loss = decoder.train_loss(params, c, tb)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_attention_bwd_takes_the_forward_head_dims():
    from repro_torch.kernels.flash_attention import kernel as fwd_kernel
    from repro_torch.kernels.flash_attention_bwd import kernel as bwd_kernel

    assert bwd_kernel.HEAD_DIMS == fwd_kernel.HEAD_DIMS == (32, 64, 112, 128)


def test_cpu_attention_gradient_at_hd112_runs_the_plain_path():
    """On CPU tensors `flash_attention` under autograd launches neither
    kernel: its gradient is autograd's through the plain version, equal to
    the plain backward on the same o and LSE."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention_bwd.ops import \
        flash_attention_bwd

    rng = np.random.default_rng(112)
    B, H, KV, T, hd, window = 1, 4, 2, 24, 112, 8
    q, do = (_t(rng.normal(size=(B, H, T, hd))) for _ in range(2))
    k, v = (_t(rng.normal(size=(B, KV, T, hd))) for _ in range(2))
    pos = torch.arange(T, dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, pos, pos, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n_fwd
    assert flash_attention_bwd.launches == n_bwd
    lse = lse_ref(q, k, pos, pos, window)
    want = flash_attention_bwd(q, k, v, out.detach(), lse, do, pos, pos,
                               window)
    assert flash_attention_bwd.launches == n_bwd
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
