"""The W8A8 experts' K-major storage and the grouped int8 GEMM's plain
side, against the JAX package on the CPU.

The port keeps the reference's int8 expert weights [n, E, d_in, d_out]
with the same shapes and values in a K-major storage (unit stride on
d_in), which the int8 `wgmma` kernel needs. Held here, bitwise (integer
data): `moe_params` quantises the reference's own draw into that storage;
`params_from_numpy`, `params_to_numpy` and the checkpoints carry the
reference's weights both ways; the plain product is exact on K-major
strided views and on experts whose rows are all zero; and the wrapper's
layout rule (K-major, N-major, refused) on CPU tensors.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import decoder as ref_decoder  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.training import checkpoint as ref_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.int8_grouped_matmul import kernel as gk  # noqa: E402
from repro_torch.kernels.int8_grouped_matmul.ops import \
    int8_grouped_matmul  # noqa: E402
from repro_torch.kernels.int8_grouped_matmul.ref import \
    int8_grouped_matmul_ref  # noqa: E402
from repro_torch.models import decoder, moe  # noqa: E402
from repro_torch.models.weights import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.training import checkpoint  # noqa: E402

torch.set_num_threads(1)

ARCH = "kimi-k2-1t-a32b"


def _cfgs(**replace):
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).smoke(), **replace)
    cfg = dataclasses.replace(get_config(ARCH).smoke(), **replace)
    return ref_cfg, cfg


def _expert_leaves(tree):
    """{path: leaf} of the int8 expert weights of a parameter tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in moe.EXPERT_WEIGHTS and "w1_s" in node:
                    out[f"{path}/{k}"] = v
                else:
                    walk(v, f"{path}/{k}")

    walk(tree, "")
    return out


def _assert_kmajor(w: torch.Tensor):
    assert w.dtype == torch.int8 and w.stride(-2) == 1, w.stride()


def _int8(rng, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-128, 128, size=shape,
                                         dtype=np.int8))


def _np_product(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    return np.einsum("eck,ekn->ecn", a.numpy().astype(np.int64),
                     b.numpy().astype(np.int64))


# ------------------------------------------------------- K-major storage

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_stores_w8a8_experts_kmajor(dtype):
    """moe_params, fed the reference's own pre-quantisation draw, gives
    the reference's int8 experts bit for bit, in the reference's shape
    [n, E, d_in, d_out] with a unit stride on d_in."""
    ref_cfg, cfg = _cfgs(dtype=dtype)
    key = jax.random.PRNGKey(5)
    plain = ref_moe.moe_params(key, ref_cfg)
    quant = ref_moe.moe_params(key, dataclasses.replace(ref_cfg,
                                                        moe_w8a8=True))
    draws = [np.asarray(plain["router"].astype(jnp.float32))[None]]
    for name in moe.EXPERT_WEIGHTS:
        draws += list(np.asarray(plain[name].astype(jnp.float32)))
    for name in ("w1", "w3", "w2"):             # the shared expert, last
        draws.append(np.asarray(plain["shared"][name].astype(
            jnp.float32))[None])
    feed = iter(draws)

    def normal(shape, fan_in):
        x = next(feed)
        assert x.shape == tuple(shape)
        return torch.from_numpy(np.array(x)).to(cfg.torch_dtype)

    p = moe.moe_params(normal, None, dataclasses.replace(cfg, moe_w8a8=True),
                       1)
    for name in moe.EXPERT_WEIGHTS:
        _assert_kmajor(p[name])
        assert tuple(p[name].shape) == (1, *quant[name].shape)
        np.testing.assert_array_equal(p[name][0].numpy(),
                                      np.asarray(quant[name]))
        np.testing.assert_array_equal(p[name + "_s"][0].numpy(),
                                      np.asarray(quant[name + "_s"]))


def test_reference_w8a8_weights_pass_both_ways_kmajor():
    """params_from_numpy stores the reference's int8 experts K-major with
    their values; params_to_numpy gives them back bit for bit, every
    other leaf too; init_params builds the same storage."""
    ref_cfg, cfg = _cfgs(moe_w8a8=True)
    tree = jax.tree.map(np.asarray, ref_decoder.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    params = params_from_numpy(tree, cfg, "cpu")
    experts = _expert_leaves(params)
    assert sorted(experts) == [f"/layers/moe/{n}" for n in ("w1", "w2",
                                                            "w3")]
    for path, w in experts.items():
        _assert_kmajor(w)
        np.testing.assert_array_equal(
            w.numpy(), tree["layers"]["moe"][path.rsplit("/", 1)[-1]])
    back = jax.tree_util.tree_leaves_with_path(params_to_numpy(params))
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(back) == len(want)
    for path, leaf in back:
        assert leaf.dtype == want[path].dtype, path
        np.testing.assert_array_equal(leaf, want[path])
    for w in _expert_leaves(decoder.init_params(
            torch.Generator().manual_seed(0), cfg)).values():
        _assert_kmajor(w)


def test_w8a8_checkpoints_pass_both_ways(tmp_path):
    """A W8A8 parameter tree through the port's and the reference's
    checkpoints, both directions: the same values, and the port restores
    its experts K-major."""
    _, cfg = _cfgs(moe_w8a8=True)
    params = decoder.init_params(torch.Generator().manual_seed(1), cfg)
    want = params_to_numpy(params)
    checkpoint.save(str(tmp_path / "port"), params, meta=dict(step=1))
    got, meta = ref_checkpoint.restore(str(tmp_path / "port"))
    assert meta == dict(step=1)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_array_equal(
            np.asarray(got_leaf := _at(got, path)), leaf)
        assert got_leaf.dtype == leaf.dtype
    ref_checkpoint.save(str(tmp_path / "ref"), want, meta=dict(step=2))
    back, _ = checkpoint.restore(str(tmp_path / "ref"), "cpu")
    for w in _expert_leaves(back).values():
        _assert_kmajor(w)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            params_to_numpy(back)):
        np.testing.assert_array_equal(leaf, _at(want, path))


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ---------------------------------------------- the plain product, layouts

def test_plain_product_exact_on_kmajor_views_and_zero_experts():
    """int8_grouped_matmul_ref (the op's CPU path) equals an int64 product
    on K-major strided windows, and gives zero rows for zero rows of a:
    no expert, every other one, all but one, all of them."""
    rng = np.random.default_rng(7)
    E, C, K, N = 5, 19, 96, 48
    store = _int8(rng, (E, N + 32, K + 48))            # [E, N', K']
    b = store[:, 16:16 + N, 32:32 + K].transpose(1, 2)  # [E, K, N], K-major
    assert b.stride(1) == 1 and not b.is_contiguous()
    a = _int8(rng, (C + 3, E, K)).transpose(0, 1)[:, 2:2 + C]
    got = int8_grouped_matmul(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np_product(a, b))
    a = _int8(rng, (E, C, K))
    for zero in ([], [0, 2, 4], [0, 1, 2, 4], list(range(E))):
        az = a.clone()
        az[zero] = 0
        got = int8_grouped_matmul_ref(az, b)
        np.testing.assert_array_equal(got.numpy(), _np_product(az, b))
        assert not got[zero].any()
    lo = torch.full((2, 3, 8192), -128, dtype=torch.int8)
    b_lo = torch.full((2, 64, 8192), -128, dtype=torch.int8).transpose(1, 2)
    assert torch.equal(int8_grouped_matmul_ref(lo, b_lo),
                       torch.full((2, 3, 64), 8192 * 128 * 128,
                                  dtype=torch.int32))


@pytest.mark.parametrize("case,want", [
    ("contiguous", gk.NMAJOR),
    ("kmajor", gk.KMAJOR),
    ("kmajor-window", gk.KMAJOR),
    ("nmajor-window", gk.NMAJOR),
    ("one-expert", gk.KMAJOR),
    ("base+1", ValueError),
    ("kmajor-n-stride-8", ValueError),
    ("no-unit-stride", ValueError),
    ("not-3d", ValueError),
])
def test_b_layout_picks_the_kernel_by_b_layout(case, want):
    """The wrapper's rule, a plain function of b's shape, strides and
    address: a unit stride on K goes to the wgmma kernel, a unit stride on
    N to the N-major mma.sync kernel, each with a 16-byte-aligned base and other strides
    multiples of 16 bytes; anything else raises ValueError."""
    E, K, N = 3, 64, 32
    kstore = torch.zeros((E, N + 16, K + 32), dtype=torch.int8)
    flat = torch.zeros(E * K * N + 64, dtype=torch.int8)
    b = {"contiguous": lambda: torch.zeros((E, K, N), dtype=torch.int8),
         "kmajor": lambda: torch.zeros((E, N, K),
                                       dtype=torch.int8).transpose(1, 2),
         "kmajor-window": lambda: kstore[:, 16:, 16:16 + K].transpose(1, 2),
         "nmajor-window": lambda: torch.zeros((E, K, N + 32),
                                              dtype=torch.int8)[:, :, 16:
                                                                16 + N],
         "one-expert": lambda: torch.zeros(K * N + 7, dtype=torch.int8
                                           ).as_strided((1, K, N), (7, 1, K)),
         "base+1": lambda: flat[1:1 + E * K * N].view(E, N, K).transpose(1,
                                                                          2),
         "kmajor-n-stride-8": lambda: torch.zeros(
             E * N * (K + 8), dtype=torch.int8).as_strided(
                 (E, K, N), (N * (K + 8), 1, K + 8)),
         "no-unit-stride": lambda: torch.zeros((E, K, 2 * N),
                                               dtype=torch.int8)[:, :, ::2],
         "not-3d": lambda: torch.zeros((K, N), dtype=torch.int8),
         }[case]()
    if want is ValueError:
        with pytest.raises(ValueError):
            gk.b_layout(b)
    else:
        assert gk.b_layout(b) == want
