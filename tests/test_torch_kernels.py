"""The port's plain attention versions against the JAX package: the jnp
oracles (`attention_ref`, `decode_attention_ref`) and the Pallas kernels
run in interpret mode on the CPU, over the shape sweep of test_kernels.py.
Inputs come from numpy; each framework gets the same arrays.

Tolerances (as in test_kernels.py): 2e-5 for f32, 5e-2 for bf16, which
rounds the output to 8 bits of mantissa in both frameworks.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as dec_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as dec_jnp  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as fa_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as fa_jnp  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

torch.set_num_threads(1)

TOLS = {"float32": 2e-5, "bfloat16": 5e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(a, JAX_DT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH_DT[dtype])
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,T,hd", [
    (1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 8, 256, 128),
    (2, 2, 2, 384, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_plain_matches_oracle_and_pallas(B, H, KV, T, hd, dtype,
                                               window):
    rng = np.random.default_rng(B * 1000 + H * 100 + T + window)
    qj, qt = _both(rng.normal(size=(B, H, T, hd)), dtype)
    kj, kt = _both(rng.normal(size=(B, KV, T, hd)), dtype)
    vj, vt = _both(rng.normal(size=(B, KV, T, hd)), dtype)
    pos_j = jnp.arange(T, dtype=jnp.int32)
    got = flash_attention(qt, kt, vt, window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, T, hd)
    _close(got, fa_jnp(qj, kj, vj, pos_j, pos_j, window=window), TOLS[dtype])
    pallas = fa_pallas(qj, kj, vj, pos_j, pos_j, window=window,
                       block_q=128, block_k=128)
    _close(got, pallas, TOLS[dtype])


@pytest.mark.parametrize("Tq,Tk,window", [(77, 77, 0), (200, 200, 64),
                                          (5, 133, 0)])
def test_flash_plain_ragged_lengths(Tq, Tk, window):
    """Lengths the Pallas kernel cannot tile; positions offset so the
    queries are the last Tq of Tk keys. Checked against the jnp oracle."""
    rng = np.random.default_rng(Tq + Tk)
    B, H, KV, hd = 2, 4, 2, 64
    qj, qt = _both(rng.normal(size=(B, H, Tq, hd)), "float32")
    kj, kt = _both(rng.normal(size=(B, KV, Tk, hd)), "float32")
    vj, vt = _both(rng.normal(size=(B, KV, Tk, hd)), "float32")
    q_pos = np.arange(Tk - Tq, Tk, dtype=np.int32)
    k_pos = np.arange(Tk, dtype=np.int32)
    got = flash_attention(qt, kt, vt, torch.from_numpy(q_pos),
                          torch.from_numpy(k_pos), window=window)
    want = fa_jnp(qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(k_pos),
                  window=window)
    _close(got, want, TOLS["float32"])


@pytest.mark.parametrize("B,KV,G,S,hd", [
    (1, 2, 4, 512, 64), (2, 1, 8, 1024, 128), (2, 4, 1, 512, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_oracle_and_pallas(B, KV, G, S, hd, dtype):
    rng = np.random.default_rng(B * 1000 + KV * 100 + G * 10 + S)
    qj, qt = _both(rng.normal(size=(B, KV, G, hd)), dtype)
    kj, kt = _both(rng.normal(size=(B, KV, S, hd)), dtype)
    vj, vt = _both(rng.normal(size=(B, KV, S, hd)), dtype)
    pos = S - S // 3
    got = decode_attention(qt, kt, vt, pos=pos)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, KV, G, hd)
    k_pos = jnp.arange(S, dtype=jnp.int32)
    _close(got, dec_jnp(qj, kj, vj, k_pos, jnp.int32(pos)), TOLS[dtype])
    pallas = dec_pallas(qj, kj, vj, pos=jnp.int32(pos), block_k=256)
    _close(got, pallas, TOLS[dtype])


@pytest.mark.parametrize("empty", [0, 40])
def test_decode_plain_ring_positions_and_sentinel(empty):
    """Ring caches pass non-monotonic positions; slots never written carry
    2**30, which `k_pos <= pos` masks."""
    rng = np.random.default_rng(3 + empty)
    B, KV, G, S, hd = 1, 2, 2, 256, 64
    qj, qt = _both(rng.normal(size=(B, KV, G, hd)), "float32")
    kj, kt = _both(rng.normal(size=(B, KV, S, hd)), "float32")
    vj, vt = _both(rng.normal(size=(B, KV, S, hd)), "float32")
    last = 300
    k_pos = last - ((last - np.arange(S)) % S)
    k_pos[rng.choice(S, size=empty, replace=False)] = 2 ** 30
    k_pos = k_pos.astype(np.int32)
    got = decode_attention(qt, kt, vt, torch.from_numpy(k_pos), last)
    want = dec_jnp(qj, kj, vj, jnp.asarray(k_pos), jnp.int32(last))
    _close(got, want, TOLS["float32"])
    pallas = dec_pallas(qj, kj, vj, k_pos=jnp.asarray(k_pos),
                        pos=jnp.int32(last), block_k=128)
    _close(got, pallas, TOLS["float32"])


def test_strided_views_match_contiguous():
    """The layer hands the kernels [B,T,H,hd] tensors as transposed views;
    the plain versions give the same answer on views and on copies."""
    rng = np.random.default_rng(7)
    B, T, H, KV, hd = 2, 40, 4, 2, 32
    q = torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, T, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, T, KV, hd)).astype(np.float32))
    views = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    copies = flash_attention(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous())
    torch.testing.assert_close(views, copies, atol=0, rtol=0)
    qd = q[:, -1].reshape(B, KV, H // KV, hd)
    d_views = decode_attention(qd, k.transpose(1, 2), v.transpose(1, 2))
    d_copies = decode_attention_ref(qd, k.transpose(1, 2).contiguous(),
                                    v.transpose(1, 2).contiguous(),
                                    torch.arange(T), T - 1)
    torch.testing.assert_close(d_views, d_copies, atol=0, rtol=0)


def test_cpu_tensors_never_count_a_launch():
    before = (flash_attention.launches, decode_attention.launches)
    x = torch.zeros(1, 2, 8, 32)
    flash_attention(x, x, x)
    decode_attention(x[:, :, :1], x, x)
    assert (flash_attention.launches, decode_attention.launches) == before


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: nothing falls back."""
    x = torch.zeros(1, 2, 8, 64)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(x, x, x, pos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.decode_attention(x[:, :, :2], x, x, pos, 7)


@pytest.mark.parametrize("B,KV,S", [(8, 2, 1031), (1, 1, 1), (3, 2, 100),
                                    (64, 8, 4096), (2, 1, 64 * 33 + 5)])
def test_decode_split_covers_the_cache(B, KV, S):
    """The decode kernel's cut of S into runs: whole tiles, none empty,
    about two blocks per SM where S allows."""
    n_split, split_len = dec_kernel.split(B, KV, S, n_sm=132)
    assert split_len % dec_kernel.TILE == 0
    assert (n_split - 1) * split_len < S <= n_split * split_len
    n_tiles = -(-S // dec_kernel.TILE)
    assert B * KV * n_split >= min(2 * 132, B * KV * n_tiles) // 2
