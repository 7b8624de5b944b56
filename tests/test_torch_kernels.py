"""The port's plain kernel versions against the JAX package: the jnp
oracles (`attention_ref`, `decode_attention_ref`, `ssm_scan_ref`,
`rwkv6_wkv_ref`) and the Pallas kernels run in interpret mode on the CPU,
over the shape sweeps of test_kernels.py. Inputs come from numpy; each
framework gets the same arrays.

Tolerances (as in test_kernels.py): attention 2e-5 for f32 and 5e-2 for
bf16, which rounds the output to 8 bits of mantissa in both frameworks;
ssm_scan 5 times those (that test's own bound); rwkv6_wkv 1e-4. The scans
also take ragged lengths (checked against the jnp stepwise oracles) and
carry their state: one call equals two calls split anywhere, the first
one's final state passed to the second, to 1e-5; and their final state
equals the JAX model's chunked `S_out` on the inputs a JAX layer builds,
to 1e-4 (test_torch_models.py compares every cache leaf of the models).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as dec_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as dec_jnp  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as fa_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as fa_jnp  # noqa: E402
from repro.kernels.rwkv6_wkv.ops import rwkv6_wkv as wkv_pallas  # noqa: E402
from repro.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref as wkv_jnp  # noqa: E402
from repro.kernels.ssm_scan.ops import ssm_scan as ssm_pallas  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as ssm_jnp  # noqa: E402
from repro_torch.kernels._layout import aligned16, check_aligned  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.models.mamba2 import _ssd_chunked  # noqa: E402
from repro_torch.models.rwkv6 import _wkv_chunked  # noqa: E402

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
    ops = (flash_attention, decode_attention, ssm_scan, rwkv6_wkv)
    before = [op.launches for op in ops]
    x = torch.zeros(1, 2, 8, 32)
    flash_attention(x, x, x)
    decode_attention(x[:, :, :1], x, x)
    b = x[:, :, 0, :16]                   # [B, T, N] for the SSD scan
    ssm_scan(x, b, b, x[..., 0], x[0, 0, :, 0], x[0, 0, :, 0])
    rwkv6_wkv(x, x, x, x, x[0, 0])
    assert [op.launches for op in ops] == before


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: nothing falls back."""
    x = torch.zeros(1, 2, 8, 64)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(x, x, x, pos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.decode_attention(x[:, :, :2], x, x, pos, 7)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.rwkv6_wkv(x, x, x, x, x[0, 0])
    b = x[:, :, 0, :16]
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel.ssm_scan(x, b, b, x[..., 0], x[0, 0, :, 0], x[0, 0, :, 0])


@pytest.mark.parametrize("B,KV,G,S,hd", [
    (8, 2, 7, 1031, 64),             # qwen2-0.5b's served decode
    (8, 32, 1, 1031, 112),           # zamba2-7b's served decode
    (8, 8, 16, 1031, 128),           # hd 128 x G 16
    (1, 1, 1, 1, 64), (3, 2, 2, 100, 32), (64, 8, 2, 4096, 64),
    (2, 1, 4, 64 * 33 + 5, 128), (1, 1, 1, 64 * 64, 112),
    (1, 1, 1, 200_000, 64), (128, 32, 1, 200, 64),
])
def test_decode_split_covers_the_cache(B, KV, G, S, hd):
    """The decode kernel's cut of S into runs: whole tiles, none empty,
    sized from the total tile count so that the card gets about
    RUNS_PER_SM runs per SM (as many as there are tiles below that), at
    most MAX_SPLIT per group; and the merge's workspace keeps every run's
    16-byte rows aligned."""
    n_sm = 132
    n_split, split_len = dec_kernel.split(B, KV, S, n_sm)
    assert split_len % dec_kernel.TILE == 0
    assert (n_split - 1) * split_len < S <= n_split * split_len
    assert 1 <= n_split <= dec_kernel.MAX_SPLIT
    n_tiles = -(-S // dec_kernel.TILE)
    total = B * KV * n_tiles
    runs = B * KV * n_split
    assert runs >= min(total, dec_kernel.RUNS_PER_SM * n_sm,
                       B * KV * dec_kernel.MAX_SPLIT) // 2
    # No finer than needed: a run holds at most twice the aimed tiles.
    aim = max(-(-total // (dec_kernel.RUNS_PER_SM * n_sm)),
              -(-n_tiles // dec_kernel.MAX_SPLIT))
    assert split_len // dec_kernel.TILE == aim
    per_run = dec_kernel.workspace_floats(B, KV, G, hd, n_split) // runs
    assert per_run * runs == dec_kernel.workspace_floats(B, KV, G, hd,
                                                         n_split)
    assert per_run % 4 == 0 and per_run >= G * (hd + 2)


def test_decode_split_at_the_served_shapes():
    """zamba2-7b (B*KV = 256 groups of 17 tiles) gets 4 runs of 5 tiles,
    not the 2 runs of 9 that aiming at two blocks per SM gave; qwen2-0.5b
    (16 groups) one tile per run."""
    assert dec_kernel.split(8, 32, 1031, 132) == (4, 320)
    assert dec_kernel.split(8, 2, 1031, 132) == (17, 64)


def test_decode_merge_counters_are_kept_per_stream():
    """The folded merge's arrival counters: one zeroed buffer per (device,
    stream), shared by the calls of one stream, never by two streams,
    and grown only for more (b, kv) groups."""
    dev = torch.device("cpu")
    saved = dict(dec_kernel._counters)
    dec_kernel._counters.clear()
    try:
        a = dec_kernel._merge_counters(dev, 11, 256)
        assert a.dtype == torch.int32 and not a.any()
        assert dec_kernel._merge_counters(dev, 11, 16) is a
        b = dec_kernel._merge_counters(dev, 12, 256)
        assert b.data_ptr() != a.data_ptr()
        big = dec_kernel._merge_counters(dev, 11, a.numel() + 1)
        assert big.numel() > a.numel()
        assert dec_kernel._merge_counters(dev, 12, 16) is b
    finally:
        dec_kernel._counters.clear()
        dec_kernel._counters.update(saved)


@pytest.mark.parametrize("shape,strides,itemsize,ptr,ok", [
    ((8, 14, 999, 64), (894976, 64, 896, 1), 2, 0x7f0000000000, True),
    ((8, 32, 999, 112), (3580416, 112, 3584, 1), 2, 0x7f0000000100, True),
    ((8, 14, 999, 64), (894976, 64, 896, 1), 2, 0x7f0000000002, False),
    ((8, 14, 999, 64), (894976, 64, 896, 1), 4, 0x7f0000000004, False),
    ((2, 4, 70, 64), (17920, 64, 256, 1), 4, 0x7f0000000010, True),
    ((2, 4, 70, 36), (10080, 36, 144, 1), 2, 0x7f0000000000, False),
    ((1, 2, 64, 64), (3, 64, 128, 1), 2, 0x7f0000000000, True),
    ((2, 2, 64, 64), (3, 64, 128, 1), 2, 0x7f0000000000, False),
    ((2, 2, 64, 64), (8192, 64, 128, 2), 2, 0x7f0000000000, False),
    ((1031,), (1,), 4, 0x7f0000000040, True),
    ((1031,), (1,), 4, 0x7f0000000044, False),
])
def test_alignment_predicate(shape, strides, itemsize, ptr, ok):
    """The layout the attention kernels read by 16-byte copies: aligned
    base, unit last stride, 16-byte-multiple strides except where the
    extent is 1; a view offset by one element fails."""
    assert aligned16(shape, strides, itemsize, ptr) is ok


def test_alignment_predicate_on_views():
    """On real tensors: the model's transposed view of a fresh allocation
    passes, the same view offset by one element fails, and `check_aligned`
    raises ValueError for it."""
    n = 2 * 40 * 4 * 64
    x = torch.zeros(n + 8, dtype=torch.bfloat16)
    good = x[:n].view(2, 40, 4, 64).transpose(1, 2)
    bad = x[1:n + 1].view(2, 40, 4, 64).transpose(1, 2)
    check_aligned("test", q=good)
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned("test", q=good, k=bad)


# ------------------------------------------------------ attention at hd 112

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_plain_matches_pallas_at_head_dim_112(dtype, window):
    """zamba2's shared attention: hd 112 (7 x 16), G = 1."""
    rng = np.random.default_rng(112 + window)
    B, H, T, hd = 2, 4, 256, 112
    qj, qt = _both(rng.normal(size=(B, H, T, hd)), dtype)
    kj, kt = _both(rng.normal(size=(B, H, T, hd)), dtype)
    vj, vt = _both(rng.normal(size=(B, H, T, hd)), dtype)
    got = flash_attention(qt, kt, vt, window=window)
    pos_j = jnp.arange(T, dtype=jnp.int32)
    _close(got, fa_jnp(qj, kj, vj, pos_j, pos_j, window=window), TOLS[dtype])
    _close(got, fa_pallas(qj, kj, vj, pos_j, pos_j, window=window,
                          block_q=128, block_k=128), TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_at_head_dim_112(dtype):
    rng = np.random.default_rng(113)
    B, KV, G, S, hd = 2, 4, 1, 512, 112
    qj, qt = _both(rng.normal(size=(B, KV, G, hd)), dtype)
    kj, kt = _both(rng.normal(size=(B, KV, S, hd)), dtype)
    vj, vt = _both(rng.normal(size=(B, KV, S, hd)), dtype)
    pos = S - S // 3
    got = decode_attention(qt, kt, vt, pos=pos)
    _close(got, dec_jnp(qj, kj, vj, jnp.arange(S, dtype=jnp.int32),
                        jnp.int32(pos)), TOLS[dtype])
    _close(got, dec_pallas(qj, kj, vj, pos=jnp.int32(pos), block_k=256),
           TOLS[dtype])


# ------------------------------------------------------------ the two scans

def _ssm_inputs(rng, B, T, nh, hp, N, dtype):
    """The sweep's inputs (test_kernels.py), as (JAX, torch) pairs."""
    x = _both(rng.normal(size=(B, T, nh, hp)), dtype)
    Bm = _both(rng.normal(size=(B, T, N)) * 0.5, dtype)
    Cm = _both(rng.normal(size=(B, T, N)) * 0.5, dtype)
    dt = _both(rng.uniform(0.001, 0.1, size=(B, T, nh)), "float32")
    A = _both(-rng.uniform(0.5, 2.0, size=(nh,)), "float32")
    D = _both(rng.normal(size=(nh,)), "float32")
    return x, Bm, Cm, dt, A, D


def _wkv_inputs(rng, B, T, H, hd, decay_shift=-1.5):
    """The sweep's inputs (test_kernels.py); a larger `decay_shift` makes
    the decay strong enough that a chunk's cumulative log decay passes
    -88, where exp(-cum) would overflow f32."""
    r, k, v = (_both(rng.normal(size=(B, T, H, hd)) * 0.5, "float32")
               for _ in range(3))
    lw = _both(-np.exp(rng.normal(size=(B, T, H, hd)) * 0.5 + decay_shift),
               "float32")
    u = _both(rng.normal(size=(H, hd)) * 0.5, "float32")
    return r, k, v, lw, u


@pytest.mark.parametrize("B,T,nh,hp,N,chunk", [
    (1, 128, 2, 32, 16, 64), (2, 256, 3, 64, 64, 128), (1, 64, 1, 32, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_oracle_and_pallas(B, T, nh, hp, N, chunk,
                                                  dtype):
    rng = np.random.default_rng(B * 1000 + T + nh)
    ins = _ssm_inputs(rng, B, T, nh, hp, N, dtype)
    y, state = ssm_scan(*(t for _, t in ins))
    assert y.dtype == TORCH_DT[dtype] and y.shape == (B, T, nh, hp)
    assert state.dtype == torch.float32 and state.shape == (B, nh, hp, N)
    tol = 5 * TOLS[dtype]
    jins = [j for j, _ in ins]
    _close(y, ssm_jnp(*jins), tol)
    _close(y, ssm_pallas(*jins, chunk=chunk), tol)


@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (1, 64, 1, 32, 64), (2, 128, 2, 64, 64), (1, 192, 2, 32, 64),
])
def test_rwkv6_wkv_plain_matches_oracle_and_pallas(B, T, H, hd, chunk):
    rng = np.random.default_rng(B * 1000 + T + H)
    ins = _wkv_inputs(rng, B, T, H, hd)
    y, state = rwkv6_wkv(*(t for _, t in ins))
    assert y.dtype == torch.float32 and y.shape == (B, T, H, hd)
    assert state.dtype == torch.float32 and state.shape == (B, H, hd, hd)
    jins = [j for j, _ in ins]
    _close(y, wkv_jnp(*jins), 1e-4)
    _close(y, wkv_pallas(*jins, chunk=chunk), 1e-4)


@pytest.mark.parametrize("T", [77, 200])
def test_scans_take_ragged_lengths(T):
    """Lengths no chunk divides: the plain versions and the models'
    chunked twins (short last chunk) against the jnp stepwise oracles."""
    rng = np.random.default_rng(T)
    ins = _ssm_inputs(rng, 2, T, 3, 32, 16, "float32")
    want = ssm_jnp(*(j for j, _ in ins))
    x, Bm, Cm, dt, A, D = (t for _, t in ins)
    _close(ssm_scan(x, Bm, Cm, dt, A, D)[0], want, 5 * TOLS["float32"])
    y, _ = _ssd_chunked(dt * A, x, Bm, Cm, dt, torch.zeros(2, 3, 32, 16))
    _close(y + D[:, None] * x, want, 5 * TOLS["float32"])
    ins = _wkv_inputs(rng, 2, T, 2, 64)
    want = wkv_jnp(*(j for j, _ in ins))
    r, k, v, lw, u = (t for _, t in ins)
    _close(rwkv6_wkv(r, k, v, lw, u)[0], want, 1e-4)
    _close(_wkv_chunked(r, k, v, lw, u, torch.zeros(2, 2, 64, 64))[0], want,
           1e-4)


def test_wkv_chunked_survives_a_strong_decay():
    """A decay whose cumulative log passes -88 within one chunk: the
    chunked closed form takes only differences within a chunk, so nothing
    overflows and it still matches the stepwise oracle."""
    rng = np.random.default_rng(9)
    ins = _wkv_inputs(rng, 1, 128, 2, 32, decay_shift=1.5)
    assert float(np.asarray(ins[3][0]).sum(axis=1).min()) < -88 * 2
    want = wkv_jnp(*(j for j, _ in ins))
    r, k, v, lw, u = (t for _, t in ins)
    got, state = _wkv_chunked(r, k, v, lw, u, torch.zeros(1, 2, 32, 32))
    assert torch.isfinite(got).all() and torch.isfinite(state).all()
    _close(got, want, 1e-4)


@pytest.mark.parametrize("split", [1, 64, 100])
def test_scans_carry_their_state(split):
    """One call over T = two calls split at `split`, the first call's
    final state passed to the second (1e-5), for the plain versions and
    the chunked twins, from a nonzero initial state."""
    rng = np.random.default_rng(split)
    T = 150
    x, Bm, Cm, dt, A, D = (t for _, t in _ssm_inputs(rng, 2, T, 3, 32, 16,
                                                      "float32"))
    s0 = torch.from_numpy(rng.normal(size=(2, 3, 32, 16)).astype(np.float32))

    def ssm_plain(sl, s):
        return ssm_scan(x[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl], A, D, s)

    def ssm_chunked(sl, s):
        y, s = _ssd_chunked(dt[:, sl] * A, x[:, sl], Bm[:, sl], Cm[:, sl],
                            dt[:, sl], s)
        return y + D[:, None] * x[:, sl], s

    r, k, v, lw, u = (t for _, t in _wkv_inputs(rng, 2, T, 2, 32))
    w0 = torch.from_numpy(rng.normal(size=(2, 2, 32, 32)).astype(np.float32))

    def wkv_plain(sl, s):
        return rwkv6_wkv(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, s)

    def wkv_chunked(sl, s):
        return _wkv_chunked(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, s)

    for fn, s_init in ((ssm_plain, s0), (ssm_chunked, s0),
                       (wkv_plain, w0), (wkv_chunked, w0)):
        y, s = fn(slice(0, T), s_init)
        y1, s1 = fn(slice(0, split), s_init)
        y2, s2 = fn(slice(split, T), s1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(s2, s, atol=1e-5, rtol=1e-5)
    # The plain versions and the chunked twins agree on the final state.
    torch.testing.assert_close(ssm_plain(slice(0, T), s0)[1],
                               ssm_chunked(slice(0, T), s0)[1],
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(wkv_plain(slice(0, T), w0)[1],
                               wkv_chunked(slice(0, T), w0)[1],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
def test_scan_final_state_matches_reference_model(kind):
    """The scans' inputs built from a JAX smoke layer (its own token shift
    and causal conv), then the port's op against the JAX model's chunked
    `S_out` (and its y), 1e-4: the state a prefill leaves for decode."""
    from repro.configs import get_config as ref_get_config
    from repro.models import mamba2 as ref_mamba2
    from repro.models import rwkv6 as ref_rwkv6

    arch = "zamba2-7b" if kind == "ssm_scan" else "rwkv6-7b"
    cfg = ref_get_config(arch).smoke()
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(2, 128, cfg.d_model)).astype(np.float32))
    if kind == "ssm_scan":
        p = ref_mamba2.mamba2_params(jax.random.PRNGKey(5), cfg)
        _, cache = ref_mamba2.mamba2_apply(p, cfg, x, None)
        xin, _ = ref_mamba2._causal_conv(x @ p["wx"], p["conv"], None)
        dt = jax.nn.softplus(x @ p["wdt"] + p["dt_bias"])
        args = (xin.reshape(2, 128, cfg.ssm_heads, cfg.ssm_head_dim),
                x @ p["wB"], x @ p["wC"], dt, -jnp.exp(p["A_log"]), p["D"])
        want_s = cache["ssm"]
    else:
        p = ref_rwkv6.rwkv6_params(jax.random.PRNGKey(5), cfg)
        _, cache = ref_rwkv6.rwkv6_apply(p, cfg, x, None)
        xs = ref_rwkv6._shift(x, None)
        mix = [x * p["mu"][i] + xs * (1 - p["mu"][i]) for i in range(5)]
        H = cfg.d_model // 64
        r, k, v = ((mix[i] @ p[w]).reshape(2, 128, H, 64)
                   for i, w in enumerate(("wr", "wk", "wv")))
        lw = -jnp.exp(p["w0"] + (mix[4] @ p["wA"]) @ p["wB"])
        args = (r, k, v, lw.reshape(2, 128, H, 64), p["u"])
        want_s = cache["state"]
    t_args = [torch.from_numpy(np.array(a, np.float32)) for a in args]
    op = ssm_scan if kind == "ssm_scan" else rwkv6_wkv
    y, state = op(*t_args)
    _close(state, want_s, 1e-4)
    ref_y = (ssm_jnp if kind == "ssm_scan" else wkv_jnp)(*args)
    _close(y, ref_y, 1e-4)


# ------------------------------------ the scan kernels' arithmetic, on CPU
#
# The CUDA scans run every product on the tensor cores in 3xTF32 and
# reorganise the chunked closed form (32-step chunks; C B^T computed once
# per batch row for all heads; the WKV decay factorised between 16-step
# sub-chunks). No kernel runs here, so these plain functions repeat that
# algebra in torch, with TF32 rounding emulated by masking mantissa bits,
# and are held against the stepwise plain versions at the kernels' own
# f32 tolerance (2e-5), at served widths. 1xTF32 must fail that bound.

_LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """x cut to TF32 (10 mantissa bits) as the kernels' `split_tf32` does
    it, by bit operations: rounded to nearest with ties away from zero, or
    truncated."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -0x2000).view(
        torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on TF32 tensor cores: passes 3 is 3xTF32 (hi*hi + hi*lo +
    lo*hi, hi rounded and lo = x - hi truncated), passes 1 a single TF32
    product of the rounded operands."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return al @ bh + ah @ bl + ah @ bh


def _ssd_tensor_core(x, Bm, Cm, dt, A, D, S, passes=3, Q=32):
    """ssm_scan.cu's algebra: per chunk one C B^T per batch row, shared by
    the heads, each head applying exp(P_t - P_s) dt_s; the four products
    through `_mm`."""
    T = x.shape[1]
    S = S.clone()
    ys = []
    for c0 in range(0, T, Q):
        xc, Bc, Cc, dtc = (a[:, c0:c0 + Q] for a in (x, Bm, Cm, dt))
        L = xc.shape[1]
        P = torch.cumsum(dtc * A, dim=1)                          # [B,L,nh]
        G = _mm(Cc, Bc.transpose(1, 2), passes)                   # [B,t,s]
        rel = (P[:, :, None] - P[:, None]).clamp(max=0.0)         # [B,t,s,nh]
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool))
        M = torch.where(causal[None, :, :, None],
                        G[..., None] * torch.exp(rel) * dtc[:, None], 0.0)
        xh = xc.permute(0, 2, 1, 3)                               # [B,nh,s,p]
        y = (torch.exp(P).permute(0, 2, 1)[..., None]
             * _mm(Cc[:, None], S.transpose(-1, -2), passes))
        y = y + _mm(M.permute(0, 3, 1, 2), xh, passes)
        w = (torch.exp(P[:, -1:] - P) * dtc).permute(0, 2, 1)     # [B,nh,s]
        S = (S * torch.exp(P[:, -1])[..., None, None]
             + _mm((xh * w[..., None]).transpose(-1, -2), Bc[:, None],
                   passes))
        ys.append(y.permute(0, 2, 1, 3) + D[:, None] * xc)
    return torch.cat(ys, dim=1), S


def _wkv_tensor_core(r, k, v, lw, u, S, passes=3, Q=32, sub=16):
    """rwkv6_wkv.cu's algebra: base-2 cumulative decays; between
    sub-chunks A[t][s] = (r_t 2^{C[t]-C[m]}) . (k_s 2^{C[m]-C[s+1]}) through
    `_mm`, m the first step of t's sub-chunk; the diagonal blocks with
    explicit exponentials and the bonus in plain f32; A V, (r 2^C) S and
    the state update through `_mm`."""
    r, k, v, lw = (a.permute(0, 2, 1, 3) for a in (r, k, v, lw))  # [B,H,T,hd]
    T = r.shape[2]
    S = S.clone()
    ys = []
    for c0 in range(0, T, Q):
        rc, kc, vc, lc = (a[:, :, c0:c0 + Q] for a in (r, k, v, lw))
        L = rc.shape[2]
        C = torch.cat([torch.zeros_like(lc[:, :, :1]),
                       torch.cumsum(lc * _LOG2E, dim=2)], dim=2)  # [B,H,L+1,hd]
        A = torch.zeros(rc.shape[:2] + (L, L))
        for m in range(0, L, sub):
            t = slice(m, min(m + sub, L))
            n = t.stop - m
            # Diagonal block: s < t explicit, bonus on the diagonal.
            rel = (C[:, :, t, None] - C[:, :, None, m + 1:t.stop + 1]
                   ).clamp(max=0.0)                               # [B,H,t,s,hd]
            blk = torch.einsum("bhtc,bhtsc,bhsc->bhts", rc[:, :, t],
                               torch.exp2(rel), kc[:, :, t])
            lower = torch.tril(torch.ones(n, n, dtype=torch.bool), -1)
            bonus = torch.einsum("bhtc,hc,bhtc->bht", rc[:, :, t], u,
                                 kc[:, :, t])
            A[:, :, t, t] = (torch.where(lower, blk, 0.0)
                             + torch.diag_embed(bonus))
            if m:
                Rt = rc[:, :, t] * torch.exp2(C[:, :, t] - C[:, :, m:m + 1])
                Kt = kc[:, :, :m] * torch.exp2(C[:, :, m:m + 1]
                                               - C[:, :, 1:m + 1])
                A[:, :, t, :m] = _mm(Rt, Kt.transpose(-1, -2), passes)
        CL = C[:, :, L:L + 1]
        y = (_mm(rc * torch.exp2(C[:, :, :L]), S, passes)
             + _mm(A, vc, passes))
        Kh = kc * torch.exp2(CL - C[:, :, 1:])
        S = (torch.exp2(CL).transpose(-1, -2) * S
             + _mm(Kh.transpose(-1, -2), vc, passes))
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), S


def _ssd_case(rng, B, T, nh, hp, N, strong):
    """The tests' SSD inputs, or a strong decay (dt up to 4, A down to
    -30: a chunk's cumulative dt A far below -88)."""
    x, Bm, Cm, dt, A, D = (t for _, t in _ssm_inputs(rng, B, T, nh, hp, N,
                                                      "float32"))
    if strong:
        dt = torch.from_numpy(rng.uniform(0.5, 4.0, size=(B, T, nh)).astype(
            np.float32))
        A = -torch.from_numpy(rng.uniform(5.0, 30.0, size=(nh,)).astype(
            np.float32))
    S0 = torch.from_numpy(rng.normal(size=(B, nh, hp, N)).astype(np.float32))
    return x, Bm, Cm, dt, A, D, S0


def _budget(got, want, tol=2e-5) -> float:
    """Largest |got - want| / (tol + tol |want|): 1 uses the bound up."""
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_tensor_core_algebra_holds_f32_tolerance(strong):
    rng = np.random.default_rng(41 + strong)
    x, Bm, Cm, dt, A, D, S0 = _ssd_case(rng, 1, 999, 2, 64, 64, strong)
    if strong:
        assert (dt[0, :32] * A).sum(0).max().item() < -88
    want_y, want_s = ssm_scan_ref(x, Bm, Cm, dt, A, D, S0)
    y, s = _ssd_tensor_core(x, Bm, Cm, dt, A, D, S0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _budget(y, want_y) <= 1.0
    assert _budget(s, want_s) <= 1.0


@pytest.mark.parametrize("decay_shift", [-1.5, 1.5])
def test_wkv_subchunk_algebra_holds_f32_tolerance(decay_shift):
    rng = np.random.default_rng(43)
    r, k, v, lw, u = (t for _, t in _wkv_inputs(rng, 1, 999, 2, 64,
                                                 decay_shift))
    if decay_shift > 0:
        assert lw[0, :32].sum(0).min().item() < -88
    S0 = torch.from_numpy(rng.normal(size=(1, 2, 64, 64)).astype(np.float32))
    want_y, want_s = rwkv6_wkv_ref(r, k, v, lw, u, S0)
    y, s = _wkv_tensor_core(r, k, v, lw, u, S0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert _budget(y, want_y) <= 1.0
    assert _budget(s, want_s) <= 1.0


@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
def test_one_tf32_product_fails_the_f32_tolerance(kind):
    """The reason for three products: a single TF32 product per operand
    pair misses 2e-5 by orders of magnitude on the same inputs."""
    rng = np.random.default_rng(47)
    if kind == "ssm_scan":
        ins = _ssd_case(rng, 1, 256, 2, 64, 64, False)
        want, _ = ssm_scan_ref(*ins)
        got3, _ = _ssd_tensor_core(*ins)
        got1, _ = _ssd_tensor_core(*ins, passes=1)
    else:
        ins = [t for _, t in _wkv_inputs(rng, 1, 256, 2, 64)]
        ins.append(torch.from_numpy(rng.normal(size=(1, 2, 64, 64)).astype(
            np.float32)))
        want, _ = rwkv6_wkv_ref(*ins)
        got3, _ = _wkv_tensor_core(*ins)
        got1, _ = _wkv_tensor_core(*ins, passes=1)
    assert _budget(got3, want) <= 1.0
    assert _budget(got1, want) > 10.0


def test_tf32_rounding_emulation():
    """_tf32 keeps 10 mantissa bits, rounding to nearest with ties away
    from zero (or truncating); hi + lo of the split holds an f32 to
    ~2^-21."""
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + ulp])
    torch.testing.assert_close(_tf32(x), torch.tensor(
        [1 + ulp, 1.0, -(1 + ulp), 1 + ulp]), atol=0, rtol=0)
    assert _tf32(one).item() == 1.0
    a = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(
        np.float32))
    assert _tf32(torch.tensor([1 + ulp * 0.99]), False).item() == 1.0
    hi = _tf32(a)
    lo = _tf32(a - hi, False)
    assert ((hi - a).abs() <= a.abs() * 2.0 ** -11).all()
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()
