"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: they skip where there is no GPU, and need no JAX, so
the machine with the card runs them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Operands are the model's [B,T,H|KV,hd] tensors handed over as transposed
views, as the attention layer does. The plain version runs in f32 on the
same inputs (bf16 ones upcast exactly). Tolerances: 2e-5 for f32 (IEEE f32
on both sides: TF32 is off). bf16 kernels round the output to bf16 (2**-9
relative) and both attention kernels round P to bf16 before P V: atol
4e-3 / rtol 1.6e-2 per element, and |got - want|_2 / |want|_2 <= 1e-2 per query
row, which a key tile dropped or a padded key left in the softmax sum
exceeds on the rows it touches. The two scans (ssm_scan, rwkv6_wkv) are
held the same way, rows being the last axis of y, from a nonzero initial
state, with their final state (always f32) at 2e-5; their f32 products run
in 3xTF32 on the tensor cores, which keeps that bound.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models.moe import kmajor

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL, BF16_ROW_REL = 4e-3, 1.6e-2, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_matches(got, want):
    """`got` from a kernel, `want` from its plain version in f32."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
        return
    got = got.float()
    torch.testing.assert_close(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
    row_rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert row_rel <= BF16_ROW_REL, f"row relative error {row_rel:.3e}"


def _f32(*xs):
    return tuple(x.float() for x in xs)


def _model_layout(rng, B, T, heads, hd, dtype, dev):
    """A [B,T,heads,hd] tensor, returned as its [B,heads,T,hd] view."""
    x = torch.from_numpy(rng.normal(size=(B, T, heads, hd)).astype(np.float32))
    return x.to(dev, dtype).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,hd", [
    (1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 8, 256, 128),
    (2, 2, 2, 384, 32), (2, 14, 2, 999, 64), (1, 4, 2, 77, 128),
    (2, 4, 4, 256, 112), (1, 3, 3, 333, 112),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_kernel_matches_plain(dev, B, H, KV, T, hd, dtype, window):
    rng = np.random.default_rng(B * 1000 + H * 100 + T + window)
    q = _model_layout(rng, B, T, H, hd, dtype, dev)
    k = _model_layout(rng, B, T, KV, hd, dtype, dev)
    v = _model_layout(rng, B, T, KV, hd, dtype, dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, pos, pos, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.stride() == q.stride()      # written in the model's layout
    _assert_matches(got, attention_ref(*_f32(q, k, v), pos, pos,
                                       window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_offset_queries_and_empty_rows(dev, dtype):
    """Queries at the end of a longer key range (Tq != Tk, both ragged),
    and a row with no admissible key, which the reference gives the
    uniform average of v."""
    rng = np.random.default_rng(11)
    B, H, KV, Tq, Tk, hd = 2, 4, 2, 70, 333, 64
    q = _model_layout(rng, B, Tq, H, hd, dtype, dev)
    k = _model_layout(rng, B, Tk, KV, hd, dtype, dev)
    v = _model_layout(rng, B, Tk, KV, hd, dtype, dev)
    q_pos = torch.arange(Tk - Tq, Tk, dtype=torch.int32, device=dev)
    q_pos[3] = -5                       # precedes every key
    k_pos = torch.arange(Tk, dtype=torch.int32, device=dev)
    for window in (0, 50):
        got = flash_attention(q, k, v, q_pos, k_pos, window=window)
        _assert_matches(got, attention_ref(*_f32(q, k, v), q_pos, k_pos,
                                           window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 17, 63, 127, 128, 129])
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_tile_edges(dev, T, hd, dtype):
    """T below one 64-key tile, and at and across the 128-row block edge,
    at every head dim (hd 112 is zero-padded to 128 in shared memory)."""
    rng = np.random.default_rng(T * 7 + hd)
    B, H, KV = 2, 4, 2
    q = _model_layout(rng, B, T, H, hd, dtype, dev)
    k = _model_layout(rng, B, T, KV, hd, dtype, dev)
    v = _model_layout(rng, B, T, KV, hd, dtype, dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    for window in (0, 40):
        got = flash_attention(q, k, v, pos, pos, window=window)
        assert got.stride() == q.stride()
        _assert_matches(got, attention_ref(*_f32(q, k, v), pos, pos,
                                           window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_flash_kernel_offsets_and_empty_rows_every_head_dim(dev, hd):
    """Tq != Tk with the queries at the end, across the 128-row edge; one
    row with no admissible key (uniform average) and a window < T."""
    rng = np.random.default_rng(hd)
    B, H, KV, Tq, Tk = 2, 4, 1, 130, 515
    q = _model_layout(rng, B, Tq, H, hd, torch.bfloat16, dev)
    k = _model_layout(rng, B, Tk, KV, hd, torch.bfloat16, dev)
    v = _model_layout(rng, B, Tk, KV, hd, torch.bfloat16, dev)
    q_pos = torch.arange(Tk - Tq, Tk, dtype=torch.int32, device=dev)
    q_pos[129] = -5                     # in the second 128-row block
    k_pos = torch.arange(Tk, dtype=torch.int32, device=dev)
    for window in (0, 100):
        got = flash_attention(q, k, v, q_pos, k_pos, window=window)
        _assert_matches(got, attention_ref(*_f32(q, k, v), q_pos, k_pos,
                                           window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("B,KV,G,S,hd", [
    (1, 2, 4, 512, 64), (2, 1, 8, 1024, 128), (2, 4, 1, 512, 64),
    (8, 2, 7, 1031, 64), (3, 2, 16, 100, 32), (64, 8, 2, 300, 64),
    (2, 4, 1, 512, 112), (8, 32, 1, 1031, 112),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(dev, B, KV, G, S, hd, dtype):
    rng = np.random.default_rng(B * 1000 + KV * 100 + G * 10 + S)
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)
                         ).to(dev, dtype)
    k = _model_layout(rng, B, S, KV, hd, dtype, dev)
    v = _model_layout(rng, B, S, KV, hd, dtype, dev)
    pos = S - S // 3
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    n0 = decode_attention.launches
    got = decode_attention(q, k, v, k_pos, pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    _assert_matches(got, decode_attention_ref(*_f32(q, k, v), k_pos, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [0, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_ring_positions_and_sentinel(dev, empty, dtype):
    rng = np.random.default_rng(3 + empty)
    B, KV, G, S, hd = 2, 2, 7, 256, 64
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)
                         ).to(dev, dtype)
    k = _model_layout(rng, B, S, KV, hd, dtype, dev)
    v = _model_layout(rng, B, S, KV, hd, dtype, dev)
    last = 300
    k_pos = last - ((last - np.arange(S)) % S)
    k_pos[rng.choice(S, size=empty, replace=False)] = 2 ** 30
    k_pos = torch.from_numpy(k_pos.astype(np.int32)).to(dev)
    got = decode_attention(q, k, v, k_pos, last)
    _assert_matches(got, decode_attention_ref(*_f32(q, k, v), k_pos, last))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 63, 64, 65, 127, 129, 191, 193])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_short_and_ragged_caches(dev, S, dtype):
    """S below one 64-slot tile and at 64 k +- 1 (a ragged last tile)."""
    rng = np.random.default_rng(S)
    B, KV, G, hd = 3, 2, 7, 64
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)
                         ).to(dev, dtype)
    k = _model_layout(rng, B, S, KV, hd, dtype, dev)
    v = _model_layout(rng, B, S, KV, hd, dtype, dev)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    for pos in (S - 1, S // 2):
        got = decode_attention(q, k, v, k_pos, pos)
        _assert_matches(got, decode_attention_ref(*_f32(q, k, v), k_pos,
                                                  pos))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 7, 8, 16])
@pytest.mark.parametrize("hd", [112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_group_sizes(dev, G, hd, dtype):
    """Every lane mapping of scores and P V: G 1..16 at the wide head
    dims (hd 112 leaves two of 16 lanes idle per slot)."""
    rng = np.random.default_rng(G * 1000 + hd)
    B, KV, S = 2, 3, 777
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)
                         ).to(dev, dtype)
    k = _model_layout(rng, B, S, KV, hd, dtype, dev)
    v = _model_layout(rng, B, S, KV, hd, dtype, dev)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, k_pos, 700)
    _assert_matches(got, decode_attention_ref(*_f32(q, k, v), k_pos, 700))


@pytest.mark.cuda
@pytest.mark.parametrize("B,KV,G,S,hd,n_split", [
    (128, 32, 1, 200, 64, 1),        # enough groups: one run each
    (1, 1, 4, 64 * 64, 112, 64),     # the most runs a group gets
    (1, 1, 2, 64 * 64 * 3 + 5, 64, 49),    # capped: runs of 4 tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_split_extremes(dev, B, KV, G, S, hd, n_split, dtype):
    from repro_torch.kernels.decode_attention import kernel as dk
    assert dk.split(B, KV, S, 132)[0] == n_split     # the H100's 132 SMs
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)
                         ).to(dev, dtype)
    k = _model_layout(rng, B, S, KV, hd, dtype, dev)
    v = _model_layout(rng, B, S, KV, hd, dtype, dev)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    for pos in (S - 1, S - 1):         # twice: the merge counters reset
        got = decode_attention(q, k, v, k_pos, pos)
        _assert_matches(got, decode_attention_ref(*_f32(q, k, v), k_pos,
                                                  pos))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,G", [(112, 1), (128, 16), (64, 7), (128, 1)])
def test_decode_kernel_ring_and_sentinel_wide(dev, hd, G):
    """A ring cache's slot -> position map with empty (2**30) slots, and
    one where every slot is empty (uniform average over the cache)."""
    rng = np.random.default_rng(hd + G)
    B, KV, S = 2, 2, 300
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    k = _model_layout(rng, B, S, KV, hd, torch.bfloat16, dev)
    v = _model_layout(rng, B, S, KV, hd, torch.bfloat16, dev)
    last = 1000
    ring = last - ((last - np.arange(S)) % S)
    ring[rng.choice(S, size=50, replace=False)] = 2 ** 30
    for k_pos in (ring, np.full(S, 2 ** 30)):
        kp = torch.from_numpy(k_pos.astype(np.int32)).to(dev)
        got = decode_attention(q, k, v, kp, last)
        _assert_matches(got, decode_attention_ref(*_f32(q, k, v), kp, last))


@pytest.mark.cuda
def test_decode_kernel_on_two_streams_at_once(dev):
    """Decode calls that overlap on two streams of one device, each cut
    into many runs merged in the same launch: each stream has its own
    arrival counters, so both outputs match the plain version."""
    rng = np.random.default_rng(7)
    B, KV, G, S, hd = 8, 32, 1, 1031, 112      # zamba2-7b's served decode
    from repro_torch.kernels.decode_attention import kernel as dk
    assert dk.split(B, KV, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0] > 1
    cases = []
    for _ in range(2):
        q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(
            np.float32)).to(dev, torch.bfloat16)
        k = _model_layout(rng, B, S, KV, hd, torch.bfloat16, dev)
        v = _model_layout(rng, B, S, KV, hd, torch.bfloat16, dev)
        cases.append((q, k, v))
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for s, case, out in zip(streams, cases, outs):
            with torch.cuda.stream(s):
                out.append(decode_attention(*case, k_pos, S - 1))
    torch.cuda.synchronize()
    for case, out in zip(cases, outs):
        want = decode_attention_ref(*_f32(*case), k_pos, S - 1)
        for got in out:
            _assert_matches(got, want)


@pytest.mark.cuda
def test_kernels_refuse_misaligned_operands(dev):
    """Views offset by one element cannot be read by 16-byte copies: the
    wrappers raise, with no fallback."""
    B, T, H, hd = 1, 64, 2, 64
    n0 = (flash_attention.launches, decode_attention.launches)
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(B * T * H * hd + 1, device=dev, dtype=dtype)
        bad = flat[1:].view(B, T, H, hd).transpose(1, 2)
        good = torch.zeros(B, H, T, hd, device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(bad, good, good)
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(good, good, bad)
        with pytest.raises(ValueError, match="16-byte"):
            decode_attention(bad[:, :, :1], good, good)
        with pytest.raises(ValueError, match="16-byte"):
            decode_attention(good[:, :, :1], bad, good)
    assert (flash_attention.launches, decode_attention.launches) == n0
    # The scans read x, Bm, Cm (ssm_scan) and r, k, v, lw (rwkv6_wkv) by
    # 16-byte copies too.
    n0 = (ssm_scan.launches, rwkv6_wkv.launches)
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        x, Bm, Cm, dt, A, D, _ = _ssm_case(rng, 1, 40, 2, 32, 16, dtype, dev)
        flat = torch.zeros(x.numel() + 1, device=dev, dtype=dtype)
        xbad = flat[1:].view(x.shape)
        wide = torch.zeros(1, 40, 17, device=dev, dtype=dtype)
        bbad = wide[..., 1:]                          # base off by 1 element
        with pytest.raises(ValueError, match="16-byte"):
            ssm_scan(xbad, Bm, Cm, dt, A, D)
        with pytest.raises(ValueError, match="16-byte"):
            ssm_scan(x, bbad, Cm, dt, A, D)
        with pytest.raises(ValueError, match="16-byte"):
            ssm_scan(x, Bm, torch.zeros(1, 40, 18, device=dev,
                                        dtype=dtype)[..., :16], dt, A, D)
        r, k, v, lw, u, _ = _wkv_case(rng, 1, 40, 2, 32, dtype, dev)
        rbad = torch.zeros(r.numel() + 1, device=dev, dtype=dtype)[1:].view(
            r.shape)
        for args in ((rbad, k, v, lw), (r, k, v, rbad)):
            with pytest.raises(ValueError, match="16-byte"):
                rwkv6_wkv(*args, u)
    assert (ssm_scan.launches, rwkv6_wkv.launches) == n0


def _randn(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dev, dtype)


def _ssm_case(rng, B, T, nh, hp, N, dtype, dev):
    """The reference sweep's inputs and a nonzero initial state."""
    x = _randn(rng, (B, T, nh, hp), dev, dtype)
    Bm = _randn(rng, (B, T, N), dev, dtype, 0.5)
    Cm = _randn(rng, (B, T, N), dev, dtype, 0.5)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, size=(B, T, nh)).astype(
        np.float32)).to(dev)
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, size=(nh,)).astype(
        np.float32)).to(dev)
    D = _randn(rng, (nh,), dev)
    s0 = _randn(rng, (B, nh, hp, N), dev)
    return x, Bm, Cm, dt, A, D, s0


def _wkv_case(rng, B, T, H, hd, dtype, dev, decay_shift=-1.5):
    r, k, v = (_randn(rng, (B, T, H, hd), dev, dtype, 0.5) for _ in range(3))
    lw = -torch.exp(_randn(rng, (B, T, H, hd), dev, scale=0.5)
                    + decay_shift).to(dtype)
    u = _randn(rng, (H, hd), dev, scale=0.5)
    s0 = _randn(rng, (B, H, hd, hd), dev)
    return r, k, v, lw, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nh,hp,N", [
    (1, 128, 2, 32, 16), (2, 256, 3, 64, 64), (1, 64, 1, 32, 32),
    (2, 77, 3, 64, 64), (1, 1, 2, 32, 16), (8, 999, 8, 64, 64),
    (2, 130, 4, 64, 16), (1, 200, 2, 32, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_matches_plain(dev, B, T, nh, hp, N, dtype):
    rng = np.random.default_rng(B * 1000 + T + nh)
    x, Bm, Cm, dt, A, D, s0 = _ssm_case(rng, B, T, nh, hp, N, dtype, dev)
    n0 = ssm_scan.launches
    y, state = ssm_scan(x, Bm, Cm, dt, A, D, s0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == n0 + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    want_y, want_s = ssm_scan_ref(*_f32(x, Bm, Cm), dt, A, D, s0)
    _assert_matches(y, want_y)
    torch.testing.assert_close(state, want_s, atol=F32_TOL, rtol=F32_TOL)
    # From zeros (state=None), as the TPU kernel runs.
    y0, _ = ssm_scan(x, Bm, Cm, dt, A, D)
    _assert_matches(y0, ssm_scan_ref(*_f32(x, Bm, Cm), dt, A, D)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [
    (1, 64, 1, 32), (2, 128, 2, 64), (1, 192, 2, 32), (2, 77, 3, 64),
    (1, 1, 2, 64), (8, 999, 4, 64), (2, 200, 2, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_matches_plain(dev, B, T, H, hd, dtype):
    rng = np.random.default_rng(B * 1000 + T + H)
    r, k, v, lw, u, s0 = _wkv_case(rng, B, T, H, hd, dtype, dev)
    n0 = rwkv6_wkv.launches
    y, state = rwkv6_wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches == n0 + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    want_y, want_s = rwkv6_wkv_ref(*_f32(r, k, v, lw), u, s0)
    _assert_matches(y, want_y)
    torch.testing.assert_close(state, want_s, atol=F32_TOL, rtol=F32_TOL)
    y0, _ = rwkv6_wkv(r, k, v, lw, u)
    _assert_matches(y0, rwkv6_wkv_ref(*_f32(r, k, v, lw), u)[0])


@pytest.mark.cuda
def test_wkv_kernel_survives_a_strong_decay(dev):
    """A chunk's cumulative log decay far below -88: the kernel takes only
    differences within a chunk, so nothing overflows."""
    rng = np.random.default_rng(9)
    r, k, v, lw, u, s0 = _wkv_case(rng, 2, 200, 2, 64, torch.float32, dev,
                                   decay_shift=1.5)
    y, state = rwkv6_wkv(r, k, v, lw, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want_y, want_s = rwkv6_wkv_ref(r, k, v, lw, u, s0)
    _assert_matches(y, want_y)
    torch.testing.assert_close(state, want_s, atol=F32_TOL, rtol=F32_TOL)


def _check_scan(got, want):
    """A scan's (y, final state) against its plain version's."""
    _assert_matches(got[0], want[0])
    assert got[1].dtype == torch.float32
    torch.testing.assert_close(got[1], want[1], atol=F32_TOL, rtol=F32_TOL)


SCAN_TS = [1, 2, 15, 16, 17, 63, 64, 65, 127, 128, 129]


@pytest.mark.cuda
@pytest.mark.parametrize("T", SCAN_TS)
@pytest.mark.parametrize("hp", [32, 64])
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_tile_edges(dev, T, hp, N, dtype):
    """Lengths around the 16-step tiles and the 32-step chunk, every head
    and state width, an odd head count (the last head group half full)."""
    rng = np.random.default_rng(T * 100 + hp + N)
    x, Bm, Cm, dt, A, D, s0 = _ssm_case(rng, 2, T, 3, hp, N, dtype, dev)
    got = ssm_scan(x, Bm, Cm, dt, A, D, s0)
    torch.cuda.synchronize()
    _check_scan(got, ssm_scan_ref(*_f32(x, Bm, Cm), dt, A, D, s0))


@pytest.mark.cuda
@pytest.mark.parametrize("T", SCAN_TS)
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_tile_edges(dev, T, hd, dtype):
    """Lengths around the 16-step sub-chunks and the 32-step chunk."""
    rng = np.random.default_rng(T * 100 + hd)
    r, k, v, lw, u, s0 = _wkv_case(rng, 2, T, 3, hd, dtype, dev)
    got = rwkv6_wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    _check_scan(got, rwkv6_wkv_ref(*_f32(r, k, v, lw), u, s0))


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [1, 3, 7, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_head_groups(dev, nh, dtype):
    """The block's group of two heads sharing C B^T: full groups, a last
    group with one head, and the served width."""
    rng = np.random.default_rng(nh)
    x, Bm, Cm, dt, A, D, s0 = _ssm_case(rng, 2, 77, nh, 64, 64, dtype, dev)
    got = ssm_scan(x, Bm, Cm, dt, A, D, s0)
    torch.cuda.synchronize()
    _check_scan(got, ssm_scan_ref(*_f32(x, Bm, Cm), dt, A, D, s0))


@pytest.mark.cuda
def test_ssm_kernel_survives_a_strong_decay(dev):
    """dt up to 4 and A down to -30: a chunk's cumulative dt A lies far
    below -88, where exp(-P) would overflow f32. The kernel takes only
    differences within a chunk, so y and the state stay finite and match."""
    rng = np.random.default_rng(13)
    x, Bm, Cm, _, _, D, s0 = _ssm_case(rng, 2, 200, 3, 64, 64, torch.float32,
                                       dev)
    dt = torch.from_numpy(rng.uniform(0.5, 4.0, size=(2, 200, 3)).astype(
        np.float32)).to(dev)
    A = -torch.from_numpy(rng.uniform(5.0, 30.0, size=(3,)).astype(
        np.float32)).to(dev)
    assert (dt[:, :32] * A).sum(1).max().item() < -88
    y, state = ssm_scan(x, Bm, Cm, dt, A, D, s0)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _check_scan((y, state), ssm_scan_ref(x, Bm, Cm, dt, A, D, s0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
@pytest.mark.parametrize("split", [1, 16, 31, 32, 100])
def test_scan_kernels_carry_their_state(dev, kind, split):
    """One call over T + T' equals a call over T and one over T' from its
    final state, on the card."""
    rng = np.random.default_rng(split)
    T = 160
    if kind == "ssm_scan":
        *ins, s0 = _ssm_case(rng, 2, T, 3, 64, 64, torch.float32, dev)
        op = ssm_scan
    else:
        *ins, s0 = _wkv_case(rng, 2, T, 3, 64, torch.float32, dev)
        op = rwkv6_wkv

    def run(sl, state):    # the first four operands run along T
        return op(*(a[:, sl] for a in ins[:4]), *ins[4:], state)

    y, s = run(slice(0, T), s0)
    y1, s1 = run(slice(0, split), s0)
    y2, s2 = run(slice(split, T), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=F32_TOL,
                               rtol=F32_TOL)
    torch.testing.assert_close(s2, s, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_read_strided_views(dev, dtype):
    """Operands as views into wider tensors (as a fused projection would
    hand them over) and dt transposed: read through their strides, the
    same answer as contiguous copies."""
    rng = np.random.default_rng(3)
    B, T, nh, hp, N = 2, 77, 3, 64, 32
    x, Bm, Cm, dt, A, D, s0 = _ssm_case(rng, B, T, nh, hp, N, dtype, dev)
    xw = torch.zeros(B, T, nh + 1, hp + 8, device=dev, dtype=dtype)
    xw[:, :, 1:, 8:] = x
    bc = torch.zeros(B, T, 2 * N + 8, device=dev, dtype=dtype)
    bc[..., :N], bc[..., N + 8:] = Bm, Cm
    dtw = dt.transpose(1, 2).contiguous().transpose(1, 2)
    views = (xw[:, :, 1:, 8:], bc[..., :N], bc[..., N + 8:], dtw)
    assert not any(v.is_contiguous() for v in views)
    got = ssm_scan(*views, A, D, s0)
    for a, b in zip(got, ssm_scan(x, Bm, Cm, dt, A, D, s0)):
        assert torch.equal(a, b)
    _check_scan(got, ssm_scan_ref(*_f32(x, Bm, Cm), dt, A, D, s0))

    r, k, v, lw, u, w0 = _wkv_case(rng, B, T, nh, 64, dtype, dev)
    big = torch.zeros(B, T, nh, 4 * 64 + 8, device=dev, dtype=dtype)
    for i, t in enumerate((r, k, v, lw)):
        big[..., 8 + 64 * i:8 + 64 * (i + 1)] = t
    views = [big[..., 8 + 64 * i:8 + 64 * (i + 1)] for i in range(4)]
    got = rwkv6_wkv(*views, u, w0)
    for a, b in zip(got, rwkv6_wkv(r, k, v, lw, u, w0)):
        assert torch.equal(a, b)
    _check_scan(got, rwkv6_wkv_ref(*_f32(r, k, v, lw), u, w0))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 2, 8, 48, device=dev)          # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x)
    y = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        decode_attention(y[:, :, :2], y, y)

    rng = np.random.default_rng(0)
    x, Bm, Cm, dt, A, D, s0 = _ssm_case(rng, 1, 16, 2, 32, 16,
                                        torch.float32, dev)
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    with pytest.raises(ValueError, match="CUDA"):    # a CPU tensor
        ssm_kernel.ssm_scan(x.cpu(), Bm.cpu(), Cm.cpu(), dt.cpu(), A.cpu(),
                            D.cpu())
    with pytest.raises(ValueError, match="is on"):   # devices mixed
        ssm_scan(x, Bm, Cm, dt.cpu(), A, D)
    with pytest.raises(TypeError):                   # a wrong dtype
        ssm_scan(x.half(), Bm.half(), Cm.half(), dt, A, D)
    with pytest.raises(TypeError):
        ssm_scan(x, Bm, Cm, dt.bfloat16(), A, D)
    with pytest.raises(ValueError, match="state"):   # a wrong state shape
        ssm_scan(x, Bm, Cm, dt, A, D, s0[..., :8].contiguous())
    with pytest.raises(ValueError, match="state"):
        ssm_scan(x, Bm, Cm, dt, A, D, s0.double())

    r, k, v, lw, u, w0 = _wkv_case(rng, 1, 16, 2, 64, torch.float32, dev)
    from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.rwkv6_wkv(r.cpu(), k.cpu(), v.cpu(), lw.cpu(), u.cpu())
    with pytest.raises(ValueError, match="is on"):
        rwkv6_wkv(r, k, v, lw, u.cpu())
    with pytest.raises(TypeError):
        rwkv6_wkv(r, k, v.bfloat16(), lw, u)
    with pytest.raises(ValueError, match="state"):
        rwkv6_wkv(r, k, v, lw, u, w0[:, :1].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_wkv(*(t[..., :48] for t in (r, k, v, lw)), u[:, :48])


# -- training: the forward's LSE, the backward kernel, the grad guards -----
# The backward is held against its plain version (explicit formulas in f32)
# on the same inputs: the kernel's own output o and LSE, and the same dO.
# f32 at 2e-5 relative to the largest |want| (IEEE f32 on both sides, sums
# over up to G * Tq terms in another order); bf16 rounds P and dS to bf16
# as mma operands and the gradients to bf16: per row |got - want|_2 /
# |want|_2 <= 2e-2. A row whose exact gradient vanishes (the first query's
# dq: it sees key 0 alone, P = 1, dP - D = 0; all of dq at T = 1) has no
# relative scale, so rows are measured against max(|want|_2, 1e-3 x the
# mean row norm of the three gradients).

BWD_ROW_REL = 2e-2


def bwd_row_rel(got, want, wants):
    """Largest |got - want|_2 / max(|want|_2, 1e-3 R) over the last axis's
    rows, R the mean row norm over `wants` (dq, dk and dv together)."""
    got, want = got.float(), want.float()
    R = torch.cat([w.float().norm(dim=-1).flatten() for w in wants]).mean()
    return ((got - want).norm(dim=-1)
            / torch.maximum(want.norm(dim=-1), 1e-3 * R)).max().item()


def _bwd_case(rng, B, H, KV, Tq, Tk, hd, dtype, dev, window=0, lost=False):
    from repro_torch.kernels.flash_attention import kernel as fk

    q = _model_layout(rng, B, Tq, H, hd, dtype, dev)
    k = _model_layout(rng, B, Tk, KV, hd, dtype, dev)
    v = _model_layout(rng, B, Tk, KV, hd, dtype, dev)
    do = _model_layout(rng, B, Tq, H, hd, dtype, dev)
    q_pos = torch.arange(Tk - Tq, Tk, dtype=torch.int32, device=dev)
    if lost:
        q_pos[min(3, Tq - 1)] = -5          # precedes every key
    k_pos = torch.arange(Tk, dtype=torch.int32, device=dev)
    o, lse = fk.flash_attention(q, k, v, q_pos, k_pos, window, with_lse=True)
    return q, k, v, o, lse, do, q_pos, k_pos


def _assert_grad_matches(name, got, want, wants):
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        assert err <= 2e-5 * scale, f"{name}: {err:.3e} vs {scale:.3e}"
        return
    rel = bwd_row_rel(got, want, wants)
    assert rel <= BWD_ROW_REL, f"{name}: row relative error {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,window,lost", [
    (2, 14, 2, 256, 256, 64, 0, False),     # qwen2-0.5b's GQA, G 7
    (1, 14, 2, 999, 999, 64, 256, False),   # ragged, windowed
    (2, 4, 1, 77, 333, 64, 50, True),       # Tq != Tk, a lost row
    (1, 8, 1, 130, 515, 128, 0, True),
    (2, 16, 2, 200, 200, 128, 8192, False),  # hd 128 at G 8, window >= T
    (1, 2, 2, 1, 1, 64, 0, False),
    (2, 8, 2, 300, 300, 32, 0, False),      # the smoke configs' hd 32
    (1, 4, 4, 333, 333, 112, 64, True),     # zamba2's hd 112, a lost row
    (1, 14, 2, 2048, 2048, 64, 0, False),   # the whole causal schedule
    (1, 40, 8, 640, 640, 128, 8192, False),  # llama4-scout's heads, G 5
    (1, 48, 8, 640, 640, 128, 0, False),    # internvl2-26b's heads, G 6
    (2, 24, 24, 64 + 333, 64 + 333, 64, 0, False),  # musicgen, G 1: a
    # 64-row prefix at positions 0..63 before 333 tokens, P + T ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(dev, B, H, KV, Tq, Tk, hd, window,
                                        lost, dtype):
    from repro_torch.kernels.flash_attention.ref import lse_ref
    from repro_torch.kernels.flash_attention_bwd.ops import \
        flash_attention_bwd
    from repro_torch.kernels.flash_attention_bwd.ref import \
        flash_attention_bwd_ref

    rng = np.random.default_rng(Tq * 3 + Tk + hd + window)
    q, k, v, o, lse, do, q_pos, k_pos = _bwd_case(
        rng, B, H, KV, Tq, Tk, hd, dtype, dev, window, lost)
    want_lse = lse_ref(*_f32(q, k), q_pos, k_pos, window)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    tol = F32_TOL if dtype == torch.float32 else 1e-4
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, q_pos, k_pos, window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    want = flash_attention_bwd_ref(*_f32(q, k, v, o), lse, do.float(),
                                   q_pos, k_pos, window)
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == dtype and g.stride() == like.stride(), name
        _assert_grad_matches(name, g, w, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic(dev, dtype, hd):
    """No float atomics: two launches give bit-identical gradients."""
    from repro_torch.kernels.flash_attention_bwd.ops import \
        flash_attention_bwd

    rng = np.random.default_rng(5)
    args = _bwd_case(rng, 2, 14, 2, 640, 640, hd, dtype, dev)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_flash_attention_autograd_runs_both_kernels(dev, hd):
    """Under autograd the op's forward writes the LSE and its backward
    launches the backward kernel; the gradients equal the backward
    kernel's on the forward's own o and LSE, and serving's forward (no
    grad) is the same output."""
    from repro_torch.kernels.flash_attention_bwd.ops import \
        flash_attention_bwd

    rng = np.random.default_rng(hd)
    q, k, v, o, lse, do, q_pos, k_pos = _bwd_case(
        rng, 2, 8, 2, 190, 190, hd, torch.bfloat16, dev, window=64)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, q_pos, k_pos, window=64)
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n_fwd + 1
    assert flash_attention_bwd.launches == n_bwd + 1
    assert torch.equal(out.detach(), o)
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v, q_pos, k_pos, 64), o)
    for g, w in zip(grads, flash_attention_bwd(q, k, v, o, lse, do, q_pos,
                                               k_pos, 64)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_a_gradient(dev):
    """decode_attention and the int8 GEMM raise on CUDA when a gradient is
    asked of their inputs, rather than dropping it (decode with its own
    reason: no training path decodes); with grad mode off they run. The
    scans and attention have backward kernels: a gradient through
    ssm_scan, rwkv6_wkv and attention at hd 112 runs and is finite."""
    rng = np.random.default_rng(3)
    qd = torch.zeros(1, 2, 4, 64, device=dev, requires_grad=True)
    kc = torch.zeros(1, 2, 16, 64, device=dev)
    with pytest.raises(NotImplementedError, match="decoding is not trained"):
        decode_attention(qd, kc, kc)
    with torch.no_grad():
        decode_attention(qd, kc, kc)
    x, Bm, Cm, dt, A, D, _ = _ssm_case(rng, 1, 16, 2, 32, 16,
                                       torch.float32, dev)
    grad, = torch.autograd.grad(
        ssm_scan(x.requires_grad_(), Bm, Cm, dt, A, D)[0].sum(), x)
    assert grad.shape == x.shape and torch.isfinite(grad).all()
    r, k, v, lw, u, _ = _wkv_case(rng, 1, 16, 2, 64, torch.float32, dev)
    grad, = torch.autograd.grad(
        rwkv6_wkv(r, k, v, lw, u.requires_grad_())[0].sum(), u)
    assert grad.shape == u.shape and torch.isfinite(grad).all()
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    a = torch.ones(2, 16, 32, dtype=torch.int8, device=dev)
    b = torch.ones(2, 32, 16, dtype=torch.int8, device=dev)
    assert int8_grouped_matmul(a, b).eq(32).all()   # int8 needs no grad
    x112 = torch.zeros(1, 2, 8, 112, device=dev, requires_grad=True)
    grad, = torch.autograd.grad(flash_attention(x112, x112, x112).sum(),
                                x112)
    assert grad.shape == x112.shape and torch.isfinite(grad).all()


# -- the scans' backward kernels ------------------------------------------
# The plain backwards (the stepwise formulas) run in f32 on the same,
# exactly upcast inputs; each gradient is held relative to its largest
# entry: 2e-5 in f32 (and for the f32 gradients of a bf16 call: dt, A, D,
# u, the state); the bf16 gradients are the f32 ones rounded once, so
# 4e-3 (twice bf16's 2**-9).

BWD_BF16_TOL = 4e-3


def _assert_grads(got, want, dtype, names):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        tol = F32_TOL if g.dtype == torch.float32 else BWD_BF16_TOL
        assert g.dtype == (torch.float32 if g.dtype == torch.float32
                           else dtype), name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= tol, f"{name}: {rel:.3e} of max|want| (tol {tol:g})"


def _ssm_bwd_case(rng, B, T, nh, hp, N, dtype, dev, strong=False):
    x, Bm, Cm, dt, A, D, s0 = _ssm_case(rng, B, T, nh, hp, N, dtype, dev)
    if strong:     # a chunk's cumulative dt A far below -88
        dt = torch.from_numpy(rng.uniform(0.5, 4.0, (B, T, nh)).astype(
            np.float32)).to(dev)
        A = -torch.from_numpy(rng.uniform(5.0, 30.0, (nh,)).astype(
            np.float32)).to(dev)
    dy = _randn(rng, (B, T, nh, hp), dev, dtype)
    ds = _randn(rng, (B, nh, hp, N), dev)
    return x, Bm, Cm, dt, A, D, s0, dy, ds


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,nh,hp,N", [
    (2, 77, 3, 32, 16), (2, 256, 4, 64, 64), (1, 999, 3, 64, 64),
    (2, 40, 2, 64, 32), (1, 1, 2, 32, 16), (2, 65, 5, 64, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_bwd_kernel_matches_plain(dev, B, T, nh, hp, N, dtype,
                                      with_state):
    """The backward kernel on the forward kernel's chunk states, against
    the plain backward; from a nonzero state with a final-state gradient,
    or from zeros with none."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd.ops import ssm_scan_bwd
    from repro_torch.kernels.ssm_scan_bwd.ref import ssm_scan_bwd_ref

    rng = np.random.default_rng(B * 1000 + T + nh)
    x, Bm, Cm, dt, A, D, s0, dy, ds = _ssm_bwd_case(rng, B, T, nh, hp, N,
                                                    dtype, dev)
    s0, ds = (s0, ds) if with_state else (None, None)
    _, _, states = sk.ssm_scan(x, Bm, Cm, dt, A, D, s0, with_states=True)
    n0 = ssm_scan_bwd.launches
    got = ssm_scan_bwd(x, Bm, Cm, dt, A, D, states, dy, ds)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == n0 + 1
    want = ssm_scan_bwd_ref(*_f32(x, Bm, Cm), dt, A, D, s0, dy.float(), ds)
    _assert_grads(got, want, dtype, ("dx", "dBm", "dCm", "ddt", "dA", "dD",
                                     "dstate"))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [
    (2, 77, 3, 32), (2, 128, 2, 64), (1, 999, 2, 64), (1, 1, 2, 64),
    (2, 33, 4, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay_shift", [-6.0, -1.5, 1.5])
def test_wkv_bwd_kernel_matches_plain(dev, B, T, H, hd, dtype, decay_shift):
    """A weak decay (the models' w0 = -6), the sweep's and a strong one,
    from a nonzero state with a final-state gradient."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv_bwd.ops import rwkv6_wkv_bwd
    from repro_torch.kernels.rwkv6_wkv_bwd.ref import rwkv6_wkv_bwd_ref

    rng = np.random.default_rng(B * 1000 + T + H)
    r, k, v, lw, u, s0 = _wkv_case(rng, B, T, H, hd, dtype, dev,
                                   decay_shift)
    dy = _randn(rng, (B, T, H, hd), dev, dtype)
    ds = _randn(rng, (B, H, hd, hd), dev)
    _, _, states = wk.rwkv6_wkv(r, k, v, lw, u, s0, with_states=True)
    n0 = rwkv6_wkv_bwd.launches
    got = rwkv6_wkv_bwd(r, k, v, lw, u, states, dy, ds)
    torch.cuda.synchronize()
    assert rwkv6_wkv_bwd.launches == n0 + 1
    want = rwkv6_wkv_bwd_ref(*_f32(r, k, v, lw), u, s0, dy.float(), ds)
    _assert_grads(got, want, dtype, ("dr", "dk", "dv", "dlw", "du",
                                     "dstate"))


@pytest.mark.cuda
def test_ssm_bwd_kernel_survives_a_strong_decay(dev):
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd import kernel as sbk
    from repro_torch.kernels.ssm_scan_bwd.ref import ssm_scan_bwd_ref

    rng = np.random.default_rng(11)
    x, Bm, Cm, dt, A, D, s0, dy, ds = _ssm_bwd_case(
        rng, 2, 200, 3, 64, 64, torch.float32, dev, strong=True)
    _, _, states = sk.ssm_scan(x, Bm, Cm, dt, A, D, s0, with_states=True)
    got = sbk.ssm_scan_bwd(x, Bm, Cm, dt, A, D, states, dy, ds)
    want = ssm_scan_bwd_ref(x, Bm, Cm, dt, A, D, s0, dy, ds)
    _assert_grads(got, want, torch.float32, ("dx", "dBm", "dCm", "ddt",
                                             "dA", "dD", "dstate"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernels_are_deterministic(dev, dtype):
    """No float atomics: two launches give the same bits."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv_bwd import kernel as wbk
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd import kernel as sbk

    rng = np.random.default_rng(5)
    x, Bm, Cm, dt, A, D, s0, dy, ds = _ssm_bwd_case(rng, 2, 333, 8, 64, 64,
                                                    dtype, dev)
    _, _, st = sk.ssm_scan(x, Bm, Cm, dt, A, D, s0, with_states=True)
    a = sbk.ssm_scan_bwd(x, Bm, Cm, dt, A, D, st, dy, ds)
    b = sbk.ssm_scan_bwd(x, Bm, Cm, dt, A, D, st, dy, ds)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    r, k, v, lw, u, s0 = _wkv_case(rng, 2, 333, 4, 64, dtype, dev)
    dy = _randn(rng, (2, 333, 4, 64), dev, dtype)
    _, _, st = wk.rwkv6_wkv(r, k, v, lw, u, s0, with_states=True)
    a = wbk.rwkv6_wkv_bwd(r, k, v, lw, u, st, dy)
    b = wbk.rwkv6_wkv_bwd(r, k, v, lw, u, st, dy)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, 32, 33])
@pytest.mark.parametrize("nh,hp,N", [
    (3, 64, 64), (5, 64, 32), (1, 32, 16), (3, 32, 32), (2, 32, 64),
    (3, 64, 16),
])
def test_ssm_bwd_kernel_tile_edges(dev, T, nh, hp, N):
    """The backward's tiling at its edges: one step, a chunk short of,
    exactly and one past 32 steps; an odd head count (a block's second
    head missing); every (hp, N) the dispatch takes."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd import kernel as sbk
    from repro_torch.kernels.ssm_scan_bwd.ref import ssm_scan_bwd_ref

    rng = np.random.default_rng(T * 100 + nh * 10 + hp + N)
    x, Bm, Cm, dt, A, D, s0, dy, ds = _ssm_bwd_case(rng, 2, T, nh, hp, N,
                                                    torch.float32, dev)
    _, _, states = sk.ssm_scan(x, Bm, Cm, dt, A, D, s0, with_states=True)
    got = sbk.ssm_scan_bwd(x, Bm, Cm, dt, A, D, states, dy, ds)
    want = ssm_scan_bwd_ref(x, Bm, Cm, dt, A, D, s0, dy, ds)
    _assert_grads(got, want, torch.float32, ("dx", "dBm", "dCm", "ddt",
                                             "dA", "dD", "dstate"))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, 32, 33])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("decay_shift", [-6.0, 1.5])
def test_wkv_bwd_kernel_tile_edges(dev, T, hd, decay_shift):
    """The backward's tiling at its edges (one step, 31, 32 and 33 steps:
    the sub-chunks and the chunk cut short, full, one past), both head
    dims, a weak decay and a strong one."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv_bwd import kernel as wbk
    from repro_torch.kernels.rwkv6_wkv_bwd.ref import rwkv6_wkv_bwd_ref

    rng = np.random.default_rng(T * 100 + hd)
    r, k, v, lw, u, s0 = _wkv_case(rng, 2, T, 3, hd, torch.float32, dev,
                                   decay_shift)
    dy = _randn(rng, (2, T, 3, hd), dev)
    ds = _randn(rng, (2, 3, hd, hd), dev)
    _, _, states = wk.rwkv6_wkv(r, k, v, lw, u, s0, with_states=True)
    got = wbk.rwkv6_wkv_bwd(r, k, v, lw, u, states, dy, ds)
    want = rwkv6_wkv_bwd_ref(r, k, v, lw, u, s0, dy, ds)
    _assert_grads(got, want, torch.float32, ("dr", "dk", "dv", "dlw", "du",
                                             "dstate"))


@pytest.mark.cuda
def test_scan_bwd_kernels_refuse_misaligned_operands(dev):
    """The backwards read x, Bm, Cm, dy (r, k, v, lw, dy) by 16-byte
    copies: a misaligned view raises ValueError, and nothing is counted;
    under autograd a misaligned output gradient is copied, not refused."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv_bwd.ops import rwkv6_wkv_bwd
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd.ops import ssm_scan_bwd

    rng = np.random.default_rng(17)
    x, Bm, Cm, dt, A, D, s0, dy, ds = _ssm_bwd_case(rng, 1, 40, 2, 64, 64,
                                                    torch.float32, dev)
    _, _, states = sk.ssm_scan(x, Bm, Cm, dt, A, D, s0, with_states=True)
    bad = torch.zeros(x.numel() + 1, device=dev)[1:].view(x.shape)
    bad.copy_(dy)
    n0 = ssm_scan_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        ssm_scan_bwd(x, Bm, Cm, dt, A, D, states, bad, ds)
    assert ssm_scan_bwd.launches == n0
    r, k, v, lw, u, s0 = _wkv_case(rng, 1, 40, 2, 64, torch.float32, dev)
    _, _, states = wk.rwkv6_wkv(r, k, v, lw, u, s0, with_states=True)
    bad = torch.zeros(r.numel() + 1, device=dev)[1:].view(r.shape)
    bad.copy_(r)
    n0 = rwkv6_wkv_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_wkv_bwd(r, k, v, lw, u, states, bad)
    assert rwkv6_wkv_bwd.launches == n0
    leaves = [t.detach().clone().requires_grad_() for t in (r, k, v, lw, u)]
    y, _ = rwkv6_wkv(*leaves)
    g = torch.zeros(y.numel() + 1, device=dev)[1:].view(y.shape)
    g.copy_(torch.ones_like(y))
    got = torch.autograd.grad(y, leaves, g, retain_graph=True)
    want = torch.autograd.grad(y, leaves, torch.ones_like(y))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
def test_scan_forward_chunk_states_leave_serving_unchanged(dev, kind):
    """The forward with its chunk-state output gives the same y and final
    state bit for bit, and each chunk's state is the plain version's state
    after the chunks before it."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.ssm_scan import kernel as sk

    rng = np.random.default_rng(7)
    if kind == "ssm_scan":
        *ins, s0 = _ssm_case(rng, 2, 130, 3, 64, 64, torch.float32, dev)
        fwd, ref = sk.ssm_scan, ssm_scan_ref
    else:
        *ins, s0 = _wkv_case(rng, 2, 130, 3, 64, torch.float32, dev)
        fwd, ref = wk.rwkv6_wkv, rwkv6_wkv_ref
    y, s = fwd(*ins, s0)
    y2, s2, states = fwd(*ins, s0, with_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert states.shape[2] == 5
    for c in range(5):
        want = s0 if c == 0 else ref(*[a[:, :32 * c] if a.dim() >= 3 else a
                                       for a in ins], s0)[1]
        torch.testing.assert_close(states[:, :, c], want, atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_autograd_runs_both_kernels(dev, kind, dtype):
    """Under autograd the op's forward writes its chunk states and its
    backward launches the backward kernel once, with a gradient on y and
    on the final state; the gradients are the plain path's (autograd on
    the CPU), returned in each input's dtype; inference takes the forward
    alone, bit for bit the same y."""
    from repro_torch.kernels.rwkv6_wkv_bwd.ops import rwkv6_wkv_bwd
    from repro_torch.kernels.ssm_scan_bwd.ops import ssm_scan_bwd

    rng = np.random.default_rng(13)
    if kind == "ssm_scan":
        ins = list(_ssm_case(rng, 2, 77, 3, 64, 64, dtype, dev))
        op, bwd = ssm_scan, ssm_scan_bwd
    else:
        ins = list(_wkv_case(rng, 2, 77, 3, 64, dtype, dev))
        op, bwd = rwkv6_wkv, rwkv6_wkv_bwd
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    n_fwd, n_bwd = op.launches, bwd.launches
    y, s = op(*leaves)
    loss = (y.float() ** 2).sum() + s.sum()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert (op.launches, bwd.launches) == (n_fwd + 1, n_bwd + 1)
    with torch.no_grad():
        y_inf, _ = op(*ins)
    assert torch.equal(y_inf, y.detach())
    cpu = [t.detach().cpu().float().requires_grad_() for t in ins]
    yc, sc = op(*cpu)
    want = torch.autograd.grad((yc ** 2).sum() + sc.sum(), cpu)
    names = [f"d{i}" for i in range(len(ins))]
    for g, t in zip(grads, ins):
        assert g.dtype == t.dtype
    # A bf16 y enters the loss rounded; the CPU reference keeps it in f32,
    # so a bf16 call is held at the bf16 bound throughout.
    if dtype == torch.bfloat16:
        for name, g, w in zip(names, grads, want):
            rel = ((g.float().cpu() - w).abs().max()
                   / w.abs().max()).item()
            assert rel <= 2e-2, f"{name}: {rel:.3e}"
    else:
        _assert_grads([g.cpu() for g in grads], want, dtype, names)


# -- the MoE and io configs' attention widths ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("H,KV", [(40, 8), (48, 8), (64, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_moe_and_vlm_widths(dev, H, KV, dtype):
    """hd 128 at llama4-scout's G 5, internvl2-26b's G 6 and kimi-k2's G 8,
    with the MoE configs' 8192 window: prefill over a ragged T, and decode
    over the window's slot map at S below the window (unfilled slots
    marked empty) and over a ring map with empty slots."""
    from repro_torch.models.layers import EMPTY_SLOT, decode_key_positions

    rng = np.random.default_rng(H)
    B, T, hd, W = 2, 333, 128, 8192
    q = _model_layout(rng, B, T, H, hd, dtype, dev)
    k = _model_layout(rng, B, T, KV, hd, dtype, dev)
    v = _model_layout(rng, B, T, KV, hd, dtype, dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    _assert_matches(flash_attention(q, k, v, pos, pos, window=W),
                    attention_ref(*_f32(q, k, v), pos, pos, window=W))
    S = 700
    qd = torch.from_numpy(rng.normal(size=(B, KV, H // KV, hd)).astype(
        np.float32)).to(dev, dtype)
    kc = _model_layout(rng, B, S, KV, hd, dtype, dev)
    vc = _model_layout(rng, B, S, KV, hd, dtype, dev)
    for p in (0, 131, S - 1):
        k_pos = decode_key_positions(S, p, W, dev)
        _assert_matches(decode_attention(qd, kc, vc, k_pos, p),
                        decode_attention_ref(*_f32(qd, kc, vc), k_pos, p))
    last = 2500
    slots = torch.arange(S, device=dev)
    ring = last - ((last - slots) % S)
    ring[::9] = EMPTY_SLOT
    ring = ring.to(torch.int32)
    _assert_matches(decode_attention(qd, kc, vc, ring, last),
                    decode_attention_ref(*_f32(qd, kc, vc), ring, last))


# -- the grouped int8 GEMM of the W8A8 experts ---------------------------
# Integer sums: the kernel must equal its plain version bit for bit.

def _int8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-128, 128, size=shape,
                                         dtype=np.int8)).to(dev)


INT8_SHAPES = [
    (4, 1, 7168, 2048), (4, 1, 2048, 7168), (3, 1, 5120, 8192),
    (3, 1, 8192, 5120), (2, 17, 7168, 2048), (2, 208, 7168, 2048),
    (2, 208, 2048, 7168), (2, 624, 5120, 8192), (2, 624, 8192, 5120),
    (5, 63, 80, 48), (3, 65, 144, 272), (1, 130, 16, 16), (2, 1000, 96, 160),
    (7, 129, 2048, 2048),
]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N", INT8_SHAPES)
def test_int8_grouped_matmul_matches_plain(dev, E, C, K, N):
    """C of a decode step (1), 17, kimi-k2's prefill 208, llama4-scout's
    624 and ragged ones; K and N at the experts' widths (2048, 5120, 7168,
    8192) and at ragged multiples of 16 (a partial k slice, a partial
    column tile)."""
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    from repro_torch.kernels.int8_grouped_matmul.ref import \
        int8_grouped_matmul_ref

    rng = np.random.default_rng(E * C + K + N)
    a, b = _int8(rng, (E, C, K), dev), _int8(rng, (E, K, N), dev)
    n0 = int8_grouped_matmul.launches
    got = int8_grouped_matmul(a, b)
    torch.cuda.synchronize()
    assert int8_grouped_matmul.launches == n0 + 1
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, int8_grouped_matmul_ref(a, b))


@pytest.mark.cuda
def test_int8_grouped_matmul_extremes_and_strided_views(dev):
    """The largest sums (every product 128**2 or -127 * 128) at K 8192, and
    operands read through their strides: a window of a wider buffer, an
    expert axis that is not outermost in memory, b's columns cut from a
    wider matrix."""
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    from repro_torch.kernels.int8_grouped_matmul.ref import \
        int8_grouped_matmul_ref

    E, C, K, N = 3, 70, 8192, 256
    lo = torch.full((E, C, K), -128, dtype=torch.int8, device=dev)
    for b_val, want in ((-128, K * 128 * 128), (127, -K * 128 * 127)):
        b = torch.full((E, K, N), b_val, dtype=torch.int8, device=dev)
        got = int8_grouped_matmul(lo, b)
        assert torch.equal(got, torch.full_like(got, want))
    rng = np.random.default_rng(4)
    E, C, K, N = 4, 45, 1040, 384
    a_big = _int8(rng, (C + 7, E, K + 48), dev)
    a = a_big[3:3 + C, :, 16:16 + K].transpose(0, 1)      # [E, C, K]
    b = _int8(rng, (E, K, N + 64), dev)[:, :, 32:32 + N]
    assert not a.is_contiguous() and not b.is_contiguous()
    got = int8_grouped_matmul(a, b)
    assert torch.equal(got, int8_grouped_matmul_ref(a.contiguous(),
                                                    b.contiguous()))


@pytest.mark.cuda
def test_int8_grouped_matmul_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.int8_grouped_matmul import kernel as gk
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul

    rng = np.random.default_rng(0)
    a, b = _int8(rng, (2, 8, 64), dev), _int8(rng, (2, 64, 32), dev)
    n0 = int8_grouped_matmul.launches
    flat = torch.zeros(a.numel() + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="16-byte"):    # base off by one
        int8_grouped_matmul(flat[1:].view(a.shape), b)
    wide = _int8(rng, (2, 64, 40), dev)
    with pytest.raises(ValueError, match="16-byte"):    # base off by 8
        int8_grouped_matmul(a, wide[:, :, 8:40])
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_grouped_matmul(a[:, :, :40], b[:, :40])
    with pytest.raises(ValueError, match="incompatible"):
        int8_grouped_matmul(a, b[:, :32])
    with pytest.raises(TypeError):
        int8_grouped_matmul(a.float(), b)
    with pytest.raises(ValueError, match="is on"):
        int8_grouped_matmul(a, b.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        gk.int8_grouped_matmul(a.cpu(), b.cpu())
    assert int8_grouped_matmul.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N", INT8_SHAPES + [(1, 1, 16, 16),
                                                   (1100, 1, 64, 32)])
def test_int8_wgmma_matches_plain(dev, E, C, K, N):
    """The K-major kernel (b with a unit stride on K, the port's expert
    weights) at every shape of the N-major kernel's test: token tiles of
    8 to 256 rows (C 1, 17, 63, 65, 129, 130, 208, 624, 1000), ragged K
    and N; and one expert of one row, and more experts than the list
    kernel's block has threads. Both launch counters move."""
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    from repro_torch.kernels.int8_grouped_matmul.ref import \
        int8_grouped_matmul_ref

    rng = np.random.default_rng(E * C + K + N)
    a, b = _int8(rng, (E, C, K), dev), _int8(rng, (E, K, N), dev)
    n0 = int8_grouped_matmul.launches
    w0 = int8_grouped_matmul.wgmma_launches
    got = int8_grouped_matmul(a, kmajor(b))
    torch.cuda.synchronize()
    assert int8_grouped_matmul.launches == n0 + 1
    assert int8_grouped_matmul.wgmma_launches == w0 + 1
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, int8_grouped_matmul_ref(a, b))


@pytest.mark.cuda
def test_int8_wgmma_extremes_and_strided_views(dev):
    """The largest sums at K 8192 through the K-major kernel, and K-major
    operands read through their strides: b a window of a wider K-major
    storage (rows of N and K cut from both ends), a with its expert axis
    not outermost."""
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    from repro_torch.kernels.int8_grouped_matmul.ref import \
        int8_grouped_matmul_ref

    E, C, K, N = 3, 70, 8192, 256
    lo = torch.full((E, C, K), -128, dtype=torch.int8, device=dev)
    for b_val, want in ((-128, K * 128 * 128), (127, -K * 128 * 127)):
        b = kmajor(torch.full((E, K, N), b_val, dtype=torch.int8,
                               device=dev))
        got = int8_grouped_matmul(lo, b)
        assert torch.equal(got, torch.full_like(got, want))
    rng = np.random.default_rng(5)
    E, C, K, N = 4, 45, 1040, 384
    a = _int8(rng, (C + 7, E, K + 48), dev)[3:3 + C, :, 16:16 + K
                                              ].transpose(0, 1)
    store = _int8(rng, (E, N + 48, K + 96), dev)       # [E, N', K']
    b = store[:, 16:16 + N, 32:32 + K].transpose(1, 2)
    assert b.stride(1) == 1 and not b.is_contiguous()
    w0 = int8_grouped_matmul.wgmma_launches
    got = int8_grouped_matmul(a, b)
    assert int8_grouped_matmul.wgmma_launches == w0 + 1
    assert torch.equal(got, int8_grouped_matmul_ref(a.contiguous(),
                                                    b.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["none", "alternate", "all-but-one", "all",
                                  "token-tiles", "many-experts",
                                  "many-token-tiles"])
def test_int8_wgmma_skips_experts_with_no_token(dev, case):
    """Experts whose rows of a are all zero (no token routed to them) at a
    decode step's C 1 and across token tiles (C 624: three tiles of 208,
    a zero tile beside a non-zero one, zero rows inside a live tile); over
    2,100 experts (the list kernel's block takes 1,024 at a time) and 33
    token tiles (C 8,300: past the 32 whose verdicts it keeps in a
    mask). The output equals the plain version (zeros where a is zero,
    over an output buffer that held garbage), and the pre-pass lists
    exactly the items of the token tiles with a non-zero row."""
    from repro_torch.kernels.int8_grouped_matmul import kernel as gk
    from repro_torch.kernels.int8_grouped_matmul.ref import \
        int8_grouped_matmul_ref

    rng = np.random.default_rng(11)
    E, C, K, N = {"many-experts": (2100, 1, 64, 160),
                  "many-token-tiles": (3, 8300, 64, 160),
                  "token-tiles": (8, 624, 2048, 640)}.get(case,
                                                         (8, 1, 2048, 640))
    a = _int8(rng, (E, C, K), dev)
    if case == "alternate":
        a[::2] = 0
    elif case == "all-but-one":
        a[torch.arange(E, device=dev) != 5] = 0
    elif case == "all":
        a.zero_()
    elif case == "token-tiles":
        a[0, 208:] = 0          # tiles 1 and 2 empty
        a[1, :208] = 0          # tile 0 empty, tile 1 not, tile 2 empty
        a[1, 416:] = 0
        a[2, 100:300] = 0       # zero rows inside live tiles
        a[3] = 0
    elif case == "many-experts":
        a[::3] = 0
    elif case == "many-token-tiles":
        a[0, 256 * 30:] = 0     # tiles 30-32 of expert 0 empty
        a[1, :256 * 32] = 0     # only tile 32 of expert 1 holds tokens
        a[2, 256 * 5:256 * 6] = 0
    b = kmajor(_int8(rng, (E, K, N), dev))
    torch.empty((E, C, N), dtype=torch.int32, device=dev).fill_(-7)
    got = gk.int8_grouped_matmul(a, b)
    assert torch.equal(got, int8_grouped_matmul_ref(a, b))
    plan = gk.plan(E, C, K, N)
    T = plan.token_tile
    tiles = [a[:, t:t + T].ne(0).flatten(1).any(1)
             for t in range(0, C, T)]
    live = torch.stack(tiles, 1)                       # [E, token tiles]
    assert live.shape[1] == plan.token_tiles
    n_ch = -(-N // 128)
    want = [int(live.sum()) * n_ch, int((~live).sum())]
    assert gk.prepass(a, b).tolist() == want


@pytest.mark.cuda
def test_int8_grouped_matmul_refuses_other_layouts_of_b(dev):
    """b needs a unit stride on K or on N with a 16-byte-aligned base and
    16-byte-multiple other strides: a K-major b off by 1 byte, one whose
    stride on N is 8 bytes off, and one with no unit stride raise
    ValueError before any launch."""
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul

    rng = np.random.default_rng(0)
    E, C, K, N = 2, 8, 64, 32
    a = _int8(rng, (E, C, K), dev)
    n0 = int8_grouped_matmul.launches
    w0 = int8_grouped_matmul.wgmma_launches
    flat = torch.zeros(E * K * N + 64, dtype=torch.int8, device=dev)
    bad = (flat[1:1 + E * K * N].view(E, N, K).transpose(1, 2),
           torch.zeros(E * N * (K + 8), dtype=torch.int8,
                       device=dev).as_strided((E, K, N),
                                              (N * (K + 8), 1, K + 8)),
           _int8(rng, (E, K, 2 * N), dev)[:, :, ::2])
    for b in bad:
        with pytest.raises(ValueError, match="16-byte"):
            int8_grouped_matmul(a, b)
    assert int8_grouped_matmul.launches == n0
    assert int8_grouped_matmul.wgmma_launches == w0


@pytest.mark.cuda
@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"])
def test_moe_apply_on_card_matches_cpu(dev, arch, w8a8):
    """moe_apply on CUDA tensors against device="cpu" on the same weights
    and input (f32 smoke widths, 128 tokens, so that copies drop): the
    same routes, the output at 2e-5. W8A8 runs its three products on the
    K-major int8 kernel and is held within one step of its second activation
    quantisation (an ulp of silu can move h / scale across a rounding
    boundary) plus 2e-5."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    from repro_torch.models import decoder, moe

    cfg = dataclasses.replace(get_config(arch).smoke(), n_layers=1,
                              moe_w8a8=w8a8)
    p = decoder._layer(decoder.init_params(
        torch.Generator().manual_seed(0), cfg)["layers"]["moe"], 0)
    p_dev = {k: ({n: t.to(dev) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32))
    want = moe.moe_apply(p, cfg, x)
    n0 = int8_grouped_matmul.launches
    w0 = int8_grouped_matmul.wgmma_launches
    got = moe.moe_apply(p_dev, cfg, x.to(dev))
    torch.cuda.synchronize()
    assert int8_grouped_matmul.launches == n0 + (3 if w8a8 else 0)
    # The experts are stored K-major: all three go to the wgmma kernel.
    assert int8_grouped_matmul.wgmma_launches == w0 + (3 if w8a8 else 0)
    xf = x.reshape(-1, cfg.d_model)
    assert torch.equal(moe.route(p_dev, cfg, xf.to(dev))[1].cpu(),
                       moe.route(p, cfg, xf)[1])
    atol = 2e-5
    if w8a8:
        # One step: the largest row scale of h times the largest |w2|, over
        # every token in every expert (a superset of the dispatched rows).
        qb, bs = moe._quant_act(xf)
        h = torch.stack([
            torch.nn.functional.silu((qb.double() @ p["w1"][e].double()
                                      ).float() * bs * p["w1_s"][e])
            * ((qb.double() @ p["w3"][e].double()).float() * bs
               * p["w3_s"][e])
            for e in range(cfg.n_experts)])
        atol += float(moe._quant_act(h)[1].max()) * float(
            (127.0 * p["w2_s"]).max())
    torch.testing.assert_close(got.cpu(), want, atol=atol, rtol=2e-5)


# -- the Stage-2 risk solver in f64 on the card --------------------------
# Its device programs are plain torch operations, not hand-written kernels;
# these tests hold the card's run against the port's exact oracle (HiGHS on
# the host), against its own device="cpu" run and against itself.

def _risk_case(case):
    """(system, batch, solver kwargs): the gh plan of a small instance at
    the evaluation protocol's perturbations; the agh plan of the risk
    scaling instance at 1.5x stress (the 24-row Woodbury class); the small
    case again with the anchor set frozen, so that PDHG solves the misses."""
    from repro_torch.core import agh, gh, random_instance
    from repro_torch.core.stage2 import Stage2System
    from repro_torch.risk.api import PROTOCOL

    if case == "stressed":
        big = random_instance(20, 20, 20, seed=42)
        inst, dep, S, seed, kw = big.stressed(1.5), agh(big), 1024, None, {}
    else:
        inst = random_instance(10, 8, 8, seed=7)
        dep = gh(inst)
        S, seed, kw = ((2048, None, {}) if case == "nominal"
                       else (256, 5, {"max_anchors": 0}))
    rng = np.random.default_rng(PROTOCOL["seed"] if seed is None else seed)
    batch = inst.perturbed_batch(rng, S, d_infl=PROTOCOL["d_infl"],
                                 e_infl=PROTOCOL["e_infl"],
                                 lam_pm=PROTOCOL["lam_pm"])
    return Stage2System(inst, dep), batch, kw


def _risk_solve(case, device):
    from repro_torch.risk.solver import BatchedStage2Solver

    system, batch, kw = _risk_case(case)
    solver = BatchedStage2Solver(system, device=device, **kw)
    out = solver.solve_scenarios(batch)
    d = solver.diagnostics
    assert d["n_scenarios"] == batch.S
    assert (d["n_anchor0"] + d["n_harvest_exact"] + d["n_pdhg"]
            + d["n_fallback_exact"]) == batch.S
    return out, d


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nominal", "stressed", "forced"])
def test_risk_solver_on_card_matches_oracle(dev, case):
    from repro_torch.risk.solver_exact import ExactChunkSolver

    out, d = _risk_solve(case, "cuda")
    system, batch, _ = _risk_case(case)
    want = ExactChunkSolver(system).solve_scenarios(batch)
    np.testing.assert_allclose(out.costs, want.costs, rtol=1e-5)
    np.testing.assert_array_equal(out.viols, want.viols)
    if case == "forced":
        assert d["n_pdhg"] > 0
    else:
        assert d["n_anchor0"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nominal", "stressed"])
def test_risk_solver_card_equals_cpu(dev, case):
    """The anchor path's costs agree to 1e-9 relative, with equal counts.
    (Restarted PDHG adapts its step weights from ratios of iterate
    differences and amplifies rounding, so the forced-PDHG case is held to
    the oracle above, not to the CPU's iteration counts.)"""
    got, d_got = _risk_solve(case, "cuda")
    want, d_want = _risk_solve(case, "cpu")
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-9, atol=0)
    assert d_got == d_want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nominal", "stressed", "forced"])
def test_risk_solver_on_card_is_deterministic(dev, case):
    a, d_a = _risk_solve(case, "cuda")
    b, d_b = _risk_solve(case, "cuda")
    assert np.array_equal(a.costs, b.costs)
    assert d_a == d_b


# -- the allocator's lane-batched tier on the card ------------------------
# Its two programs are eager f64 torch operations, not hand-written
# kernels; the card's solve must be the CPU's, bit for bit: the same
# phase-2 keys and screen verdicts on the same padded inputs, the same
# plan. (The gate that turns the screen off reads the wall clock, so the
# screen's own counters may differ between devices; the plan may not.)

TIER_SUITE = {
    "default": lambda m: m.default_instance(),
    "random-6-6-10": lambda m: m.random_instance(6, 6, 10, seed=1),
    "random-8-5-6": lambda m: m.random_instance(8, 5, 6, seed=2),
    "random-10-10-10": lambda m: m.random_instance(10, 10, 10, seed=3),
    "stressed-1.15": lambda m: m.default_instance().stressed(1.15),
    "stressed-1.3": lambda m: m.default_instance().stressed(1.3),
    "tight-budget": lambda m: m.random_instance(6, 6, 10, seed=4,
                                                budget=40.0),
}


def _copied(obj):
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copied(o) for o in obj)
    return obj


def _tier_solve(name, device, record=None):
    """One AGH solve on the tier; with `record`, every program call's
    inputs and outputs are appended to it."""
    from repro_torch import core
    from repro_torch.core import tier_engine, tier_kernels

    inst = TIER_SUITE[name](core)
    stats = {}
    if record is None:
        return inst, tier_engine.agh_torch(inst, seed=0, stats=stats,
                                           device=device), stats
    p2, sc = tier_kernels.phase2_keys, tier_kernels.screen_sources

    def rec_p2(tx, items, counters=None):
        items = _copied(items)
        out = p2(tx, items, counters)
        record.append(("phase2", items, _copied(out)))
        return out

    def rec_sc(tx, groups, srcs, load, counters=None):
        args = _copied((groups, srcs, load))
        out = sc(tx, groups, srcs, load, counters)
        record.append(("screen", args, out.copy()))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tier_kernels, "phase2_keys", rec_p2)
    mp.setattr(tier_kernels, "screen_sources", rec_sc)
    try:
        sol = tier_engine.agh_torch(inst, seed=0, stats=stats, device=device)
    finally:
        mp.undo()
    return inst, sol, stats


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_SUITE))
def test_tier_on_card_equals_cpu(dev, name):
    from repro_torch.core import objective
    from repro_torch.core.tier_kernels import phase2_keys, screen_sources
    from repro_torch.core.tier_tensors import tensors_for

    calls = []
    inst, want, st_cpu = _tier_solve(name, "cpu", record=calls)
    _, got, st_card = _tier_solve(name, "cuda")
    assert objective(inst, got) == objective(inst, want)
    for f in ("x", "y", "q", "w", "z", "u"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for key in ("device_calls_phase2", "orderings_evaluated",
                "winning_order", "rescans"):
        assert st_card.get(key) == st_cpu.get(key), key
    tx = tensors_for(inst, dev)
    assert tx.m1_delay.is_cuda
    assert any(kind == "screen" for kind, *_ in calls)
    for kind, args, out in calls:
        if kind == "phase2":
            for g, w in zip(phase2_keys(tx, args), out, strict=True):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(screen_sources(tx, *args), out)


@pytest.mark.cuda
def test_tier_on_card_is_deterministic(dev):
    _, a, _ = _tier_solve("random-10-10-10", "cuda")
    _, b, _ = _tier_solve("random-10-10-10", "cuda")
    for f in ("x", "y", "q", "w", "z", "u"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
