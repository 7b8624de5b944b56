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
@pytest.mark.parametrize("hd,G", [(112, 1), (128, 16), (64, 7)])
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
