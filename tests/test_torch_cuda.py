"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: they skip where there is no GPU, and need no JAX, so
the machine with the card runs them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Operands are the model's [B,T,H|KV,hd] tensors handed over as transposed
views, as the attention layer does. The plain version runs in f32 on the
same inputs (bf16 ones upcast exactly). Tolerances: 2e-5 for f32 (IEEE f32
on both sides: TF32 is off). bf16 kernels round the output to bf16 (2**-9
relative) and the flash kernel rounds P to bf16 before P V: atol 4e-3 /
rtol 1.6e-2 per element, and |got - want|_2 / |want|_2 <= 1e-2 per query
row, which a key tile dropped or a padded key left in the softmax sum
exceeds on the rows it touches.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

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
@pytest.mark.parametrize("B,KV,G,S,hd", [
    (1, 2, 4, 512, 64), (2, 1, 8, 1024, 128), (2, 4, 1, 512, 64),
    (8, 2, 7, 1031, 64), (3, 2, 16, 100, 32), (64, 8, 2, 300, 64),
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
def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 2, 8, 48, device=dev)          # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x)
    y = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        decode_attention(y[:, :, :2], y, y)
