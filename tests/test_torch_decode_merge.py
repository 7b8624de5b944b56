"""The decode's log-sum-exp output and the merge of partial softmaxes over
disjoint slot ranges (`layers.merge_decode_parts`), which the slot-split
decode runs under a mesh, on the CPU: the plain decode's lse is the
logsumexp of the masked, scaled scores; a group with no admissible slot
gives zeros and -inf; cutting the cache into 2, 4 or 16 slot ranges (some
of them empty), decoding each with its lse and merging gives the
whole-cache result, which is the JAX package's `decode_attention_ref`.

Tolerances: the merge against the whole-cache plain version 1e-6 in f32
(both sum the same exponentials in another order); against the JAX
oracle 2e-5, as tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      decode_attention_ref)
from repro_torch.models.layers import (EMPTY_SLOT, decode_key_positions,
                                       merge_decode_parts)

torch.set_num_threads(1)

B, KV, G, hd = 2, 3, 4, 32


def _inputs(seed: int, S: int):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((B, KV, G, hd), (B, KV, S, hd), (B, KV, S, hd)))
    return q, k, v


def _key_positions(kind: str, S: int, pos: int) -> torch.Tensor:
    """A flat cache written up to `pos`, or a ring of S slots (window S)
    that has wrapped."""
    return decode_key_positions(S, pos, S if kind == "ring" else 0)


@pytest.mark.parametrize("kind,pos", [("flat", 40), ("flat", 127),
                                      ("ring", 300), ("ring", 70)])
def test_plain_lse_is_logsumexp_of_masked_scaled_scores(kind, pos):
    S = 128
    q, k, v = _inputs(pos, S)
    k_pos = _key_positions(kind, S, pos)
    out, lse = decode_attention(q, k, v, k_pos, pos, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, KV, G)
    s = torch.einsum("bkgh,bksh->bkgs", q, k) * hd ** -0.5
    keep = k_pos <= pos
    want = torch.logsumexp(s[..., keep], dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(out, decode_attention(q, k, v, k_pos, pos),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_with_no_admissible_slot_gives_zero_and_minus_inf(dtype):
    """Every slot empty (2**30) or after pos: zeros and -inf, no NaN. The
    softmax of the -1e30 fill alone would give the mean of v."""
    S = 64
    q, k, v = (t.to(dtype) for t in _inputs(1, S))
    for k_pos in (torch.full((S,), EMPTY_SLOT, dtype=torch.int32),
                  torch.arange(100, 100 + S, dtype=torch.int32)):
        out, lse = decode_attention(q, k, v, k_pos, 99, return_lse=True)
        assert out.dtype == dtype
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.equal(lse, torch.full_like(lse, -torch.inf))
        assert torch.equal(decode_attention(q, k, v, k_pos, 99), out)
    assert NEG_INF == -1e30


def _cuts(S: int, n: int):
    return [(i * S // n, (i + 1) * S // n) for i in range(n)]


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind,pos", [("flat", 200), ("flat", 20),
                                      ("ring", 1000), ("ring", 300)])
def test_merge_of_slot_ranges_is_the_whole_cache(kind, pos, n):
    """S 512 cut into n equal slot ranges, each decoded with its own key
    positions (`decode_key_positions` from the range's start, as a rank
    of the mesh builds them) and merged: the whole cache's result at 1e-6.
    A flat cache at pos 20 or 200 leaves the later ranges empty; the ring
    at pos 300 holds positions 0..300 in slots 0..300, the rest empty."""
    S = 512
    q, k, v = _inputs(n * 1000 + pos, S)
    window = S if kind == "ring" else 0
    whole_pos = decode_key_positions(S, pos, window)
    parts_o, parts_l, empty = [], [], 0
    for a, b in _cuts(S, n):
        kp = decode_key_positions(S, pos, window, start=a, length=b - a)
        assert torch.equal(kp, whole_pos[a:b])
        o, lse = decode_attention(q, k[:, :, a:b], v[:, :, a:b], kp, pos,
                                  return_lse=True)
        empty += bool(torch.isneginf(lse).all())
        parts_o.append(o)
        parts_l.append(lse)
    # the ranges wholly after pos hold no written slot
    assert empty == (max(S - pos - 1, 0)) // (S // n)
    got = merge_decode_parts(torch.stack(parts_o), torch.stack(parts_l),
                             dim=0)
    want = decode_attention_ref(q, k, v, whole_pos, pos)
    assert got.dtype == torch.float32 and not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as dec_jnp
    ref = dec_jnp(*(jnp.asarray(t.numpy()) for t in (q, k, v, whole_pos)),
                  jnp.int32(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_merge_of_all_empty_parts_is_zero():
    """Every part empty (zeros, -inf): zeros, not the NaN of
    exp(-inf - -inf)."""
    lse = torch.full((4, B, KV, G), -torch.inf)
    got = merge_decode_parts(torch.zeros(4, B, KV, G, hd), lse, dim=0)
    assert torch.equal(got, torch.zeros(B, KV, G, hd))


@pytest.mark.parametrize("S,pos,window", [
    (32, 18, 0), (32, 40, 0), (16, 18, 16), (16, 5, 16), (64, 100, 16),
    (36, 30, 36)])
def test_key_positions_of_a_slot_range_are_the_whole_maps(S, pos, window):
    """`decode_key_positions` from `start` for `length` slots is that
    range of the whole map, flat, ring and window, for every cut of S
    into 1, 2 and 4 (36 slots: ranges of 9, whose base offsets a slice
    of the whole map could not keep 16-byte aligned)."""
    whole = decode_key_positions(S, pos, window)
    for n in (1, 2, 4):
        for a, b in _cuts(S, n):
            got = decode_key_positions(S, pos, window, start=a, length=b - a)
            assert got.dtype == torch.int32 and got.is_contiguous()
            assert torch.equal(got, whole[a:b]), (n, a, b)
