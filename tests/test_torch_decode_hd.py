"""The head_dim-split decode pair (`kernels/decode_attention_hd`) on the
CPU: the partial scores of each slice of head_dim, summed over the slices
as a mesh's all-reduce sums them, then the softmax and P V of each slice
at the whole head's scale, put back together, are the decode over whole
heads: the port's `decode_attention_ref` and the JAX package's
`decode_attention_ref` and Pallas kernel (interpret mode). Over 1, 2, 4,
8 and 16 slices (16 slices of head_dim 64: 4 lanes, as qwen2-0.5b's cache
on a 16-way "model" axis), a flat cache written part way, a ring that has wrapped with
empty (2**30) slots, and a cache with no admissible slot (zeros, as the
port's whole-head decode gives; the JAX oracle, which gives the mean of
v there, is left out of that case).

Tolerances: against the port's whole-head plain version 1e-6 in f32 (the
same products, the scores summed in another order); against the JAX
oracle and kernel 2e-5, as tests/test_torch_kernels.py; bf16 at the
rounding of one bf16 output (2**-8 relative).
"""
import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention_hd.ops import (
    decode_scores_hd, decode_softmax_pv_hd)
from repro_torch.kernels.decode_attention_hd.ref import (
    decode_scores_hd_ref, decode_softmax_pv_hd_ref)
from repro_torch.models.layers import (EMPTY_SLOT, decode_key_positions,
                                       hd_slice_attend, hd_slice_scores)

torch.set_num_threads(1)

B, KV, G, hd, S = 2, 3, 4, 64, 128


def _inputs(seed: int, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(dtype)
                 for shape in ((B, KV, G, hd), (B, KV, S, hd),
                               (B, KV, S, hd)))


def _key_positions(kind: str, pos: int) -> torch.Tensor:
    """A flat cache written up to pos; a ring of S slots that has wrapped,
    with every fifth slot marked empty; or every slot empty."""
    if kind == "flat":
        return decode_key_positions(S, pos, 0)
    if kind == "ring":
        k_pos = decode_key_positions(S, pos, S)
        return torch.where(torch.arange(S) % 5 == 3, EMPTY_SLOT, k_pos)
    return torch.full((S,), EMPTY_SLOT, dtype=torch.int32)


def _split_decode(q, k, v, k_pos, pos: int, n: int) -> torch.Tensor:
    """The pair over n slices of head_dim, as n ranks run it: each slice's
    partial scores summed (the all-reduce), then each slice's softmax and
    P V at the whole head's scale, the slices' outputs concatenated."""
    hl = hd // n
    cuts = [slice(i * hl, (i + 1) * hl) for i in range(n)]
    s = sum(decode_scores_hd(q[..., c], k[..., c]) for c in cuts)
    return torch.cat([decode_softmax_pv_hd(s, v[..., c], k_pos, pos,
                                           hd ** -0.5) for c in cuts], -1)


CASES = [("flat", 70), ("flat", 127), ("ring", 300), ("ring", 131),
         ("empty", 50)]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind,pos", CASES)
def test_slices_summed_are_the_whole_head_decode(kind, pos, n):
    q, k, v = _inputs(7 * n + pos)
    k_pos = _key_positions(kind, pos)
    got = _split_decode(q, k, v, k_pos, pos, n)
    assert got.shape == (B, KV, G, hd) and got.dtype == torch.float32
    want = decode_attention_ref(q, k, v, k_pos, pos)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    if kind == "empty":
        assert torch.equal(got, torch.zeros_like(got))
        return
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import \
        decode_attention as jax_decode
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as jax_ref
    args = (jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(k_pos.numpy()),
            jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref(*args)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_decode(*args)),
                               atol=2e-5, rtol=2e-5)


def test_the_slice_scale_is_not_the_head_scale():
    """On 4 slices, scaling by the slice's own 1 / sqrt(hl), as a
    whole-head decode would from its q's last dim, gives another
    attention: the pair must be handed the whole head's scale."""
    q, k, v = _inputs(3)
    k_pos = _key_positions("flat", 100)
    hl = hd // 4
    cuts = [slice(i * hl, (i + 1) * hl) for i in range(4)]
    s = sum(decode_scores_hd(q[..., c], k[..., c]) for c in cuts)
    wrong = torch.cat([decode_softmax_pv_hd(s, v[..., c], k_pos, 100,
                                            hl ** -0.5) for c in cuts], -1)
    want = decode_attention_ref(q, k, v, k_pos, 100)
    assert (wrong - want).abs().max() > 1e-2
    torch.testing.assert_close(_split_decode(q, k, v, k_pos, 100, 4), want,
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 8])
def test_bf16_slices_are_the_whole_head_decode(n):
    """bf16 operands: the pair's output is bf16 (v's dtype), within one
    bf16 rounding of the whole-head plain version's f32 result."""
    q, k, v = _inputs(11 + n, torch.bfloat16)
    k_pos = _key_positions("ring", 200)
    got = _split_decode(q, k, v, k_pos, 200, n)
    assert got.dtype == torch.bfloat16
    want = decode_attention_ref(q.float(), k.float(), v.float(), k_pos, 200)
    torch.testing.assert_close(got.float(), want, atol=2 ** -8, rtol=2 ** -8)


@pytest.mark.parametrize("n", [4, 16])
def test_layer_slices_are_the_whole_head_decode(n):
    """The layer's halves of a rank's hd-split decode (`hd_slice_scores`,
    `hd_slice_attend`) on the layer's layouts: q [B,1,H,hl] and the cache
    [B,S,KV,hl] of each slice, as a Shard(3) local shard holds them
    (contiguous), the scores summed over the slices; the slices' outputs
    put back together are the whole-head decode at 1e-6."""
    q, k, v = _inputs(40 + n)
    q = q.reshape(B, 1, KV * G, hd)
    kc, vc = (x.transpose(1, 2).contiguous() for x in (k, v))
    k_pos = _key_positions("ring", 150)
    hl = hd // n
    cuts = [slice(i * hl, (i + 1) * hl) for i in range(n)]
    s = sum(hd_slice_scores(q[..., c].contiguous(), kc[..., c].contiguous(),
                            use_kernels=False) for c in cuts)
    got = torch.cat([hd_slice_attend(s, vc[..., c].contiguous(), 150, k_pos,
                                     hd ** -0.5, use_kernels=False)
                     for c in cuts], -1)
    want = decode_attention_ref(q.reshape(B, KV, G, hd), k, v, k_pos, 150)
    assert got.shape == (B, 1, KV * G, hd)
    torch.testing.assert_close(got, want.reshape(B, 1, KV * G, hd),
                               atol=1e-6, rtol=1e-6)


def test_ops_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the ops are their plain versions, bit for bit, and
    launch nothing; the scores are f32 whatever q's dtype."""
    q, k, v = _inputs(5, torch.bfloat16)
    k_pos = _key_positions("flat", 90)
    n0 = (decode_scores_hd.launches, decode_softmax_pv_hd.launches)
    s = decode_scores_hd(q[..., :16], k[..., :16])
    assert s.dtype == torch.float32 and s.shape == (B, KV, G, S)
    assert torch.equal(s, decode_scores_hd_ref(q[..., :16], k[..., :16]))
    o = decode_softmax_pv_hd(s, v[..., :16], k_pos, 90, 0.125)
    assert torch.equal(o, decode_softmax_pv_hd_ref(s, v[..., :16], k_pos, 90,
                                                   0.125))
    assert (decode_scores_hd.launches,
            decode_softmax_pv_hd.launches) == n0


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("B,KV", [(1, 1), (1, 2), (8, 2), (8, 8), (33, 32)])
def test_softmax_cut_covers_every_slot_once(B, KV, n_sm):
    """The softmax kernel's cut of S slots into runs (`kernel.split`):
    runs of whole tiles, none empty, at most MAX_SPLIT of them, covering
    every slot once, for S from below a tile to 32,768."""
    from repro_torch.kernels.decode_attention_hd import kernel as hk
    for S in (1, 5, 127, 128, 129, 300, 777, 1024, 4096, 32767, 32768):
        n_split, split_len = hk.split(B, KV, S, n_sm)
        assert 1 <= n_split <= hk.MAX_SPLIT, (S, n_split)
        assert split_len > 0 and split_len % hk.TILE == 0, (S, split_len)
        # every slot in exactly one run, and the last run not empty
        assert (n_split - 1) * split_len < S <= n_split * split_len, S
