"""Plain PyTorch versions of the head_dim-split decode pair, in the
reference kernel's argument layout. The CPU path of
`ops.decode_scores_hd` / `ops.decode_softmax_pv_hd`, and what the CUDA
kernels are checked against on the card.

Summed over the slices of head_dim that a mesh's ranks hold, the scores
are `decode_attention_ref`'s unscaled q k products, so the pair on each
rank gives that rank's lanes of `decode_attention_ref` on the whole
heads."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_scores_hd_ref(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,KV,G,hl]; k [B,KV,S,hl], both on the same hl lanes of head_dim.
    Returns [B,KV,G,S] f32: the dot products over these lanes, unscaled
    and unmasked."""
    return torch.einsum("bkgh,bksh->bkgs", q.float(), k.float())


def decode_softmax_pv_hd_ref(s: torch.Tensor, v: torch.Tensor,
                             k_pos: torch.Tensor, pos: int,
                             scale: float) -> torch.Tensor:
    """s [B,KV,G,S] f32, the scores summed over every slice of head_dim;
    v [B,KV,S,hl] this slice's lanes; k_pos [S] slot -> absolute position;
    pos the current position; scale the whole head's 1 / sqrt(hd). Slot s
    counts when k_pos[s] <= pos. Returns [B,KV,G,hl] in v's dtype: these
    lanes of the softmax(s * scale) weighted sum of v, zeros where no slot
    counts (as `decode_attention_ref` gives them)."""
    mask = k_pos <= pos
    x = (s.float() * scale).masked_fill(~mask[None, None, None], NEG_INF)
    p = torch.softmax(x, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    return torch.where(mask.any(), o, 0.0).to(v.dtype)
