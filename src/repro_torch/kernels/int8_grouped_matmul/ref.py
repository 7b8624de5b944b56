"""Plain PyTorch version of the grouped int8 GEMM: the CPU path of
`ops.int8_grouped_matmul`, and what the CUDA kernel is held against, bit
for bit, on the card."""
from __future__ import annotations

import torch

# Most f64 elements of a and b converted at once (1 GiB).
CHUNK_ELEMS = 2 ** 27


def int8_grouped_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E,C,K], b [E,K,N] (int8) -> [E,C,N] int32, out[e] = a[e] @ b[e].
    A batched product in f64 is exact here: every partial sum is an integer
    below K * 128**2 < 2**53. Experts go in groups of at most CHUNK_ELEMS
    f64 elements, so a full layer's experts fit on the card."""
    E, C, K = a.shape
    N = b.shape[2]
    out = torch.empty((E, C, N), dtype=torch.int32, device=a.device)
    per = max(1, CHUNK_ELEMS // (C * K + K * N))
    for e0 in range(0, E, per):
        sl = slice(e0, e0 + per)
        out[sl] = torch.bmm(a[sl].double(), b[sl].double()).to(torch.int32)
    return out
