"""Clean twin of tier_bad_dtype: every dtype pinned, nothing narrowed."""
import numpy as np
import torch

F64 = torch.float64


def explicit(n: int, base, dev):
    grid = torch.zeros((n, n), dtype=F64, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    host = torch.as_tensor(np.ones(n), F64)             # positional slot
    like = dict(dtype=base.dtype, device=base.device)
    ones = torch.ones((n,), **like)                     # **kw with a dtype
    mirror = torch.zeros_like(base)                     # inherits: exempt
    fresh = base.new_zeros((n,))                        # inherits: exempt
    return grid, idx, host, ones, mirror, fresh


def widen(x, y):
    return x.to(torch.float64), x.double(), x.to(y)     # widening, .to(other)
