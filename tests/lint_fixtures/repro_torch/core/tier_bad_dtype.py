"""RPR301/302 in the allocator tier (core/tier*.py): f32 leaks."""
import numpy as np
import torch


def implicit(n: int, dev):
    grid = torch.zeros((n, n), device=dev)      # RPR301: default f32
    idx = torch.arange(n, device=dev)           # RPR301: implicit dtype
    host = torch.as_tensor([0.5, 1.5])          # RPR301: list -> f32
    return grid, idx, host


def narrowing(x):
    a = x.float()                               # RPR302: .float()
    b = x.to(torch.float32)                     # RPR302: .to(f32)
    c = torch.ones_like(x, dtype=torch.bfloat16)    # RPR302: dtype=bf16
    return a, b, c, np.float32(1.5)             # RPR302: np.float32 cast
