"""Clean twin of bad_determinism: every draw takes a seeded generator."""
import torch


def draws(n: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand(n, generator=gen, device=device)
    b = torch.randn(n, n, generator=gen, device=device)
    c = torch.randperm(n, generator=gen, device=device)
    a.uniform_(generator=gen)
    z = torch.zeros_like(a)                     # no draw
    return a + b[0] + c + z
