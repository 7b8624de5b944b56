"""RPR201 (torch): draws from, or reseeds, torch's global generator."""
import torch
import torch.nn.functional as F
from torch import randperm


def reseed() -> None:
    torch.manual_seed(0)                        # RPR201: global reseed


def draws(n: int, device):
    a = torch.rand(n, device=device)            # RPR201: no generator=
    b = torch.randn(n, n)                       # RPR201
    c = randperm(n)                             # RPR201 (imported name)
    d = torch.randn_like(a)                     # RPR201: *_like has none
    a.uniform_()                                # RPR201: in-place sampler
    return F.softmax(a + b[0] + c + d, dim=0)
