"""Where the port's entry points run: CUDA unless the caller asks for the
CPU, and never a silent move from one to the other."""
from __future__ import annotations

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """The device to run on; raises rather than fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return dev


def is_dtensor(t) -> bool:
    """Whether t is a `torch.distributed.tensor.DTensor`."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)
