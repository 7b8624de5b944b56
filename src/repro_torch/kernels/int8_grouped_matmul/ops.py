"""Public grouped int8 GEMM: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

`int8_grouped_matmul.launches` counts the kernel's launches, so a run can
show that its W8A8 experts went through the kernel.
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from . import kernel
from .ref import int8_grouped_matmul_ref


def int8_grouped_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E,C,K] int8, b [E,K,N] int8 -> [E,C,N] int32, out[e] = a[e] @
    b[e], exact. For a CUDA tensor this launches the kernel or raises; only
    a CPU tensor takes the plain version. It has no backward: on CUDA
    it raises NotImplementedError when a gradient is asked of it."""
    if a.device.type == "cpu":
        return int8_grouped_matmul_ref(a, b)
    refuse_grad("int8_grouped_matmul", "int8 weights are not trainable",
                a, b)
    out = kernel.int8_grouped_matmul(a, b)
    int8_grouped_matmul.launches += 1
    return out


int8_grouped_matmul.launches = 0
