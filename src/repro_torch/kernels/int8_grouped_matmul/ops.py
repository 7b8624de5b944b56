"""Public grouped int8 GEMM: a CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

`int8_grouped_matmul.launches` counts the launches of both CUDA kernels,
and `int8_grouped_matmul.wgmma_launches` those of the K-major `wgmma`
kernel alone, so a run can show that its W8A8 experts, which the port
stores K-major, went through it.
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from . import kernel
from .ref import int8_grouped_matmul_ref


def int8_grouped_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E,C,K] int8, b [E,K,N] int8 -> [E,C,N] int32, out[e] = a[e] @
    b[e], exact. For CUDA tensors this launches the kernel that b's layout
    picks (`kernel.b_layout`: K-major or N-major) or raises; only a CPU
    tensor takes the plain version. It has no backward: on CUDA it raises
    NotImplementedError when a gradient is asked of it."""
    if a.device.type == "cpu":
        return int8_grouped_matmul_ref(a, b)
    refuse_grad("int8_grouped_matmul", "int8 weights are not trainable",
                a, b)
    out = kernel.int8_grouped_matmul(a, b)
    int8_grouped_matmul.launches += 1
    if kernel.b_layout(b) == kernel.KMAJOR:
        int8_grouped_matmul.wgmma_launches += 1
    return out


int8_grouped_matmul.launches = 0
int8_grouped_matmul.wgmma_launches = 0
