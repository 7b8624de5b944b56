"""Launcher of the grouped int8 GEMM of the W8A8 experts.

The kernel is CUDA C++ in `kernels/csrc/int8_grouped_matmul.cu`, which
carries the design note. It is the port's own kernel, not a port of a TPU
kernel: the reference computes these products as XLA einsums
(`repro/models/moe.py::_w8a8_ffn`). This module checks the operands
(16-byte copies need 16-byte-aligned bases and strides, and K and N
multiples of 16), allocates the int32 output and launches the kernel on
the current stream through its C entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned

MAX_K = 2 ** 17 - 1    # K * 128**2 stays below 2**31: the int32 sums are exact
MAX_E = 65535          # one grid row of blocks per expert
BM = 64                # rows per block (BM in the source)
MAX_ROW_TILES = 65535

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _P]


@functools.cache
def _entry():
    fn = _build.load("int8_grouped_matmul").int8_grouped_matmul_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"int8_grouped_matmul kernel needs CUDA tensors, "
                         f"got {a.device}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"a and b must be int8, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"want a [E,C,K] and b [E,K,N], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    E, C, K = a.shape
    if b.shape[:2] != (E, K):
        raise ValueError(f"incompatible a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)}")
    N = b.shape[2]
    if min(E, C, K, N) == 0:
        raise ValueError(f"empty operand: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if K % 16 or N % 16:
        raise ValueError(f"K {K} and N {N} must be multiples of 16")
    if K > MAX_K or E > MAX_E or -(-C // BM) > MAX_ROW_TILES:
        raise ValueError(f"unsupported sizes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    check_aligned("int8_grouped_matmul", a=a, b=b)


def int8_grouped_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E,C,K] int8, b [E,K,N] int8, on one CUDA device, any strides with
    a unit last one. Returns out [E,C,N] int32 (contiguous), out[e] =
    a[e] @ b[e], exact."""
    _check(a, b)
    E, C, K = a.shape
    N = b.shape[2]
    out = torch.empty((E, C, N), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), E, C, K,
                       N, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                       out.stride(0), out.stride(1), stream)
    if err:
        raise RuntimeError(f"int8_grouped_matmul kernel launch failed: CUDA "
                           f"error {err}")
    return out
