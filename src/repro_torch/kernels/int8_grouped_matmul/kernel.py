"""Launchers of the grouped int8 GEMM of the W8A8 experts.

Two CUDA C++ kernels, each with its design note in its source, picked by
the layout of b [E, K, N], never on failure:
- b K-major (unit stride on K, the port's storage of the expert weights):
  `kernels/csrc/int8_grouped_matmul_wgmma.cu`, TMA + `wgmma` s8 with the
  operands swapped (channels on the 64-row side, tokens on the n side), and
  no byte of b read for an expert whose rows of a are all zero;
- b N-major (unit stride on N, the reference's layout):
  `kernels/csrc/int8_grouped_matmul.cu`, `cp.async` + `mma.sync`.
Any other b raises ValueError (`b_layout`). They are the port's own
kernels, not ports of TPU kernels: the reference computes these products
as XLA einsums (`repro/models/moe.py::_w8a8_ffn`). This module checks the
operands (16-byte copies need 16-byte-aligned bases and strides, and K
and N multiples of 16), allocates the int32 output (and the K-major
kernel's workspace) and launches on the current stream through the C
entry points.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .._layout import aligned16, check_aligned

MAX_K = 2 ** 17 - 1    # K * 128**2 stays below 2**31: the int32 sums are exact
MAX_E = 65535          # one grid row of blocks per expert
BM = 64                # rows a block of the N-major kernel (its BM)
MAX_ROW_TILES = 65535
KMAJOR, NMAJOR = "kmajor", "nmajor"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _P]
_WGMMA_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                   _I, _P]


@functools.cache
def _entry():
    fn = _build.load("int8_grouped_matmul").int8_grouped_matmul_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


@functools.cache
def _wgmma_entries():
    lib = _build.load("int8_grouped_matmul_wgmma")
    run, sizes = (lib.int8_grouped_matmul_wgmma,
                  lib.int8_grouped_matmul_wgmma_plan)
    run.argtypes, run.restype = _WGMMA_ARGTYPES, ctypes.c_int
    sizes.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int64)]
    sizes.restype = ctypes.c_int
    return run, sizes


def b_layout(b: torch.Tensor) -> str:
    """Which kernel takes b [E, K, N]: KMAJOR for a unit stride on K (the
    port's expert weights), NMAJOR for a unit stride on N; either with a
    16-byte-aligned base and its other strides multiples of 16 bytes (a
    dimension of extent 1 never moves, so its stride does not count).
    Raises ValueError for any other b."""
    if b.dim() != 3:
        raise ValueError(f"want b [E,K,N], got {tuple(b.shape)}")
    (E, K, N), (se, sk, sn) = b.shape, b.stride()
    size, ptr = b.element_size(), b.data_ptr()
    if aligned16((E, N, K), (se, sn, sk), size, ptr):
        return KMAJOR
    if aligned16((E, K, N), (se, sk, sn), size, ptr):
        return NMAJOR
    raise ValueError(
        f"int8_grouped_matmul: b must have a unit stride on K or on N, a "
        f"16-byte-aligned base and 16-byte-multiple other strides, got "
        f"address {ptr:#x}, strides {b.stride()}")


def _check(a: torch.Tensor, b: torch.Tensor) -> str:
    """Raise on operands no kernel takes; return b's layout."""
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
    check_aligned("int8_grouped_matmul", a=a)
    return b_layout(b)


def _raise_on(err: int, which: str) -> None:
    if err:
        raise RuntimeError(f"int8_grouped_matmul {which} kernel launch "
                           f"failed: CUDA error {err}")


def _mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    E, C, K = a.shape
    N = b.shape[2]
    out = torch.empty((E, C, N), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), E, C, K,
                       N, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                       out.stride(0), out.stride(1), stream)
    _raise_on(err, "N-major")
    return out


class Plan(NamedTuple):
    """The K-major kernel's plan at one size: int32 words of workspace,
    where its two counts sit in it, the token tile width and the number of
    token tiles."""
    words: int
    counts_at: int
    token_tile: int
    token_tiles: int


@functools.lru_cache(maxsize=256)
def plan(E: int, C: int, K: int, N: int) -> Plan:
    """The K-major kernel's plan at these sizes (its C entry point's rule,
    cached: a decode loop asks for the same few sizes)."""
    info = (ctypes.c_int64 * 4)()
    if _wgmma_entries()[1](E, C, K, N, info):
        raise ValueError(f"unsupported sizes E {E}, C {C}, K {K}, N {N}")
    return Plan(*info)


def _wgmma(a: torch.Tensor, b: torch.Tensor, prepass_only: bool):
    E, C, K = a.shape
    N = b.shape[2]
    p = plan(E, C, K, N)
    ws = torch.empty(p.words, dtype=torch.int32, device=a.device)
    out = (None if prepass_only else
           torch.empty((E, C, N), dtype=torch.int32, device=a.device))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _wgmma_entries()[0](
            a.data_ptr(), b.data_ptr(), 0 if out is None else out.data_ptr(),
            ws.data_ptr(), E, C, K, N, a.stride(0), a.stride(1), b.stride(0),
            b.stride(2), N * C, N, int(prepass_only), stream)
    _raise_on(err, "K-major")
    return ws[p.counts_at:p.counts_at + 2] if prepass_only else out


def int8_grouped_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E,C,K] int8 (unit stride on K), b [E,K,N] int8 K-major or N-major
    (`b_layout`), on one CUDA device. Returns out [E,C,N] int32
    (contiguous), out[e] = a[e] @ b[e], exact."""
    if _check(a, b) == KMAJOR:
        return _wgmma(a, b, False)
    return _mma(a, b)


def prepass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The K-major kernel's pre-pass alone (which token tiles of a hold a
    non-zero row, and the list of work items), for timing it and for
    checking it: returns int32 [2], (work items of 128 output channels,
    (expert, token tile) pairs with no token)."""
    if _check(a, b) != KMAJOR:
        raise ValueError("the pre-pass belongs to the K-major kernel")
    return _wgmma(a, b, True)
