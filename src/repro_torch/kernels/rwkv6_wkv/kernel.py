"""Launcher of the Hopper RWKV6 WKV kernel.

The kernel is CUDA C++ in `kernels/csrc/rwkv6_wkv.cu`, which carries the
design note: it replaces `repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv`;
one block per (b, head) sweeps 32-step chunks with the f32 state in
registers, the decay between 16-step sub-chunks factorised into tensor-core
products (3xTF32). This module checks the operands, allocates the output
and the final state, and launches the kernel on the current stream
through its C entry point; for training it also writes the state each
32-step chunk starts from, which the backward (`kernels.rwkv6_wkv_bwd`)
reads. r, k, v and lw are read by 16-byte copies: a base or stride that
is not a multiple of 16 bytes raises ValueError (there is no fallback).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
CHUNK = 32                    # the kernels' chunk length

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_I, _I, *([_P] * 9), _I, _I, _I, *([_L] * 20), _P]


@functools.cache
def _entry():
    fn = _build.load("rwkv6_wkv").rwkv6_wkv_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bhtd_strides(t: torch.Tensor) -> tuple[int, int, int, int]:
    """Strides of a [B,T,H,hd] tensor in the kernels' (b, h, t, d) order."""
    sb, st, sh, sd = t.stride()
    return sb, sh, st, sd


def _check(r, k, v, lw, u, state):
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv kernel needs CUDA tensors, got "
                         f"{r.device}")
    named = (("k", k), ("v", v), ("lw", lw), ("u", u))
    for name, t in named + ((("state", state),) if state is not None
                            else ()):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype for t in (k, v, lw)):
        raise TypeError(f"r, k, v, lw must share one of {list(DTYPES)}, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {lw.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"want r, k, v, lw of one shape [B,T,H,hd], got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(B, T, H) == 0 or T >= 2 ** 31:
        raise ValueError(f"unsupported sizes {tuple(r.shape)}")
    if u.shape != (H, hd):
        raise ValueError(f"u must be [{H},{hd}], got {tuple(u.shape)}")
    for name, t in (("r", r),) + named[:3]:
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    check_aligned("rwkv6_wkv", r=r, k=k, v=v, lw=lw)
    if state is not None and (state.dtype != torch.float32
                              or state.shape != (B, H, hd, hd)
                              or not state.is_contiguous()):
        raise ValueError(f"state must be a contiguous float32 "
                         f"[{B},{H},{hd},{hd}], got {state.dtype} "
                         f"{tuple(state.shape)}")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lw: torch.Tensor, u: torch.Tensor,
              state: torch.Tensor | None = None, with_states: bool = False):
    """r, k, v, lw [B,T,H,hd] of one dtype, any 16-byte-aligned strides
    with a unit last one, 16-byte-aligned bases; u [H,hd]; state
    [B,H,hd,hd] contiguous f32 or None (zeros); all on one CUDA device.
    Returns (y [B,T,H,hd] contiguous in r's dtype, final state [B,H,hd,hd]
    f32), and with `with_states` also the state each chunk starts from,
    [B, H, ceil(T / CHUNK), hd, hd] f32."""
    _check(r, k, v, lw, u, state)
    B, T, H, hd = r.shape
    uf = u.to(torch.float32).contiguous()
    y = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    states = (torch.empty((B, H, -(-T // CHUNK), hd, hd), dtype=torch.float32,
                          device=r.device) if with_states else None)
    with torch.cuda.device(r.device):
        err = _entry()(
            DTYPES[r.dtype], hd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), uf.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), None if states is None else states.data_ptr(),
            B, T, H,
            *bhtd_strides(r), *bhtd_strides(k), *bhtd_strides(v),
            *bhtd_strides(lw), *bhtd_strides(y),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    return (y, s_out, states) if with_states else (y, s_out)
