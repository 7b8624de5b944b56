"""Launcher of the Hopper RWKV6 WKV backward kernel.

The kernel is CUDA C++ in `kernels/csrc/rwkv6_wkv_bwd.cu`, which carries
the design note: the backward of `kernels/csrc/rwkv6_wkv.cu`, for
training (the reference differentiates its XLA scan instead; the TPU
kernel has no backward). One call launches two kernels: one block per
(head, batch row) sweeps the 32-step chunks from last to first with the
state gradient in registers and every product in 3xTF32 on the tensor
cores (the sub-chunk decay factorised at its midpoint, as in the
forward); the second sums du over the batch in a fixed order. It reads
the forward's chunk states (`rwkv6_wkv.kernel.rwkv6_wkv(...,
with_states=True)`). This module checks the operands, allocates the
gradients and the workspace, and launches on the current stream through
its C entry point. Operands are read through their strides; r, k, v, lw
and dy by 16-byte copies, so a base or stride that is not a multiple of
16 bytes raises ValueError (there is no fallback).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned
from ..rwkv6_wkv.kernel import CHUNK, DTYPES, HEAD_DIMS, bhtd_strides

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, *([_P] * 15), _I, _I, _I, _P, _P]


@functools.cache
def _entry():
    fn = _build.load("rwkv6_wkv_bwd").rwkv6_wkv_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(r, k, v, lw, u, states, dy, dstate):
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv_bwd kernel needs CUDA tensors, got "
                         f"{r.device}")
    named = (("k", k), ("v", v), ("lw", lw), ("u", u), ("states", states),
             ("dy", dy)) + ((("dstate", dstate),) if dstate is not None
                            else ())
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype
                                    for t in (k, v, lw, dy)):
        raise TypeError(f"r, k, v, lw, dy must share one of {list(DTYPES)}, "
                        f"got {[t.dtype for t in (r, k, v, lw, dy)]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw, dy)):
        raise ValueError(f"want r, k, v, lw, dy of one shape [B,T,H,hd], "
                         f"got {[tuple(t.shape) for t in (r, k, v, lw, dy)]}")
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(B, T, H) == 0 or T >= 2 ** 31:
        raise ValueError(f"unsupported sizes {tuple(r.shape)}")
    if u.shape != (H, hd):
        raise ValueError(f"u must be [{H},{hd}], got {tuple(u.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("dy", dy)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    check_aligned("rwkv6_wkv_bwd", r=r, k=k, v=v, lw=lw, dy=dy)
    want = (B, H, -(-T // CHUNK), hd, hd)
    if (states.dtype != torch.float32 or tuple(states.shape) != want
            or not states.is_contiguous()):
        raise ValueError(f"states must be a contiguous float32 {list(want)}, "
                         f"got {states.dtype} {tuple(states.shape)}")
    if dstate is not None and (dstate.dtype != torch.float32
                               or dstate.shape != (B, H, hd, hd)
                               or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be a contiguous float32 "
                         f"[{B},{H},{hd},{hd}], got {dstate.dtype} "
                         f"{tuple(dstate.shape)}")


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor, states: torch.Tensor,
                  dy: torch.Tensor, dstate: torch.Tensor | None = None):
    """r, k, v, lw, dy [B,T,H,hd] of one dtype, any 16-byte-aligned
    strides with a unit last one and 16-byte-aligned bases; u [H,hd];
    states [B,H,ceil(T/32),hd,hd] f32 from the forward; dstate [B,H,hd,hd]
    f32 or None (zeros); all on one CUDA device. Returns (dr, dk, dv, dlw
    [B,T,H,hd] in r's dtype; du [H,hd] f32; dstate_in [B,H,hd,hd] f32),
    all contiguous."""
    _check(r, k, v, lw, u, states, dy, dstate)
    B, T, H, hd = r.shape
    dev = r.device
    uf = u.to(torch.float32).contiguous()
    dr, dk, dv, dlw = (torch.empty(r.shape, dtype=r.dtype, device=dev)
                       for _ in range(4))
    du = torch.empty((H, hd), dtype=torch.float32, device=dev)
    ds_in = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    part = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    strides = torch.tensor([s for t in (r, k, v, lw, dy, dr)
                            for s in bhtd_strides(t)], dtype=torch.int64)
    with torch.cuda.device(dev):
        err = _entry()(
            DTYPES[r.dtype], hd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), uf.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
            ds_in.data_ptr(), part.data_ptr(), B, T, H,
            strides.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_wkv_bwd kernel launch failed: CUDA error "
                           f"{err}")
    return dr, dk, dv, dlw, du, ds_in
