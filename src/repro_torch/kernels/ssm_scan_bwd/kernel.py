"""Launcher of the Hopper Mamba2 SSD scan backward kernel.

The kernel is CUDA C++ in `kernels/csrc/ssm_scan_bwd.cu`, which carries
the design note: the backward of `kernels/csrc/ssm_scan.cu`, for training
(the reference differentiates its XLA scan instead; the TPU kernel has no
backward). One call launches two kernels: one block per two heads of a
batch row sweeps the 32-step chunks from last to first with the state
gradient in registers and every product in 3xTF32 on the tensor cores,
writing dBm and dCm (shared by the heads) as per-block partials; the
second sums those partials, and dA and dD, in a fixed order. It reads the
forward's chunk states (`ssm_scan.kernel.ssm_scan(..., with_states=True)`).
This module checks the operands, allocates the gradients and the
workspace, and launches on the current stream through its C entry point.
Operands are read through their strides; x, Bm, Cm and dy by 16-byte
copies, so a base or stride that is not a multiple of 16 bytes raises
ValueError (there is no fallback).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned
from ..ssm_scan.kernel import CHUNK, DTYPES, HEAD_DIMS, STATE_DIMS, \
    bhtd_strides

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _I, *([_P] * 18), _I, _I, _I, _P, _P]


@functools.cache
def _entry():
    fn = _build.load("ssm_scan_bwd").ssm_scan_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(x, Bm, Cm, dt, A, D, states, dy, dstate):
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd kernel needs CUDA tensors, got "
                         f"{x.device}")
    named = (("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A), ("D", D),
             ("states", states), ("dy", dy)) + (
                 (("dstate", dstate),) if dstate is not None else ())
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype
                                    for t in (Bm, Cm, dy)):
        raise TypeError(f"x, Bm, Cm, dy must share one of {list(DTYPES)}, "
                        f"got {[t.dtype for t in (x, Bm, Cm, dy)]}")
    if dt.dtype != torch.float32:
        raise TypeError(f"dt must be float32, got {dt.dtype}")
    if x.dim() != 4 or dy.shape != x.shape or Bm.dim() != 3 or \
            Bm.shape != Cm.shape:
        raise ValueError(f"want x and dy [B,T,nh,hp], Bm and Cm [B,T,N], "
                         f"got {tuple(x.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, T, nh, hp = x.shape
    N = Bm.shape[2]
    if Bm.shape[:2] != (B, T) or dt.shape != (B, T, nh):
        raise ValueError(f"incompatible x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)} and dt {tuple(dt.shape)}")
    if A.shape != (nh,) or D.shape != (nh,):
        raise ValueError(f"A and D must be [{nh}], got {tuple(A.shape)}, "
                         f"{tuple(D.shape)}")
    if hp not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"head dim {hp} not in {HEAD_DIMS} or state dim "
                         f"{N} not in {STATE_DIMS}")
    if min(B, T, nh) == 0 or T >= 2 ** 31:
        raise ValueError(f"unsupported sizes {tuple(x.shape)}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("dy", dy)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    if min(dt.stride()) < 0:
        raise ValueError(f"dt has negative strides {dt.stride()}")
    check_aligned("ssm_scan_bwd", x=x, Bm=Bm, Cm=Cm, dy=dy)
    want = (B, nh, -(-T // CHUNK), hp, N)
    if (states.dtype != torch.float32 or tuple(states.shape) != want
            or not states.is_contiguous()):
        raise ValueError(f"states must be a contiguous float32 {list(want)}, "
                         f"got {states.dtype} {tuple(states.shape)}")
    if dstate is not None and (dstate.dtype != torch.float32
                               or dstate.shape != (B, nh, hp, N)
                               or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be a contiguous float32 "
                         f"[{B},{nh},{hp},{N}], got {dstate.dtype} "
                         f"{tuple(dstate.shape)}")


def ssm_scan_bwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 states: torch.Tensor, dy: torch.Tensor,
                 dstate: torch.Tensor | None = None):
    """x, dy [B,T,nh,hp], Bm, Cm [B,T,N] of one dtype, any 16-byte-aligned
    strides with a unit last one and 16-byte-aligned bases; dt [B,T,nh]
    f32; A, D [nh]; states [B,nh,ceil(T/32),hp,N] f32 from the forward;
    dstate [B,nh,hp,N] f32 or None (zeros); all on one CUDA device.
    Returns (dx [B,T,nh,hp] and dBm, dCm [B,T,N] in x's dtype; ddt
    [B,T,nh] f32; dA, dD [nh] f32; dstate_in [B,nh,hp,N] f32), all
    contiguous."""
    _check(x, Bm, Cm, dt, A, D, states, dy, dstate)
    B, T, nh, hp = x.shape
    N = Bm.shape[2]
    dev = x.device
    Af = A.to(torch.float32).contiguous()
    Df = D.to(torch.float32).contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dB = torch.empty(Bm.shape, dtype=x.dtype, device=dev)
    dC = torch.empty(Cm.shape, dtype=x.dtype, device=dev)
    ddt = torch.empty((B, T, nh), dtype=torch.float32, device=dev)
    dAD = torch.empty((2, nh), dtype=torch.float32, device=dev)
    ds_in = torch.empty((B, nh, hp, N), dtype=torch.float32, device=dev)
    part_bc = torch.empty((2, B, -(-nh // 2), T, N), dtype=torch.float32,
                          device=dev)
    part_ad = torch.empty((B, nh, 2), dtype=torch.float32, device=dev)
    strides = torch.tensor([*bhtd_strides(x), *Bm.stride(), *Cm.stride(),
                            *dt.stride(), *bhtd_strides(dy),
                            *bhtd_strides(dx)], dtype=torch.int64)
    with torch.cuda.device(dev):
        err = _entry()(
            DTYPES[x.dtype], hp, N, x.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dt.data_ptr(), Af.data_ptr(), Df.data_ptr(),
            states.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dAD[0].data_ptr(),
            dAD[1].data_ptr(), ds_in.data_ptr(), part_bc.data_ptr(),
            part_ad.data_ptr(), B, T, nh, strides.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    return dx, dB, dC, ddt, dAD[0], dAD[1], ds_in
