"""Launcher of the Hopper Mamba2 SSD scan kernel.

The kernel is CUDA C++ in `kernels/csrc/ssm_scan.cu`, which carries the
design note: it replaces `repro/kernels/ssm_scan/kernel.py::ssm_scan`;
one block per two heads of a batch row sweeps 32-step chunks, computing
each chunk's C B^T once for both heads, with every product in 3xTF32 on
the tensor cores and the f32 state in registers. This module checks the
operands, allocates the output and the final state, and launches the
kernel on the current stream through its C entry point; for training it
also writes the state each 32-step chunk starts from, which the backward
(`kernels.ssm_scan_bwd`) reads. x, Bm and Cm are read by 16-byte copies:
a base or stride that is not a multiple of 16 bytes raises ValueError
(there is no fallback).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)          # hp
STATE_DIMS = (16, 32, 64)     # N
CHUNK = 32                    # the kernels' chunk length

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_I, _I, _I, *([_P] * 10), _I, _I, _I, *([_L] * 17), _P]


@functools.cache
def _entry():
    fn = _build.load("ssm_scan").ssm_scan_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bhtd_strides(t: torch.Tensor) -> tuple[int, int, int, int]:
    """Strides of a [B,T,nh,hp] tensor in the kernel's (b, h, t, d) order."""
    sb, st, sh, sd = t.stride()
    return sb, sh, st, sd


def _check(x, Bm, Cm, dt, A, D, state):
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan kernel needs CUDA tensors, got "
                         f"{x.device}")
    named = (("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A), ("D", D))
    for name, t in named + ((("state", state),) if state is not None
                            else ()):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share one of {list(DTYPES)}, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"dt must be float32, got {dt.dtype}")
    if x.dim() != 4 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"want x [B,T,nh,hp], Bm and Cm [B,T,N], got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
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
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    check_aligned("ssm_scan", x=x, Bm=Bm, Cm=Cm)
    if min(dt.stride()) < 0:
        raise ValueError(f"dt has negative strides {dt.stride()}")
    if state is not None and (state.dtype != torch.float32
                              or state.shape != (B, nh, hp, N)
                              or not state.is_contiguous()):
        raise ValueError(f"state must be a contiguous float32 "
                         f"[{B},{nh},{hp},{N}], got {state.dtype} "
                         f"{tuple(state.shape)}")


def ssm_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor | None = None, with_states: bool = False):
    """x [B,T,nh,hp], Bm and Cm [B,T,N] of one dtype, unit last strides,
    16-byte-aligned bases and strides;
    dt [B,T,nh] f32, any strides; A, D [nh]; state [B,nh,hp,N] contiguous
    f32 or None (zeros); all on one CUDA device. Returns (y [B,T,nh,hp]
    contiguous in x's dtype, D x included; final state [B,nh,hp,N] f32),
    and with `with_states` also the state each chunk starts from, [B, nh,
    ceil(T / CHUNK), hp, N] f32."""
    _check(x, Bm, Cm, dt, A, D, state)
    B, T, nh, hp = x.shape
    N = Bm.shape[2]
    Af = A.to(torch.float32).contiguous()
    Df = D.to(torch.float32).contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s_out = torch.empty((B, nh, hp, N), dtype=torch.float32, device=x.device)
    states = (torch.empty((B, nh, -(-T // CHUNK), hp, N), dtype=torch.float32,
                          device=x.device) if with_states else None)
    with torch.cuda.device(x.device):
        err = _entry()(
            DTYPES[x.dtype], hp, N, x.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dt.data_ptr(), Af.data_ptr(), Df.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), None if states is None else states.data_ptr(),
            B, T, nh, *bhtd_strides(x), *Bm.stride(),
            *Cm.stride(), *dt.stride(), *bhtd_strides(y),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    return (y, s_out, states) if with_states else (y, s_out)
