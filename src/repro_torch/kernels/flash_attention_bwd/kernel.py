"""Launcher of the Hopper flash-attention backward kernel.

The kernel is CUDA C++ in `kernels/csrc/flash_attention_bwd.cu`, which
carries the design note: the backward of `kernels/csrc/flash_attention.cu`,
for training (the reference differentiates its XLA attention instead; no
TPU kernel of it has a backward). One call launches a pre-pass (D =
rowsum(dO * O), tile position ranges, rows with no admissible key) and
then the main kernel, whose blocks take dK/dV work items (a key tile and
a KV head, looping over the group's query heads: no atomics) and dQ work
items; in bf16 they feed wgmma from a TMA ring. It takes the forward's
head dims.
This module checks the operands, allocates the gradients and the
workspace and launches on the current stream through its C entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned
from ..flash_attention.kernel import DTYPES, HEAD_DIMS

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I, _I, *([_P] * 15), _I, _I, _I, _I, _I, _I, _F, _P, _P]


@functools.cache
def _entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k, v, o, lse, do, q_pos, k_pos):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel needs CUDA tensors, "
                         f"got {q.device}")
    named = (("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse),
             ("q_pos", q_pos), ("k_pos", k_pos))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError(f"q, k, v, o, do must share one of {list(DTYPES)}, "
                        f"got {[t.dtype for t in (q, k, v, o, do)]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,H,Tq,hd] and k, v [B,KV,Tk,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    Bk, KV, Tk, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(B, H, Tq, Tk) == 0 or max(Tq, Tk) >= 2 ** 31:
        raise ValueError(f"unsupported sizes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Tq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous f32 [{B},{H},{Tq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    for name, t, n in (("q_pos", q_pos, Tq), ("k_pos", k_pos, Tk)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    check_aligned("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int = 0):
    """q, o, do [B,H,Tq,hd]; k, v [B,KV,Tk,hd]; lse [B,H,Tq] f32 from the
    forward (`flash_attention(..., with_lse=True)`); positions int32, all
    on one CUDA device, any strides with a unit last one. Returns (dq, dk,
    dv), each laid out in memory like q, k, v."""
    _check(q, k, v, o, lse, do, q_pos, k_pos)
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    check_aligned("flash_attention_bwd", dq=dq, dk=dk, dv=dv)
    n_q32, n_k64 = -(-Tq // 32), -(-Tk // 64)
    dsum = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    ints = torch.empty(B * H * n_q32 + 2 * n_q32 + 2 * n_k64,
                       dtype=torch.int32, device=q.device)
    lost, qrange, krange = ints.split([B * H * n_q32, 2 * n_q32, 2 * n_k64])
    strides = torch.tensor([s for t in (q, k, v, o, do, dq, dk, dv)
                            for s in t.stride()], dtype=torch.int64)
    with torch.cuda.device(q.device):
        err = _entry()(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), lost.data_ptr(),
            qrange.data_ptr(), krange.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), B, H, KV, Tq, Tk, int(window), hd ** -0.5,
            strides.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv
