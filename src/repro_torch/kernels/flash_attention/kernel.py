"""Launcher of the Hopper flash-attention (prefill) kernel.

The kernel is CUDA C++ in `kernels/csrc/flash_attention.cu`, which carries
the design note: it replaces `repro/kernels/flash_attention/kernel.py::
flash_attention` and is bound by operations at prefill lengths; bf16
inputs stream through TMA into a shared-memory ring and run on the tensor
cores (wgmma), f32 inputs run in IEEE f32 on the CUDA cores. This module
checks the operands (TMA needs 16-byte-aligned bases and strides),
allocates the output (and, for training, the per-row log-sum-exp the
backward kernel reads) and launches the kernel on the current stream
through its C entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _F, *([_L] * 16), _P]


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k, v, q_pos, k_pos):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, "
                         f"got {q.device}")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,H,Tq,hd] and k, v [B,KV,Tk,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    Bk, KV, Tk, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(B, H, Tq, Tk) == 0 or max(Tq, Tk) >= 2 ** 31:
        raise ValueError(f"unsupported sizes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    check_aligned("flash_attention", q=q, k=k, v=v)
    for name, t, n in (("q_pos", q_pos, Tq), ("k_pos", k_pos, Tk)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: int = 0, with_lse: bool = False):
    """q [B,H,Tq,hd]; k, v [B,KV,Tk,hd]; q_pos [Tq], k_pos [Tk] int32, all
    on one CUDA device, any strides with a unit last one. Returns
    [B,H,Tq,hd] in q's dtype, laid out in memory like q; with `with_lse`,
    (out, lse): lse [B,H,Tq] f32, each row's natural-log log-sum-exp of its
    scaled logits, +inf for a row with no admissible key."""
    _check(q, k, v, q_pos, k_pos)
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    check_aligned("flash_attention", out=out)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        err = _entry()(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(),
            B, H, KV, Tq, Tk, int(window), hd ** -0.5,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if with_lse else out
