"""Launchers of the Hopper head_dim-split decode pair.

The kernels are CUDA C++ in `kernels/csrc/decode_attention_hd.cu`, which
carries the design note: on a decode cache that a mesh splits on head_dim,
they replace `repro/kernels/decode_attention/kernel.py::decode_attention`
on one rank's slice of hl lanes, and are bound by the bytes of the k and v
slices and of the f32 scores. `decode_scores_hd` writes the slice's
partial scores; the caller sums them over the slices (an all-reduce);
`decode_softmax_pv_hd` runs the masked softmax and P V on the summed
scores. This module checks the operands (the kernels read a row in pieces
of 8 lanes, or of 4 where hl is not a multiple of 8, and a piece's load
needs its bytes' alignment, at most 16), allocates the outputs and the
merge's workspace, picks the cut of the softmax's slots into runs, and
launches each kernel on the current stream through its C entry point.
The softmax kernel merges its runs in the same launch (the last block of
a group to finish, counted in the int32 buffer per device and stream that
the whole-head decode kernel uses too, and that the kernel leaves at
zero).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned
from ..decode_attention.kernel import _merge_counters

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LANES = tuple(range(4, 65, 4))   # head_dim lanes a slice may hold
MAX_GROUP = 16     # most query heads per KV head
TILE = 128         # slots per tile of the softmax kernel (TILE in the source)
SCORE_BLOCK = 256  # slots per block of the scores kernel (NTH)
RUNS_PER_SM = 4    # runs (blocks) per SM the cut aims at: 4 fit an SM
MAX_SPLIT = 64     # most runs per (b, kv) group (MAX_SPLIT in the source)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64


@functools.cache
def _entry(name: str):
    fn = getattr(_build.load("decode_attention_hd"), name)
    if name == "decode_scores_hd_fwd":
        fn.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, *([_L] * 12), _P]
    else:
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _F, *([_L] * 12), _P]
    fn.restype = ctypes.c_int
    return fn


def _align(hl: int, dtype: torch.dtype) -> int:
    """Bytes of a piece the kernels load: 8 lanes, or 4 where hl is not a
    multiple of 8 (W in the source), at most 16 bytes a load."""
    lanes = 8 if hl % 8 == 0 else 4
    return min(16, lanes * dtype.itemsize)


def _check_pair(kernel: str, a, a_name: str, c, c_name: str) -> None:
    """a [B,KV,G|S,..] and c [B,KV,S,hl] on one CUDA device, of the
    kernels' shapes and types, with unit last strides."""
    if a.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got "
                         f"{a.device}")
    if c.device != a.device:
        raise ValueError(f"{c_name} is on {c.device}, {a_name} on {a.device}")
    if c.dtype not in DTYPES:
        raise TypeError(f"{c_name} must be one of {list(DTYPES)}, got "
                        f"{c.dtype}")
    if a.dim() != 4 or c.dim() != 4:
        raise ValueError(f"want 4-D {a_name} and {c_name}, got "
                         f"{tuple(a.shape)}, {tuple(c.shape)}")
    if a.shape[:2] != c.shape[:2]:
        raise ValueError(f"incompatible {a_name} {tuple(a.shape)} and "
                         f"{c_name} {tuple(c.shape)}")
    B, KV, S, hl = c.shape
    if hl not in LANES:
        raise ValueError(f"head_dim slice of {hl} lanes not in {LANES}")
    if min(B, KV, S) == 0 or B > 65535 or -(-S // SCORE_BLOCK) > 65535:
        raise ValueError(f"unsupported sizes {tuple(c.shape)}")
    for name, t in ((a_name, a), (c_name, c)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")


def decode_scores_hd(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,KV,G,hl]; k [B,KV,S,hl], one dtype (f32 or bf16), on one CUDA
    device, any strides with a unit last one. Returns the contiguous
    [B,KV,G,S] f32 partial scores."""
    _check_pair("decode_scores_hd", q, "q", k, "k")
    if q.dtype != k.dtype:
        raise TypeError(f"q and k must share a dtype, got {q.dtype}, "
                        f"{k.dtype}")
    B, KV, G, hl = q.shape
    S = k.shape[2]
    if q.shape[3] != hl or k.shape[3] != hl:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if not 0 < G <= MAX_GROUP:
        raise ValueError(f"group size {G} not in 1..{MAX_GROUP}")
    check_aligned("decode_scores_hd", _align(hl, q.dtype), q=q, k=k)
    s = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _entry("decode_scores_hd_fwd")(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), s.data_ptr(), B, KV,
            G, S, hl, *q.stride(), *k.stride(), *s.stride(), stream)
    if err:
        raise RuntimeError(f"decode_scores_hd kernel launch failed: CUDA "
                           f"error {err}")
    return s


@functools.cache
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split(B: int, KV: int, S: int, n_sm: int) -> tuple[int, int]:
    """(n_split, split_len): runs of whole 128-slot tiles covering S, none
    empty, each of about the total tile count B * KV * ceil(S / 128) over
    RUNS_PER_SM * n_sm tiles, and at most MAX_SPLIT runs per group."""
    n_tiles = -(-S // TILE)
    per = max(-(-B * KV * n_tiles // (RUNS_PER_SM * n_sm)),
              -(-n_tiles // MAX_SPLIT))
    return -(-n_tiles // per), per * TILE


def workspace_floats(B: int, KV: int, G: int, hl: int, n_split: int) -> int:
    """f32 scratch of the run merge: per run, acc [G, hl], m [G], l [G]
    (`part_floats` in the source)."""
    return B * KV * n_split * (G * hl + 2 * G)


def decode_softmax_pv_hd(s: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, pos: int,
                         scale: float) -> torch.Tensor:
    """s [B,KV,G,S] f32; v [B,KV,S,hl] (f32 or bf16); k_pos [S] int32; pos
    an int; scale the whole head's. All on one CUDA device, any strides
    with a unit last one. Returns [B,KV,G,hl] in v's dtype, contiguous,
    zeros for a group with no admissible slot."""
    pos = int(pos)
    _check_pair("decode_softmax_pv_hd", s, "s", v, "v")
    B, KV, S, hl = v.shape
    G = s.shape[2]
    if s.dtype != torch.float32 or s.shape[3] != S:
        raise ValueError(f"s must be f32 [B,KV,G,{S}], got {s.dtype} "
                         f"{tuple(s.shape)}")
    if not 0 < G <= MAX_GROUP:
        raise ValueError(f"group size {G} not in 1..{MAX_GROUP}")
    if k_pos.device != v.device:
        raise ValueError(f"k_pos is on {k_pos.device}, v on {v.device}")
    if (k_pos.dtype != torch.int32 or k_pos.shape != (S,)
            or not k_pos.is_contiguous()):
        raise ValueError(f"k_pos must be a contiguous int32 [{S}], got "
                         f"{k_pos.dtype} {tuple(k_pos.shape)}")
    if not -2 ** 31 <= pos < 2 ** 31:
        raise ValueError(f"pos {pos} does not fit int32")
    # s, k_pos: read by element
    check_aligned("decode_softmax_pv_hd", _align(hl, v.dtype), v=v)
    n_split, split_len = split(B, KV, S, _n_sm(v.device))
    out = torch.empty((B, KV, G, hl), dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    ws = cnt = None
    if n_split > 1:
        ws = torch.empty(workspace_floats(B, KV, G, hl, n_split),
                         dtype=torch.float32, device=v.device)
        cnt = _merge_counters(v.device, stream, B * KV)
    with torch.cuda.device(v.device):
        err = _entry("decode_softmax_pv_hd_fwd")(
            DTYPES[v.dtype], s.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(), k_pos.data_ptr(), pos,
            B, KV, G, S, hl, n_split, split_len, float(scale), *s.stride(),
            *v.stride(), *out.stride(), stream)
    if err:
        raise RuntimeError(f"decode_softmax_pv_hd kernel launch failed: CUDA "
                           f"error {err}")
    return out
