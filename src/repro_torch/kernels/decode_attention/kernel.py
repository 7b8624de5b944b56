"""Launcher of the Hopper flash-decode kernel.

The kernel is CUDA C++ in `kernels/csrc/decode_attention.cu`, which carries
the design note: it replaces `repro/kernels/decode_attention/kernel.py::
decode_attention` and is bound by the bytes of the KV cache it reads. This
module checks the operands (16-byte copies need 16-byte-aligned bases and
strides), allocates the output and launches the kernel on the current
stream through its C entry point.

The cache is cut into runs of whole 64-slot tiles, one block per run and
KV head, sized from the total tile count so that each SM gets about
RUNS_PER_SM runs (flash-decoding). The runs are merged in the same launch
for bf16 (the last block of a group to finish merges, counted in an int32
buffer per device and stream that the kernel leaves at zero) and by a
second kernel for f32. The wrapper picks the cut and allocates the
merge's f32 workspace. With `return_lse` the kernel also writes each
group's log-sum-exp of its scaled scores ([B,KV,G] f32, -inf where no
slot is admissible), which a caller merging results over disjoint slot
ranges weighs them by.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._layout import check_aligned

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)
MAX_GROUP = 16     # most query heads per KV head the kernel takes
TILE = 64          # cache slots per tile (DBK in the source)
RUNS_PER_SM = 8    # runs (blocks) per SM the cut aims at
MAX_SPLIT = 64     # most runs per (b, kv) group (MAX_SPLIT in the source)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _F, *([_L] * 16), _P]


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k, v, k_pos, pos: int):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, "
                         f"got {q.device}")
    for name, t in (("k", k), ("v", v), ("k_pos", k_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,KV,G,hd] and k, v [B,KV,S,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, KV, G, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, KV, hd):
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    S = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not 0 < G <= MAX_GROUP:
        raise ValueError(f"group size {G} not in 1..{MAX_GROUP}")
    if min(B, KV, S) == 0 or S >= 2 ** 31:
        raise ValueError(f"unsupported sizes {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a unit stride on its last axis, "
                             f"got strides {t.stride()}")
    if (k_pos.dtype != torch.int32 or k_pos.shape != (S,)
            or not k_pos.is_contiguous()):
        raise ValueError(f"k_pos must be a contiguous int32 [{S}], got "
                         f"{k_pos.dtype} {tuple(k_pos.shape)}")
    check_aligned("decode_attention", q=q, k=k, v=v, k_pos=k_pos)
    if not -2 ** 31 <= pos < 2 ** 31:
        raise ValueError(f"pos {pos} does not fit int32")


@functools.cache
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split(B: int, KV: int, S: int, n_sm: int) -> tuple[int, int]:
    """(n_split, split_len): runs of whole tiles covering S, none empty,
    each of about the total tile count B * KV * ceil(S / 64) over
    RUNS_PER_SM * n_sm tiles, and at most MAX_SPLIT runs per group."""
    n_tiles = -(-S // TILE)
    per = max(-(-B * KV * n_tiles // (RUNS_PER_SM * n_sm)),
              -(-n_tiles // MAX_SPLIT))
    return -(-n_tiles // per), per * TILE


def workspace_floats(B: int, KV: int, G: int, hd: int, n_split: int) -> int:
    """f32 scratch of the merge: per run, O [G, hd] then m [G] and l [G]
    padded to 16 bytes (`part_floats` in the source)."""
    return B * KV * n_split * (G * hd + (2 * G + 3) // 4 * 4)


_counters: dict[tuple[int | None, int], torch.Tensor] = {}


def _merge_counters(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """The int32 arrival counters of the folded merge, one per (b, kv)
    group: zeros at rest, since the merging block resets its own. One
    buffer per device and stream handle, so calls that overlap on two
    streams never count each other's blocks, while calls on one stream,
    which run in turn, share it (this kernel's and the head_dim-split
    softmax kernel's alike). Made at the stream's first call (a call
    under CUDA-graph capture makes it on the capture stream) and grown
    only for a larger B * KV."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                           device=device)
    return buf


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, pos: int, *,
                     return_lse: bool = False):
    """q [B,KV,G,hd]; k, v [B,KV,S,hd]; k_pos [S] int32; pos an int. All
    on one CUDA device, any strides with a unit last one. Returns
    [B,KV,G,hd] in q's dtype, laid out in memory like q (zeros for a group
    with no admissible slot); with `return_lse`, (that, lse [B,KV,G] f32)."""
    pos = int(pos)
    _check(q, k, v, k_pos, pos)
    B, KV, G, hd = q.shape
    S = k.shape[2]
    n_split, split_len = split(B, KV, S, _n_sm(q.device))
    out = torch.empty_like(q)
    check_aligned("decode_attention", out=out)
    lse = (torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = cnt = None
    if n_split > 1:
        ws = torch.empty(workspace_floats(B, KV, G, hd, n_split),
                         dtype=torch.float32, device=q.device)
        if q.dtype == torch.bfloat16:
            cnt = _merge_counters(q.device, stream, B * KV)
    with torch.cuda.device(q.device):
        err = _entry()(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            k_pos.data_ptr(), pos, B, KV, G, S, n_split, split_len,
            hd ** -0.5,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(),
            stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if return_lse else out
