"""Meta-device input stand-ins for every (architecture × input shape).

No device allocation happens here: every tensor is on the meta device
(shape, dtype and strides, no data), the port's counterpart of the
reference's `jax.eval_shape` / `ShapeDtypeStruct`, the pattern the
multi-pod dry-run needs.

Input shapes (assignment):
    train_4k     seq=4,096    global_batch=256   (training)
    prefill_32k  seq=32,768   global_batch=32    (inference prefill)
    decode_32k   seq=32,768   global_batch=128   (one-token decode vs cache)
    long_500k    seq=524,288  global_batch=1     (long-context decode)

[vlm]/[audio] carve-out: the modality frontend is a stub — `input_specs`
supplies pre-projected patch/conditioning embeddings of the right shape;
the text length shrinks so prefix + text == the assigned seq_len.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import decoder
from ..models.config import ModelConfig

SHAPES = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


def shape_case(name: str) -> ShapeCase:
    s = SHAPES[name]
    return ShapeCase(name=name, **s)


def applicable(cfg: ModelConfig, case: ShapeCase) -> tuple[bool, str]:
    """long_500k requires a sub-quadratic serving path (DESIGN.md
    §Arch-applicability); every other (arch, shape) pair runs."""
    if case.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full-attention arch without sliding-window variant; "
                       "O(seq^2)/O(seq) decode at 524k is out of scope "
                       "(skip noted in DESIGN.md)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok_spec(cfg: ModelConfig, B: int, T: int) -> torch.Tensor:
    shape = (B, T, cfg.n_codebooks) if cfg.n_codebooks else (B, T)
    return _meta(shape, torch.int32)


def input_specs(cfg: ModelConfig, case: ShapeCase) -> dict:
    """Meta stand-ins for the step function's inputs. A decode step's
    `pos` is a Python int (the port's `decode_step` takes one): the last
    position of the cache, which holds `seq_len` positions."""
    B = case.global_batch
    P = cfg.n_prefix_embeds
    if case.kind in ("train", "prefill"):
        text = case.seq_len - P
        out = dict(tokens=_tok_spec(cfg, B, text))
        if case.kind == "train":
            out["targets"] = _tok_spec(cfg, B, text)
        if P:
            out["prefix"] = _meta((B, P, cfg.d_model), cfg.torch_dtype)
        return out
    # decode: one new token against a cache holding `seq_len` positions.
    return dict(cache=decoder.init_cache(cfg, B, case.seq_len, "meta"),
                tokens=_tok_spec(cfg, B, 1), pos=case.seq_len - 1)


def params_specs(cfg: ModelConfig) -> dict:
    """`decoder.init_params`'s tree on the meta device: the same leaves,
    shapes, dtypes and strides (the W8A8 experts K-major), nothing drawn."""
    def normal(shape, fan_in):
        return _meta(shape, cfg.torch_dtype)

    def full(value, shape):
        return _meta(shape, torch.float32)
    return decoder.param_tree(cfg, normal, full)
