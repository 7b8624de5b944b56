"""Carry the reference package's parameters into the port.

The reference keeps weights as `x @ W` with W [d_in, d_out] and per-layer
tensors stacked on axis 0, exactly the port's layout, so loading is a
plain copy of every leaf in its own dtype: bf16, f32 and the W8A8
experts' int8 weights alike. The MoE tree (router, stacked experts, their
scales, the shared expert) and the io variants' leaves (codebook embed and
head [nq, V, d] / [nq, d, V], `prefix_proj`) come across unchanged, in
shape and value; the W8A8 experts' int8 weights land in the port's
K-major storage (`moe.kmajor_experts`), which `to_numpy` reads back
value for value.

bf16 has no numpy dtype without ml_dtypes, which the card's machine
lacks. A bf16 leaf therefore leaves the port as its 16 bits in a 2-byte
void array (`'V2'`, what `np.load` returns for the reference's bf16
checkpoint leaves) and a `V2` leaf comes back as bf16."""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .decoder import check_supported
from .moe import kmajor_experts


BF16_VOID = np.dtype("V2")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16, which torch lacks
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:   # bf16 bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array, bf16 as its bits in a `V2` array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_VOID)
    return t.numpy()


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: torch.device | str) -> dict:
    """The reference's parameter tree, given as numpy arrays (layers
    stacked on axis 0), as the port's parameters on `device`."""
    check_supported(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, device)

    return kmajor_experts(conv(tree))


def params_to_numpy(params: dict) -> dict:
    """The inverse of `params_from_numpy`: the port's parameters as a tree
    of host numpy arrays (bf16 leaves as `V2`, see above)."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else to_numpy(v)
            for k, v in params.items()}
