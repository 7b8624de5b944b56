"""Carry the reference package's parameters into the port.

The reference keeps weights as `x @ W` with W [d_in, d_out] and per-layer
tensors stacked on axis 0, exactly the port's layout, so loading is a
plain copy of every leaf in its own dtype: bf16, f32 and the W8A8
experts' int8 weights alike. The MoE tree (router, stacked experts, their
scales, the shared expert) and the io variants' leaves (codebook embed and
head [nq, V, d] / [nq, d, V], `prefix_proj`) come across unchanged."""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .decoder import check_supported


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16, which torch lacks
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: torch.device | str) -> dict:
    """The reference's parameter tree, given as numpy arrays (layers
    stacked on axis 0), as the port's parameters on `device`."""
    check_supported(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, device)

    return conv(tree)
