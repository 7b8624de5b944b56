"""Checkpointing: flat-key .npz shards + JSON manifest, the reference's
format (`repro/training/checkpoint.py`), so that checkpoints pass between
the two packages.

Tensors are saved host-side. Keys are '/'-joined tree paths, so restore
round-trips arbitrary nested dicts (tuples as '__<i>' keys). A bf16 tensor
is written as its 16 bits in a 2-byte void array (`'V2'`), the bytes the
reference's ml_dtypes bf16 leaves hold, and `np.load` gives back `V2` for
both; the manifest records no dtype. `restore(path, device)` gives the
tree back as tensors on `device`, a `V2` leaf as bf16, and W8A8 expert
weights in the port's K-major storage (`moe.kmajor_experts`): the same
shapes and values.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from ..models.moe import kmajor_experts
from ..models.weights import _tensor, to_numpy


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for idx, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{idx}/"))
    elif tree is None:
        pass
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = to_numpy(tree)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"__\d+", k) for k in node):
            return tuple(fix(node[f"__{i}"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save(path: str, tree: Any, meta: dict | None = None,
         shard_mb: int = 512) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    shards: list[dict[str, np.ndarray]] = [{}]
    size = 0
    for k, v in flat.items():
        if size > shard_mb * 2 ** 20:
            shards.append({})
            size = 0
        shards[-1][k] = v
        size += v.nbytes
    manifest = dict(meta=meta or {}, n_shards=len(shards),
                    keys={k: i for i, sh in enumerate(shards) for k in sh})
    for i, sh in enumerate(shards):
        np.savez(os.path.join(path, f"shard_{i}.npz"), **sh)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def restore(path: str, device: torch.device | str) -> tuple[Any, dict]:
    """(tree, meta), the leaves tensors on `device`."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat: dict[str, Any] = {}
    for i in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{i}.npz")) as z:
            for k in z.files:
                flat[k] = _tensor(z[k], device)
    return kmajor_experts(_unflatten(flat)), manifest["meta"]
