"""Assigned-architecture configs (``--arch <id>``).

Each module defines ``config()`` with the exact published architecture
(source cited in its docstring) and the reduced smoke variant is derived via
``ModelConfig.smoke()``. ``REGISTRY`` maps arch id -> config factory.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (deepseek_7b, internvl2_26b, kimi_k2_1t_a32b,
               llama4_scout_17b_a16e, musicgen_medium, qwen2_0_5b, qwen2_1_5b,
               qwen2_72b, rwkv6_7b, zamba2_7b)

REGISTRY = {
    "zamba2-7b": zamba2_7b.config,
    "internvl2-26b": internvl2_26b.config,
    "musicgen-medium": musicgen_medium.config,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.config,
    "deepseek-7b": deepseek_7b.config,
    "qwen2-72b": qwen2_72b.config,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.config,
    "qwen2-1.5b": qwen2_1_5b.config,
    "rwkv6-7b": rwkv6_7b.config,
    "qwen2-0.5b": qwen2_0_5b.config,
}

ARCH_IDS = list(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    return REGISTRY[arch]()
