"""Zamba2-7B — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81L, d_model=3584, shared attn 32H (kv=32), d_ff=14336, vocab=32000,
ssm_state=64. The shared attention block (single weight set) is invoked
after every 6 Mamba2 layers, per the Zamba2 shared-block design; the
shared block here is attention-only (the upstream model adds a LoRA per
invocation — noted as a simplification in DESIGN.md).

Sliding-window on the shared attention keeps the arch sub-quadratic, so
long_500k decode RUNS for this arch.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", arch_type="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab_size=32000,
        token_mixer="mamba2", attn_every=6, ssm_state=64,
        sliding_window=4096)
