"""Qwen2-1.5B — dense GQA with QKV bias [arXiv:2407.10671].

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", arch_type="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936, qkv_bias=True)
