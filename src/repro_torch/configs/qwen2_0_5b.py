"""Qwen2-0.5B — dense GQA with QKV bias [arXiv:2407.10671].

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151936.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", arch_type="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151936, qkv_bias=True)
