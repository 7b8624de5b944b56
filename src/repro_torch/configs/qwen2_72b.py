"""Qwen2-72B — dense GQA with QKV bias [arXiv:2407.10671].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", arch_type="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064, qkv_bias=True)
