"""DeepSeek-7B — dense llama-arch [arXiv:2401.02954].

30L, d_model=4096, 32 heads (kv=32, i.e. MHA), d_ff=11008, vocab=102400.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", arch_type="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab_size=102400)
