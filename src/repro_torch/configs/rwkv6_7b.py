"""RWKV6-7B ("Finch") — attention-free, data-dependent decay
[arXiv:2404.05892].

32L, d_model=4096, d_ff=14336, vocab=65536. Channel mixer is SwiGLU at the
assigned d_ff (the upstream relu^2 channel-mix is a noted simplification).
O(1) recurrent state: long_500k decode RUNS for this arch.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", arch_type="ssm",
        n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
        d_ff=14336, vocab_size=65536, token_mixer="rwkv6")
