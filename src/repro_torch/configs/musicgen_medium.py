"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model=1536, 24H (kv=24), d_ff=6144, vocab=2048 per codebook,
4 codebooks (summed embeddings, per-codebook output heads). The EnCodec
tokenizer and the T5 text-conditioning frontend are a STUB —
``input_specs()`` supplies conditioning embeddings [B, 64, d_model]
(prefix) and codebook token streams [B, S, 4]. The delay-pattern
interleaving lives in the serving layer, not the backbone.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", arch_type="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048, n_codebooks=4, n_prefix_embeds=64)
