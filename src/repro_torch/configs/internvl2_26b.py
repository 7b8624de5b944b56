"""InternVL2-26B — VLM: InternViT frontend + InternLM2 LM backbone
[arXiv:2404.16821].

Backbone (implemented here, per the assignment carve-out): 48L,
d_model=6144, 48H (GQA kv=8), d_ff=16384, vocab=92553. The InternViT
vision encoder + MLP projector are a STUB — ``input_specs()`` supplies
pre-projected patch embeddings [B, 256, d_model].
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", arch_type="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553, n_prefix_embeds=256)
