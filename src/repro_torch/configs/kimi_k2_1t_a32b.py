"""Kimi-K2 — trillion-parameter MoE (paper-table entry) [arXiv:2501.kimi2].

61L, d_model=7168, 64H (GQA kv=8), expert d_ff=2048, vocab=163840,
384 routed experts top-8 + 1 shared expert. Upstream's first dense layer is
folded into the uniform MoE stack (noted in DESIGN.md); MLA is served here
as GQA at the assigned head counts. Long context is served with a sliding
window, so long_500k decode RUNS for this arch.

Total params ~1.0T; active ~32B/token — the framework's largest arch and
the main expert-parallel / all-to-all stress case.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", arch_type="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=2048, vocab_size=163840,
        n_experts=384, top_k=8, shared_expert_ff=2048,
        sliding_window=8192)
