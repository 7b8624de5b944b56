"""Llama-4-Scout-17B-16E — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model=5120, 40H (GQA kv=8), expert d_ff=8192, vocab=202048,
16 routed experts top-1 + shared expert (the "a16e" active split). Upstream
interleaves dense/MoE layers; here every layer is MoE with a shared expert
(noted in DESIGN.md). Llama-4's long-context mode is served with
chunked/sliding-window attention, so long_500k decode RUNS for this arch.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", arch_type="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        n_experts=16, top_k=1, shared_expert_ff=8192,
        sliding_window=8192)
