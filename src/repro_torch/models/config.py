"""Model configuration shared by every assigned architecture.

A single composable decoder covers all ten architectures:
  token mixer   : attention | mamba2 | rwkv6 | hybrid (mamba2 + shared attn)
  channel mixer : dense SwiGLU | MoE (scatter-dispatch, capacity-based)
  io            : single vocab | multi-codebook (audio) | prefix embeds (vlm)
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    # --- mixers ---------------------------------------------------------
    token_mixer: str = "attention"  # attention | mamba2 | rwkv6
    attn_every: int = 0             # >0: shared attention block period (zamba2)
    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 1
    shared_expert_ff: int = 0       # 0 = no shared expert
    capacity_factor: float = 1.25
    # --- SSM --------------------------------------------------------------
    ssm_state: int = 0
    d_inner: int = 0                # 0 -> 2 * d_model
    ssm_head_dim: int = 64
    conv_width: int = 4
    # --- io ----------------------------------------------------------------
    n_codebooks: int = 0            # >0: musicgen-style multi-stream tokens
    n_prefix_embeds: int = 0        # >0: vlm/audio stub frontend embeddings
    # --- attention variants -------------------------------------------------
    sliding_window: int = 0         # 0 = full causal attention
    rope_theta: float = 1e6
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    # --- beyond-paper performance variants (§Perf hillclimbs; default off =
    # paper-faithful baseline) ---------------------------------------------
    seq_shard_attention: bool = False   # context-parallel prefill attention
    moe_expert_shard_constraint: bool = False  # pin expert buffers to 'model'
    moe_w8a8: bool = False              # INT8 expert matmuls (paper's nu=0.5
    #                                     INT8 tier realized as W8A8)
    # --- loss ---------------------------------------------------------------
    loss_chunk: int = 256           # seq-chunked cross-entropy block

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def di(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.di // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def has_attention(self) -> bool:
        return self.token_mixer == "attention" or self.attn_every > 0

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k+ contexts? (SSM state or sliding window)"""
        return self.token_mixer in ("mamba2", "rwkv6") or self.sliding_window > 0

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests: 2 layers,
        d_model <= 512, <= 4 experts (assignment requirement)."""
        d = min(self.d_model, 256)
        hd = 32
        n_heads = max(2, min(4, self.n_heads)) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if self.n_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2, d_model=d,
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.n_experts else 1,
            shared_expert_ff=min(self.shared_expert_ff, 128)
            if self.shared_expert_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            d_inner=2 * d if self.d_inner else 0,
            ssm_head_dim=32,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 4)
            if self.n_prefix_embeds else 0,
            loss_chunk=64,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytical parameter count (total)."""
        n = self.vocab_size * self.d_model * max(self.n_codebooks, 1)   # embed
        n += self.d_model * self.vocab_size * max(self.n_codebooks, 1)  # head
        per = 2 * self.d_model                                          # norms
        if self.token_mixer == "attention":
            per += self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.hd
            per += self.n_heads * self.hd * self.d_model
        elif self.token_mixer == "mamba2":
            di, N, nh = self.di, self.ssm_state, self.ssm_heads
            per += self.d_model * (2 * di + 2 * N + nh) + di * self.d_model
            per += (di + 2 * N) * self.conv_width + 2 * nh
        elif self.token_mixer == "rwkv6":
            per += 5 * self.d_model * self.d_model + self.d_model * 64 * 2
        if self.n_experts:
            per += self.d_model * self.n_experts                        # router
            per += 3 * self.n_experts * self.d_model * self.d_ff
            if self.shared_expert_ff:
                per += 3 * self.d_model * self.shared_expert_ff
        else:
            per += 3 * self.d_model * self.d_ff
        n += per * self.n_layers
        if self.attn_every:
            n += (self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.hd
                  + self.n_heads * self.hd * self.d_model + 2 * self.d_model)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        moe_all = 3 * self.n_experts * self.d_model * self.d_ff * self.n_layers
        moe_act = 3 * self.top_k * self.d_model * self.d_ff * self.n_layers
        return total - moe_all + moe_act
