"""repro_torch — the serving path of the reproduction on PyTorch and CUDA.

A port of the JAX package `repro` for an NVIDIA H100: the allocator
(`core`, numpy), the decoder for the attention, RWKV6, Mamba2 and hybrid
families (`models`, `configs`), its hand-written Hopper kernels
(`kernels`: flash prefill, flash decode, the SSD and WKV scans), the
batched engine (`serving`) and the plan -> deploy -> serve launcher
(`launch`). Entry points run on CUDA unless the caller passes
`device="cpu"`.
"""
