"""repro_torch — the serving path of the reproduction on PyTorch and CUDA.

A port of the JAX package `repro` for an NVIDIA H100: the allocator
(`core`, numpy), the dense GQA decoder (`models`, `configs`), its
hand-written Hopper attention kernels (`kernels`), the batched engine
(`serving`) and the plan -> deploy -> serve launcher (`launch`). Entry
points run on CUDA unless the caller passes `device="cpu"`.
"""
