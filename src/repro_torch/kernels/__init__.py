"""Hand-written Hopper kernels of the port, one subpackage per kernel of
the reference package, plus the port's own grouped int8 GEMM
(`int8_grouped_matmul`, the W8A8 experts' products): `kernel.py` launches
the CUDA code in `csrc/`, `ref.py` is its plain PyTorch version, `ops.py`
the public op."""
