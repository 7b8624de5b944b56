"""Hand-written Hopper kernels of the port, one subpackage per kernel of
the reference package: `kernel.py` launches the CUDA code in `csrc/`,
`ref.py` is its plain PyTorch version, `ops.py` the public op."""
