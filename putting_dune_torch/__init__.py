"""PyTorch / CUDA port of putting_dune_tpu for one NVIDIA H100.

The package mirrors the JAX package's module names and functional shape
(explicit state in, state out; one `torch.Generator` per call). Its hot
kernels (the fused noise chain and 512^2 CLAHE) are hand-written CUDA in
`csrc/`, built with nvcc at first use; on CPU tensors each kernel wrapper
runs its plain PyTorch twin instead.
"""

__version__ = '0.1.0'
