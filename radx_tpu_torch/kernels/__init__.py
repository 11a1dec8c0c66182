"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

  * bitonic.py — the bitonic sort network: chunk sort, fused cross passes
                 and the per-level finish (sources in ../csrc/bitonic.cu);
  * _build.py  — builds ../csrc/*.cu with nvcc and binds them with ctypes.
"""
