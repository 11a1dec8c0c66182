"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

  * bitonic.py — the bitonic sort network (keys, keys and a rider, or 2-8
                 lexicographic planes): chunk sort, fused cross passes and
                 the per-level finish (sources in ../csrc/bitonic.cu);
  * aggregate.py — dense GROUP BY: per-bin sums / counts and extrema
                 (../csrc/aggregate.cu);
  * compact.py — stable mask compaction in one pass, tiles chained by a
                 decoupled look-back (../csrc/compact.cu);
  * segscan.py — segmented inclusive scan over sorted keys in one pass,
                 run summaries chained by a decoupled look-back
                 (../csrc/segscan.cu);
  * lookback.py — the CPU model of the look-back walk both share;
  * _build.py  — builds ../csrc/*.cu with nvcc and binds them with ctypes.
"""
