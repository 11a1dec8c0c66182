// Throughput probe of 32-bit integer min / max on the card
// (radx_tpu_torch/tools/finish_bench.py --probe), the operations of the
// bitonic network's keys-only exchange.  It is no kernel of the port: it
// measures the rate that chip_smoke.py's operations bound assumes (64 a
// clock an SM at compute capability 9.0).
//
// Every thread runs eight pairs of chains of min / max, 16 operations an
// iteration of a loop that is not unrolled, each chain reading another's
// value.  finish_bench.py counts the min / max instructions of this
// function in the compiled code (IMNMX / VIMNMX) and multiplies by the
// iterations and threads, so the rate stands on what the card ran.

#include <cuda_runtime.h>

extern "C" __global__ void __launch_bounds__(256)
    int_minmax(int* out, int seed, int iters) {
  int a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = seed ^ static_cast<int>(threadIdx.x * 8 + k);
    b[k] = seed + k * 977 - static_cast<int>(threadIdx.x);
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = min(a[k], b[(k + 1) & 7]);
      b[k] = max(b[k], a[(k + 3) & 7]);
    }
  }
  int x = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) x ^= a[k] ^ b[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

// 256 threads a block; returns cudaGetLastError().
extern "C" int int_minmax_launch(int* out, int seed, int iters, int blocks,
                                 void* stream) {
  int_minmax<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, seed, iters);
  return static_cast<int>(cudaGetLastError());
}
