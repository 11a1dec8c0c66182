// Dense GROUP BY aggregates for Hopper (sm_90a): per-bin sums and counts
// (dense_sums) and per-bin minima or maxima and counts (dense_extrema) over
// a key space [0, bins).
//
//   dense_sums     <- radx_tpu/kernels/aggregate.py::_dense_agg_kernel (:47,
//                     called at :148).  uint32 sums (wrapping mod 2^32) and
//                     int32 counts, bins a power of two in [128, 65536].
//   dense_extrema  <- radx_tpu/kernels/aggregate.py::_dense_extrema_kernel
//                     (:164, called at :257).  Minimum or maximum of
//                     order-isomorphic int32 values and int32 counts, bins a
//                     power of two in [128, 8192].  Empty bins keep the
//                     identity (INT32_MAX for min, INT32_MIN for max).
//
// Rows whose key is >= bins (as uint32), and rows at or past n_valid, are
// dropped, as the JAX one-hots drop them; nothing is written for them.
// n_valid is a device int32 (or null for all n rows) that each block reads
// itself, so a caller with the row count on the device needs no host sync
// (the counterpart of the JAX scalar prefetch, aggregate.py:126, :153).
//
// Bound on the card: the reads of the two input columns (8 bytes a row);
// the shared-memory atomics when a warp's lanes hit one bin.  The TPU
// computes these as one-hot matmuls over value bytes with the accumulator
// carried across its ordered grid; a GPU histogram needs no matmul.  Design:
// a grid-stride pass in which every block keeps private bins in shared
// memory (bins * 8 bytes, up to 64 KB at 8192 bins) and flushes its nonzero
// bins into the zeroed (or identity-filled) outputs with one global atomic
// each; above 8192 bins the atomics go to device memory (resolved in L2).
// A warp whose 32 lanes hold one key (the hot-key case: one bucket, or a
// skewed one) folds them with one warp reduction and one atomic — the CUDA
// form of the reference's subgroup-partition ranking, RadX2-SM7-DEV/
// counting.comp:50-73, kept to the case where it pays; every other warp
// issues its atomics directly and the hardware serialises lanes of one
// address.  Grouping every warp with __match_any_sync measured 8x slower on
// spread keys on one H100 (PERF.md).  Integer adds, minima and maxima are
// associative and commutative: the result is exact whatever the order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemBins = 8192;  // bins * 8 bytes = 64 KB of shared memory
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ int64_t valid_rows(const int* n_valid, int64_t n) {
  if (n_valid == nullptr) return n;
  const int64_t nv = *n_valid;
  return nv < 0 ? 0 : (nv > n ? n : nv);
}

// One pass over the rows: each warp takes 32 consecutive rows at a time (all
// lanes loop together, so the warp-wide intrinsics see every lane); a lane
// whose row is invalid or out of range carries the key `bins`, which is
// never folded.  Op::fold(key, value, one_key, lane, bins) folds one row, or
// with one_key the whole warp's rows of that key at lane 0.
template <typename Op>
__device__ __forceinline__ void scan_rows(const unsigned* keys,
                                          const int* vals, int64_t nv,
                                          unsigned bins, Op& op) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w = warp << 5; w < nv; w += warps << 5) {
    const int64_t i = w + lane;
    unsigned k = bins;
    int v = 0;
    if (i < nv) {
      k = keys[i];
      v = vals[i];
      if (k >= bins) k = bins;
    }
    const bool one_key = __all_sync(kFullWarp,
                                    k == __shfl_sync(kFullWarp, k, 0));
    op.fold(k, v, one_key, lane, bins);
  }
}

struct SumOp {
  unsigned* sums;  // shared or device, bins entries
  int* counts;
  __device__ __forceinline__ void fold(unsigned k, int v, bool one_key,
                                       int lane, unsigned bins) {
    if (one_key) {
      const unsigned s = __reduce_add_sync(kFullWarp, static_cast<unsigned>(v));
      if (k < bins && lane == 0) {
        atomicAdd(sums + k, s);
        atomicAdd(counts + k, 32);
      }
    } else if (k < bins) {
      atomicAdd(sums + k, static_cast<unsigned>(v));
      atomicAdd(counts + k, 1);
    }
  }
};

template <bool IS_MIN>
struct ExtOp {
  int* ext;
  int* counts;
  __device__ __forceinline__ void fold(unsigned k, int v, bool one_key,
                                       int lane, unsigned bins) {
    int e = v;
    int c = 1;
    if (one_key) {
      e = IS_MIN ? __reduce_min_sync(kFullWarp, v)
                 : __reduce_max_sync(kFullWarp, v);
      c = 32;
    }
    if (k < bins && (!one_key || lane == 0)) {
      if (IS_MIN) {
        atomicMin(ext + k, e);
      } else {
        atomicMax(ext + k, e);
      }
      atomicAdd(counts + k, c);
    }
  }
};

// dense_sums: block-private bins in shared memory, flushed with one global
// atomic per nonzero bin.
__global__ void dense_sums_smem_kernel(const unsigned* __restrict__ keys,
                                       const int* __restrict__ vals, int64_t n,
                                       int bins, const int* n_valid,
                                       unsigned* __restrict__ sums,
                                       int* __restrict__ counts) {
  extern __shared__ int smem[];
  unsigned* s_sums = reinterpret_cast<unsigned*>(smem);
  int* s_counts = smem + bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    s_sums[b] = 0;
    s_counts[b] = 0;
  }
  __syncthreads();
  SumOp op{s_sums, s_counts};
  scan_rows(keys, vals, valid_rows(n_valid, n), static_cast<unsigned>(bins),
            op);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    if (s_counts[b] != 0) {
      atomicAdd(sums + b, s_sums[b]);
      atomicAdd(counts + b, s_counts[b]);
    }
  }
}

// dense_sums above kSmemBins: the warp-merged atomics go to device memory.
__global__ void dense_sums_global_kernel(const unsigned* __restrict__ keys,
                                         const int* __restrict__ vals,
                                         int64_t n, int bins,
                                         const int* n_valid, unsigned* sums,
                                         int* counts) {
  SumOp op{sums, counts};
  scan_rows(keys, vals, valid_rows(n_valid, n), static_cast<unsigned>(bins),
            op);
}

// dense_extrema: block-private extrema and counts in shared memory (8192
// bins at most: 64 KB), flushed with one global atomic each.
template <bool IS_MIN>
__global__ void dense_extrema_kernel(const unsigned* __restrict__ keys,
                                     const int* __restrict__ vals, int64_t n,
                                     int bins, const int* n_valid,
                                     int* __restrict__ ext,
                                     int* __restrict__ counts) {
  extern __shared__ int smem[];
  int* s_ext = smem;
  int* s_counts = smem + bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    s_ext[b] = IS_MIN ? INT_MAX : INT_MIN;
    s_counts[b] = 0;
  }
  __syncthreads();
  ExtOp<IS_MIN> op{s_ext, s_counts};
  scan_rows(keys, vals, valid_rows(n_valid, n), static_cast<unsigned>(bins),
            op);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    if (s_counts[b] != 0) {
      if (IS_MIN) {
        atomicMin(ext + b, s_ext[b]);
      } else {
        atomicMax(ext + b, s_ext[b]);
      }
      atomicAdd(counts + b, s_counts[b]);
    }
  }
}

// Blocks for a grid-stride pass: enough to fill every SM at the kernel's
// occupancy, and no more than the rows need.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, size_t smem, int64_t n, int* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t need = std::max<int64_t>(1, (n + kThreads - 1) / kThreads);
  *blocks = static_cast<int>(
      std::min<int64_t>(need, static_cast<int64_t>(sms) * std::max(per_sm, 1)));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// keys: n uint32; vals: n int32 bit patterns; n_valid: device int32 or null;
// sums / counts: `bins` entries each, zeroed by the caller.
int radx_dense_sums(const void* keys, const void* vals, int64_t n,
                    int64_t bins, const void* n_valid, void* sums,
                    void* counts, void* stream) {
  if (n <= 0) return cudaSuccess;
  const unsigned* k = static_cast<const unsigned*>(keys);
  const int* v = static_cast<const int*>(vals);
  const int* nv = static_cast<const int*>(n_valid);
  unsigned* s = static_cast<unsigned*>(sums);
  int* c = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(bins);
  int blocks;
  cudaError_t err;
  if (b <= kSmemBins) {
    const size_t smem = 8 * static_cast<size_t>(b);
    err = grid_for(dense_sums_smem_kernel, smem, n, &blocks);
    if (err != cudaSuccess) return err;
    dense_sums_smem_kernel<<<blocks, kThreads, smem, st>>>(k, v, n, b, nv, s,
                                                           c);
  } else {
    err = grid_for(dense_sums_global_kernel, 0, n, &blocks);
    if (err != cudaSuccess) return err;
    dense_sums_global_kernel<<<blocks, kThreads, 0, st>>>(k, v, n, b, nv, s,
                                                          c);
  }
  return cudaGetLastError();
}

// ovals: n order-isomorphic int32; ext: `bins` entries filled with the
// identity by the caller, counts zeroed.
int radx_dense_extrema(const void* keys, const void* ovals, int64_t n,
                       int64_t bins, int64_t is_min, const void* n_valid,
                       void* ext, void* counts, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bins > kSmemBins) return cudaErrorInvalidValue;
  const unsigned* k = static_cast<const unsigned*>(keys);
  const int* v = static_cast<const int*>(ovals);
  const int* nv = static_cast<const int*>(n_valid);
  int* e = static_cast<int*>(ext);
  int* c = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(bins);
  const size_t smem = 8 * static_cast<size_t>(b);
  int blocks;
  cudaError_t err;
  if (is_min) {
    err = grid_for(dense_extrema_kernel<true>, smem, n, &blocks);
    if (err != cudaSuccess) return err;
    dense_extrema_kernel<true><<<blocks, kThreads, smem, st>>>(k, v, n, b, nv,
                                                               e, c);
  } else {
    err = grid_for(dense_extrema_kernel<false>, smem, n, &blocks);
    if (err != cudaSuccess) return err;
    dense_extrema_kernel<false><<<blocks, kThreads, smem, st>>>(k, v, n, b,
                                                                nv, e, c);
  }
  return cudaGetLastError();
}

}  // extern "C"
