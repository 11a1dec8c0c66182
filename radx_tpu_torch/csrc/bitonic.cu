// Bitonic sort kernels for Hopper (sm_90a): one flat int32 key array, and
// optionally a second int32 array (the rider) that moves with its key.
//
// The key array holds sign-biased uint32 keys (key ^ 0x80000000, so signed
// order is unsigned order) padded with 0x7FFFFFFF to a power-of-two length,
// and is sorted in place: every kernel reads and writes the buffers it is
// given.  The network is the standard bitonic one over the flat index: at
// merge level kk an element ascends iff bit kk of its direction index is
// clear (`invert` flips every direction); its partner at distance d is
// index ^ d.  Indices and offsets are 64-bit, so no int32 ceiling on the
// array length.
//
// The kernels are templated on the plane count NP (1: keys only, 2: keys and
// a rider), so the keys-only code is what it was.  With a rider, one
// comparison per pair decides the swap of both planes, and a pair swaps only
// when it is strictly out of order: tied keys keep their own riders.  (This
// is the tie-safe exchange of radx_tpu/kernels/bitonic.py:76-84; a form in
// which each element decides alone from its partner's key duplicated riders
// on the TPU.)
//
// Three kernels, one per Pallas kernel family of radx_tpu/kernels/bitonic.py:
//
//   chunk_sort  <- _chunk_sort_kernel (:198).  Stages 1..log2(C) inside each
//                  chunk of C keys.
//   cross_stage <- _cross_stage_kernel / _cross_stage2/3/4_kernel (:465,
//                  :352, :374, :398).  F = 1..4 consecutive distances >= the
//                  finish tile in one pass over device memory.
//   finish      <- _finishw_kernel (:427).  Every distance of one level that
//                  is below the finish tile T, inside each tile of T keys.
//
// The host side (radx_tpu_torch/kernels/bitonic.py) runs, per merge level,
// the cross passes for distances >= T (greedy F = 4, 3, 2, 1) and then one
// finish pass.  Each entry point launches on the stream it is given, does
// not synchronise, and returns cudaGetLastError() for the caller to check.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxTileThreads = 1024;  // chunk_sort / finish block size cap
constexpr int kCrossThreads = 256;
constexpr int kStaticSmemBytes = 48 * 1024;

__device__ __forceinline__ void compare_exchange(int& a, int& b, bool up) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// The two-plane exchange: swap keys and riders together iff the pair is
// strictly out of order for its direction.
__device__ __forceinline__ void compare_exchange_rider(int& a, int& b, int& ra,
                                                       int& rb, bool up) {
  if (up ? (a > b) : (a < b)) {
    const int k = a;
    a = b;
    b = k;
    const int r = ra;
    ra = rb;
    rb = r;
  }
}

// Level-kk substages at distances 2^(top-1) .. 1 over a tile of 2^log_t keys
// in shared memory (keys at s, riders at s + 2^log_t when NP == 2).  Pair p
// of the substage at distance d = 2^dj has its low element at
// lo = (p >> dj) << (dj + 1) | (p & (d - 1)); it ascends iff bit kk of
// (gbase + lo) equals `invert`.  Each pair belongs to one thread.
template <int NP>
__device__ void tile_substages(int* s, int log_t, int64_t gbase, int kk,
                               int top, int invert) {
  const int pairs = 1 << (log_t - 1);
  int* r = s + (1 << log_t);
  for (int dj = top - 1; dj >= 0; --dj) {
    const int d = 1 << dj;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int lo = ((p >> dj) << (dj + 1)) | (p & (d - 1));
      const bool up = (((gbase + lo) >> kk) & 1) == invert;
      int a = s[lo];
      int b = s[lo + d];
      if constexpr (NP == 1) {
        compare_exchange(a, b, up);
        s[lo] = a;
        s[lo + d] = b;
      } else if (up ? (a > b) : (a < b)) {
        s[lo] = b;
        s[lo + d] = a;
        const int t = r[lo];
        r[lo] = r[lo + d];
        r[lo + d] = t;
      }
    }
    __syncthreads();
  }
}

// Copy a tile of n keys (and n riders) between device and shared memory.
template <int NP>
__device__ __forceinline__ void load_tile(int* s, const int* x, const int* y,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = x[i];
    if constexpr (NP == 2) s[n + i] = y[i];
  }
  __syncthreads();
}

template <int NP>
__device__ __forceinline__ void store_tile(int* x, int* y, const int* s,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = s[i];
    if constexpr (NP == 2) y[i] = s[n + i];
  }
}

// chunk_sort — replaces radx_tpu/kernels/bitonic.py::_chunk_sort_kernel.
// Bound on the card: shared memory.  A chunk of C keys costs one read and
// one write of device memory but log2(C)(log2(C)+1)/2 substages (105 at
// C = 2^14), each a shared-memory read and write of every key behind a
// __syncthreads().  Design: one block per chunk, the whole chunk resident in
// dynamic shared memory for every stage, so device memory is touched once.
// The direction index is the global flat index (chunks alternate direction,
// as the cross-chunk merge expects); `ascending` uses the index within the
// chunk, so every chunk sorts ascending on its own.  With a rider the tile
// holds both planes (twice the shared memory for the same chunk).
template <int NP>
__global__ void chunk_sort_kernel(int* __restrict__ x, int* __restrict__ y,
                                  int log_c, int invert, int ascending) {
  extern __shared__ int s[];
  const int c = 1 << log_c;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_c;
  int* yb = NP == 2 ? y + base : nullptr;
  load_tile<NP>(s, x + base, yb, c);
  const int64_t gbase = ascending ? 0 : base;
  for (int kk = 1; kk <= log_c; ++kk) {
    tile_substages<NP>(s, log_c, gbase, kk, kk, invert);
  }
  store_tile<NP>(x + base, yb, s, c);
}

// finish — replaces radx_tpu/kernels/bitonic.py::_finishw_kernel.
// Bound on the card: shared memory, as chunk_sort (log2(T) substages per
// level).  On the TPU the last log2(W) cross distances of a level fold into
// a W-chunk finish sized by VMEM; here every distance below the tile T runs
// in one block's shared memory and the distances >= T are cross passes, so
// a level costs one device-memory pass for its whole tail.  The direction
// comes from bit kk of each key's global index, so a tile may hold several
// merge groups of a low level.
template <int NP>
__global__ void finish_kernel(int* __restrict__ x, int* __restrict__ y,
                              int log_t, int kk, int invert) {
  extern __shared__ int s[];
  const int t = 1 << log_t;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_t;
  int* yb = NP == 2 ? y + base : nullptr;
  load_tile<NP>(s, x + base, yb, t);
  tile_substages<NP>(s, log_t, base, kk, min(log_t, kk), invert);
  store_tile<NP>(x + base, yb, s, t);
}

// cross_stage<F> — replaces radx_tpu/kernels/bitonic.py::_cross_stage_kernel
// (F = 1) and _cross_stage2/3/4_kernel (F = 2, 3, 4).
// Bound on the card: device-memory bandwidth; each pass reads and writes
// the whole array once and does F compare-exchanges per key.  Design: F
// consecutive distances fused per pass (4 distances for the cost of one
// pass at F = 4).  Thread t owns the 2^F keys i0 + u*J (u < 2^F, J =
// 2^j_low the lowest distance) in registers and runs the F substages (2^(F-1)
// J .. J) there.  Adjacent threads take adjacent i0, so every load and store
// coalesces (J >= the finish tile >= 32).  The level bit kk lies above the
// group's index bits, so one direction serves the whole group.  A rider
// keeps its 2^F values in registers beside the keys.
template <int F, int NP>
__global__ void cross_stage_kernel(int* __restrict__ x, int* __restrict__ y,
                                   int64_t groups, int j_low, int kk,
                                   int invert) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= groups) return;
  const int64_t jmask = (static_cast<int64_t>(1) << j_low) - 1;
  const int64_t stride = jmask + 1;
  const int64_t i0 = ((t & ~jmask) << F) | (t & jmask);
  const bool up = ((i0 >> kk) & 1) == invert;
  constexpr int kW = 1 << F;
  int v[kW];
  int w[NP == 2 ? kW : 1];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    v[u] = x[i0 + u * stride];
    if constexpr (NP == 2) w[u] = y[i0 + u * stride];
  }
#pragma unroll
  for (int sb = F - 1; sb >= 0; --sb) {
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      if (!(u & (1 << sb))) {
        const int o = u | (1 << sb);
        if constexpr (NP == 1) {
          compare_exchange(v[u], v[o], up);
        } else {
          compare_exchange_rider(v[u], v[o], w[u], w[o], up);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    x[i0 + u * stride] = v[u];
    if constexpr (NP == 2) y[i0 + u * stride] = w[u];
  }
}

template <int F, int NP>
cudaError_t launch_cross(int* x, int* y, int64_t n, int j_low, int kk,
                         int invert, cudaStream_t stream) {
  const int64_t groups = n >> F;
  const int64_t blocks = (groups + kCrossThreads - 1) / kCrossThreads;
  cross_stage_kernel<F, NP><<<static_cast<unsigned>(blocks), kCrossThreads, 0,
                              stream>>>(x, y, groups, j_low, kk, invert);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_cross(int* x, int* y, int64_t n, int j_low, int kk,
                         int invert, cudaStream_t stream) {
  return y ? launch_cross<F, 2>(x, y, n, j_low, kk, invert, stream)
           : launch_cross<F, 1>(x, y, n, j_low, kk, invert, stream);
}

// One block per tile of 2^log_t keys, the tile's NP planes in dynamic shared
// memory (opted in above the 48 KB default).
template <typename Kernel>
cudaError_t tile_launch_config(Kernel kernel, int np, int log_t, int* threads,
                               size_t* smem) {
  *smem = (sizeof(int) * np) << log_t;
  *threads = std::min(1 << (log_t - 1), kMaxTileThreads);
  if (*smem > kStaticSmemBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int NP>
cudaError_t chunk_sort(int* x, int* y, int64_t n, int log_c, int invert,
                       int ascending, cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err =
      tile_launch_config(chunk_sort_kernel<NP>, NP, log_c, &threads, &smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = n >> log_c;
  chunk_sort_kernel<NP><<<static_cast<unsigned>(blocks), threads, smem,
                          stream>>>(x, y, log_c, invert, ascending);
  return cudaGetLastError();
}

template <int NP>
cudaError_t finish(int* x, int* y, int64_t n, int log_t, int kk, int invert,
                   cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err =
      tile_launch_config(finish_kernel<NP>, NP, log_t, &threads, &smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = n >> log_t;
  finish_kernel<NP><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, y, log_t, kk, invert);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// In every entry point y is the rider array, or null for keys only.

int radx_chunk_sort(void* x, void* y, int64_t n, int64_t log_c, int64_t invert,
                    int64_t ascending, void* stream) {
  int* k = static_cast<int*>(x);
  int* r = static_cast<int*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lc = static_cast<int>(log_c);
  const int inv = static_cast<int>(invert);
  const int asc = static_cast<int>(ascending);
  return r ? chunk_sort<2>(k, r, n, lc, inv, asc, s)
           : chunk_sort<1>(k, r, n, lc, inv, asc, s);
}

int radx_finish(void* x, void* y, int64_t n, int64_t log_t, int64_t kk,
                int64_t invert, void* stream) {
  int* k = static_cast<int*>(x);
  int* r = static_cast<int*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lt = static_cast<int>(log_t);
  const int level = static_cast<int>(kk);
  const int inv = static_cast<int>(invert);
  return r ? finish<2>(k, r, n, lt, level, inv, s)
           : finish<1>(k, r, n, lt, level, inv, s);
}

int radx_cross_stage(void* x, void* y, int64_t n, int64_t j_low, int64_t f,
                     int64_t kk, int64_t invert, void* stream) {
  int* p = static_cast<int*>(x);
  int* r = static_cast<int*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int j = static_cast<int>(j_low);
  const int k = static_cast<int>(kk);
  const int inv = static_cast<int>(invert);
  switch (f) {
    case 1: return launch_cross<1>(p, r, n, j, k, inv, s);
    case 2: return launch_cross<2>(p, r, n, j, k, inv, s);
    case 3: return launch_cross<3>(p, r, n, j, k, inv, s);
    case 4: return launch_cross<4>(p, r, n, j, k, inv, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* radx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
