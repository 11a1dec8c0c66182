// Bitonic sort kernels for Hopper (sm_90a) over P flat int32 planes of one
// power-of-two length, sorted in place.
//
// Plane 0 holds sign-biased uint32 keys (key ^ 0x80000000, so signed order is
// unsigned order) padded with 0x7FFFFFFF.  The network is the standard
// bitonic one over the flat index: at merge level kk an element ascends iff
// bit kk of its direction index is clear (`invert` flips every direction);
// its partner at distance d is index ^ d.  Indices and offsets are 64-bit, so
// no int32 ceiling on the array length.
//
// The kernels are templated on the compare mode and the plane count
// (NCMP, P), and the planes arrive as a by-value struct of pointers:
//
//   (1, 1)      keys only, a min/max exchange (the keys-only sort);
//   (1, 2)      keys and one rider ("/rider", group-by's unstable sort);
//   (2, 2..8)   lexicographic ("/lex<P>"): planes 0 and 1 compare as signed
//               int32, (plane 0, plane 1) lexicographically; planes 2..P-1
//               ride along (the stable sorts, top_k, join, Table).
//
// With P > 1, one comparison per pair decides the swap of every plane, and a
// pair swaps only when it is strictly out of order: tied rows keep their own
// riders.  (This is the tie-safe exchange of radx_tpu/kernels/bitonic.py:
// 76-84; a form in which each element decides alone from its partner's key
// duplicated riders on the TPU.)  With a unique (plane 0, plane 1) pair, as
// the stable paths give, the order is total and the result is the JAX one.
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
// the cross passes for distances >= T (greedy F = max_fusion(P) .. 1) and
// then one finish pass.  Each entry point launches on the stream it is
// given, does not synchronise, and returns cudaGetLastError() for the caller
// to check.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxTileThreads = 1024;  // chunk_sort / finish block size cap
constexpr int kCrossThreads = 256;
constexpr int kStaticSmemBytes = 48 * 1024;
constexpr int kMaxPlanes = 8;

// The planes of one sort, passed to every kernel by value.
struct Planes {
  int* p[kMaxPlanes];
};

// Distances fused per cross pass at P planes: 2^F * P values live in
// registers per thread, at most 48 (no spills; ptxas report in PERF.md).
// Kept in step with bitonic.py::max_fusion.
constexpr int max_fusion(int np) {
  return np <= 3 ? 4 : np <= 6 ? 3 : 2;
}

__device__ __forceinline__ void compare_exchange(int& a, int& b, bool up) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// Row (a0, a1) strictly after row (b0, b1) in the NCMP-plane order.
template <int NCMP>
__device__ __forceinline__ bool after(int a0, int a1, int b0, int b1) {
  if constexpr (NCMP == 1) {
    return a0 > b0;
  } else {
    return a0 > b0 || (a0 == b0 && a1 > b1);
  }
}

// Does the pair (low row, high row) swap for its direction?
template <int NCMP>
__device__ __forceinline__ bool must_swap(int a0, int a1, int b0, int b1,
                                          bool up) {
  return up ? after<NCMP>(a0, a1, b0, b1) : after<NCMP>(b0, b1, a0, a1);
}

// Level-kk substages at distances 2^(top-1) .. 1 over a tile of 2^log_t rows
// in shared memory (plane j at s + j * 2^log_t).  Pair p of the substage at
// distance d = 2^dj has its low element at
// lo = (p >> dj) << (dj + 1) | (p & (d - 1)); it ascends iff bit kk of
// (gbase + lo) equals `invert`.  Each pair belongs to one thread.
template <int NCMP, int P>
__device__ void tile_substages(int* s, int log_t, int64_t gbase, int kk,
                               int top, int invert) {
  const int pairs = 1 << (log_t - 1);
  const int t = 1 << log_t;
  for (int dj = top - 1; dj >= 0; --dj) {
    const int d = 1 << dj;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int lo = ((p >> dj) << (dj + 1)) | (p & (d - 1));
      const bool up = (((gbase + lo) >> kk) & 1) == invert;
      int a = s[lo];
      int b = s[lo + d];
      if constexpr (P == 1) {
        compare_exchange(a, b, up);
        s[lo] = a;
        s[lo + d] = b;
      } else {
        const int a1 = NCMP == 2 ? s[t + lo] : 0;
        const int b1 = NCMP == 2 ? s[t + lo + d] : 0;
        if (must_swap<NCMP>(a, a1, b, b1, up)) {
          s[lo] = b;
          s[lo + d] = a;
#pragma unroll
          for (int j = 1; j < P; ++j) {
            int* r = s + j * t;
            const int x = r[lo];
            r[lo] = r[lo + d];
            r[lo + d] = x;
          }
        }
      }
    }
    __syncthreads();
  }
}

// Copy a tile of n rows of every plane between device and shared memory,
// the planes of one row together (P loads in flight per step).
template <int P>
__device__ __forceinline__ void load_tile(int* s, const Planes& x,
                                          int64_t base, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < P; ++j) s[j * n + i] = x.p[j][base + i];
  }
  __syncthreads();
}

template <int P>
__device__ __forceinline__ void store_tile(const Planes& x, int64_t base,
                                           const int* s, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < P; ++j) x.p[j][base + i] = s[j * n + i];
  }
}

// chunk_sort — replaces radx_tpu/kernels/bitonic.py::_chunk_sort_kernel.
// Bound on the card: shared memory.  A chunk of C rows costs one read and
// one write of device memory but log2(C)(log2(C)+1)/2 substages (105 at
// C = 2^14), each a shared-memory read and write of every key behind a
// __syncthreads().  Design: one block per chunk, the whole chunk resident in
// dynamic shared memory for every stage, so device memory is touched once.
// The direction index is the global flat index (chunks alternate direction,
// as the cross-chunk merge expects); `ascending` uses the index within the
// chunk, so every chunk sorts ascending on its own.  The tile holds every
// plane, so the host shrinks the chunk as P grows (same footprint).
template <int NCMP, int P>
__global__ void chunk_sort_kernel(Planes x, int log_c, int invert,
                                  int ascending) {
  extern __shared__ int s[];
  const int c = 1 << log_c;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_c;
  load_tile<P>(s, x, base, c);
  const int64_t gbase = ascending ? 0 : base;
  for (int kk = 1; kk <= log_c; ++kk) {
    tile_substages<NCMP, P>(s, log_c, gbase, kk, kk, invert);
  }
  store_tile<P>(x, base, s, c);
}

// finish — replaces radx_tpu/kernels/bitonic.py::_finishw_kernel.
// Bound on the card: shared memory, as chunk_sort (log2(T) substages per
// level).  On the TPU the last log2(W) cross distances of a level fold into
// a W-chunk finish sized by VMEM; here every distance below the tile T runs
// in one block's shared memory and the distances >= T are cross passes, so
// a level costs one device-memory pass for its whole tail.  The direction
// comes from bit kk of each key's global index, so a tile may hold several
// merge groups of a low level.
template <int NCMP, int P>
__global__ void finish_kernel(Planes x, int log_t, int kk, int invert) {
  extern __shared__ int s[];
  const int t = 1 << log_t;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_t;
  load_tile<P>(s, x, base, t);
  tile_substages<NCMP, P>(s, log_t, base, kk, min(log_t, kk), invert);
  store_tile<P>(x, base, s, t);
}

// cross_stage<F> — replaces radx_tpu/kernels/bitonic.py::_cross_stage_kernel
// (F = 1) and _cross_stage2/3/4_kernel (F = 2, 3, 4).
// Bound on the card: device-memory bandwidth; each pass reads and writes
// every plane once and does F compare-exchanges per row.  Design: F
// consecutive distances fused per pass (F distances for the cost of one
// pass).  Thread t owns the 2^F rows i0 + u*J (u < 2^F, J = 2^j_low the
// lowest distance) of every plane in registers and runs the F substages
// (2^(F-1) J .. J) there.  Adjacent threads take adjacent i0, so every load
// and store coalesces (J >= the finish tile >= 32).  The level bit kk lies
// above the group's index bits, so one direction serves the whole group.
// F is capped by P (max_fusion) so the 2^F * P registers do not spill.
template <int F, int NCMP, int P>
__global__ void cross_stage_kernel(Planes x, int64_t groups, int j_low, int kk,
                                   int invert) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= groups) return;
  const int64_t jmask = (static_cast<int64_t>(1) << j_low) - 1;
  const int64_t stride = jmask + 1;
  const int64_t i0 = ((t & ~jmask) << F) | (t & jmask);
  const bool up = ((i0 >> kk) & 1) == invert;
  constexpr int kW = 1 << F;
  int v[P][kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j][u] = x.p[j][i0 + u * stride];
  }
#pragma unroll
  for (int sb = F - 1; sb >= 0; --sb) {
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      if (!(u & (1 << sb))) {
        const int o = u | (1 << sb);
        if constexpr (P == 1) {
          compare_exchange(v[0][u], v[0][o], up);
        } else {
          const int a1 = NCMP == 2 ? v[1][u] : 0;
          const int b1 = NCMP == 2 ? v[1][o] : 0;
          if (must_swap<NCMP>(v[0][u], a1, v[0][o], b1, up)) {
#pragma unroll
            for (int j = 0; j < P; ++j) {
              const int a = v[j][u];
              v[j][u] = v[j][o];
              v[j][o] = a;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kW; ++u) {
#pragma unroll
    for (int j = 0; j < P; ++j) x.p[j][i0 + u * stride] = v[j][u];
  }
}

template <int F, int NCMP, int P>
cudaError_t launch_cross(const Planes& x, int64_t n, int j_low, int kk,
                         int invert, cudaStream_t stream) {
  if constexpr (F > max_fusion(P)) {
    return cudaErrorInvalidValue;
  } else {
    const int64_t groups = n >> F;
    const int64_t blocks = (groups + kCrossThreads - 1) / kCrossThreads;
    cross_stage_kernel<F, NCMP, P>
        <<<static_cast<unsigned>(blocks), kCrossThreads, 0, stream>>>(
            x, groups, j_low, kk, invert);
    return cudaGetLastError();
  }
}

// One block per tile of 2^log_t rows, the tile's P planes in dynamic shared
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

template <int NCMP, int P>
cudaError_t chunk_sort(const Planes& x, int64_t n, int log_c, int invert,
                       int ascending, cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err = tile_launch_config(chunk_sort_kernel<NCMP, P>, P, log_c,
                                       &threads, &smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = n >> log_c;
  chunk_sort_kernel<NCMP, P><<<static_cast<unsigned>(blocks), threads, smem,
                               stream>>>(x, log_c, invert, ascending);
  return cudaGetLastError();
}

template <int NCMP, int P>
cudaError_t finish(const Planes& x, int64_t n, int log_t, int kk, int invert,
                   cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err = tile_launch_config(finish_kernel<NCMP, P>, P, log_t,
                                       &threads, &smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = n >> log_t;
  finish_kernel<NCMP, P><<<static_cast<unsigned>(blocks), threads, smem,
                           stream>>>(x, log_t, kk, invert);
  return cudaGetLastError();
}

template <int NCMP, int P>
cudaError_t cross(const Planes& x, int64_t n, int j_low, int f, int kk,
                  int invert, cudaStream_t stream) {
  switch (f) {
    case 1: return launch_cross<1, NCMP, P>(x, n, j_low, kk, invert, stream);
    case 2: return launch_cross<2, NCMP, P>(x, n, j_low, kk, invert, stream);
    case 3: return launch_cross<3, NCMP, P>(x, n, j_low, kk, invert, stream);
    case 4: return launch_cross<4, NCMP, P>(x, n, j_low, kk, invert, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The three launches as functors over the template instance (NCMP, P).
struct ChunkSortLaunch {
  Planes x;
  int64_t n;
  int log_c, invert, ascending;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return chunk_sort<NCMP, P>(x, n, log_c, invert, ascending, stream);
  }
};

struct FinishLaunch {
  Planes x;
  int64_t n;
  int log_t, kk, invert;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return finish<NCMP, P>(x, n, log_t, kk, invert, stream);
  }
};

struct CrossLaunch {
  Planes x;
  int64_t n;
  int j_low, f, kk, invert;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return cross<NCMP, P>(x, n, j_low, f, kk, invert, stream);
  }
};

// Run `launch` with the template instance of (ncmp, np): (1, 1), (1, 2) or
// (2, 2..8).
template <typename Launch>
cudaError_t dispatch(int ncmp, int np, const Launch& launch) {
  if (ncmp == 1) {
    switch (np) {
      case 1: return launch.template operator()<1, 1>();
      case 2: return launch.template operator()<1, 2>();
      default: return cudaErrorInvalidValue;
    }
  }
  if (ncmp != 2) return cudaErrorInvalidValue;
  switch (np) {
    case 2: return launch.template operator()<2, 2>();
    case 3: return launch.template operator()<2, 3>();
    case 4: return launch.template operator()<2, 4>();
    case 5: return launch.template operator()<2, 5>();
    case 6: return launch.template operator()<2, 6>();
    case 7: return launch.template operator()<2, 7>();
    case 8: return launch.template operator()<2, 8>();
    default: return cudaErrorInvalidValue;
  }
}

bool make_planes(void* const* ptrs, int64_t np, Planes* out) {
  if (np < 1 || np > kMaxPlanes) return false;
  for (int j = 0; j < kMaxPlanes; ++j) {
    out->p[j] = j < np ? static_cast<int*>(ptrs[j]) : nullptr;
  }
  return true;
}

}  // namespace

extern "C" {

// In every entry point `planes` points to np device pointers (plane 0 the
// keys), and ncmp is 1 (np = 1 or 2) or 2 (np = 2..8).

int radx_chunk_sort(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                    int64_t log_c, int64_t invert, int64_t ascending,
                    void* stream) {
  ChunkSortLaunch launch;
  if (!make_planes(planes, np, &launch.x)) return cudaErrorInvalidValue;
  launch.n = n;
  launch.log_c = static_cast<int>(log_c);
  launch.invert = static_cast<int>(invert);
  launch.ascending = static_cast<int>(ascending);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

int radx_finish(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                int64_t log_t, int64_t kk, int64_t invert, void* stream) {
  FinishLaunch launch;
  if (!make_planes(planes, np, &launch.x)) return cudaErrorInvalidValue;
  launch.n = n;
  launch.log_t = static_cast<int>(log_t);
  launch.kk = static_cast<int>(kk);
  launch.invert = static_cast<int>(invert);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

int radx_cross_stage(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                     int64_t j_low, int64_t f, int64_t kk, int64_t invert,
                     void* stream) {
  CrossLaunch launch;
  if (!make_planes(planes, np, &launch.x)) return cudaErrorInvalidValue;
  launch.n = n;
  launch.j_low = static_cast<int>(j_low);
  launch.f = static_cast<int>(f);
  launch.kk = static_cast<int>(kk);
  launch.invert = static_cast<int>(invert);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

const char* radx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
