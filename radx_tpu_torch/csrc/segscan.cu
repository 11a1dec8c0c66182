// Segmented inclusive scan over sorted keys for Hopper (sm_90a): the port of
// radx_tpu/kernels/segscan.py::_segscan_kernel (:78).
//
// Input: n int32 keys in which equal keys are contiguous (sorted), and the
// values as raw 32-bit planes.  Output: each value combined, inclusive, with
// every earlier value of its equal-key run, so the last row of a run holds
// the run's aggregate.  Ops:
//
//   sum        uint32 / int32 add mod 2^32 (in uint32_t: no signed overflow),
//              float32 add;
//   min / max  unsigned compare for uint32, signed for int32; for float32 an
//              explicit compare that propagates NaN (as jnp.minimum /
//              jnp.maximum do) and takes -0.0 for min and +0.0 for max when
//              the two compare equal (the bitwise or / and of the patterns),
//              so the result does not depend on the order of the scan;
//   fill       M (value, flag) plane pairs, M <= kMaxFill: a flagged row
//              keeps its value, an unflagged row takes the value of the last
//              flagged row before it in its run, and its flag becomes 1 if
//              there was one.  Where the flag stays 0 the value is the row's
//              own (the reference leaves a run head's value there).
//
// The TPU runs the chunks in order over its grid and carries the open run
// from one chunk to the next in SMEM.  Blocks on a GPU run in no order, so
// the port is reduce-then-scan in three kernels:
//
//   segscan_tile   — one block per tile of 2^log_tile rows: the tile is
//                    staged in shared memory, each thread scans its rows
//                    serially, a block scan (warp shuffles, then the warp
//                    totals) carries runs across threads, and the tile is
//                    written back.  Thread last also writes the tile's tail:
//                    its last key, the aggregate of its last run, and whether
//                    the whole tile is one run;
//   segscan_carry  — one block scans the tiles' tails in rounds of 1024, so
//                    tail t becomes the aggregate of the run that is open at
//                    the end of tile t, across all tiles before it;
//   segscan_apply  — one block per tile t >= 1 combines carry t-1 into the
//                    rows of tile t whose key equals its key: with sorted
//                    keys that is a prefix of the tile, so the block stops at
//                    the first round of rows that is not all in the run.
//
// Bound on the card: device-memory bandwidth.  segscan_tile reads and writes
// each plane once; segscan_apply reads one round of keys per tile (all of
// the tile only where a run covers it); segscan_carry touches one row per
// tile.  Every element a run element combines with is in registers or
// shared memory; offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSum = 0;
constexpr int kMin = 1;
constexpr int kMax = 2;
constexpr int kFill = 3;
constexpr int kU32 = 0;
constexpr int kI32 = 1;
constexpr int kF32 = 2;
constexpr int kMaxFill = 4;
constexpr int kTileThreads = 256;
constexpr int kCarryThreads = 1024;
constexpr int kStaticSmemBytes = 48 * 1024;

struct Planes {
  const uint32_t* v[kMaxFill];
  const int* h[kMaxFill];
  uint32_t* vo[kMaxFill];
  int* ho[kMaxFill];
};

template <int OP, int DT>
__device__ __forceinline__ uint32_t combine_scalar(uint32_t p, uint32_t c) {
  if constexpr (OP == kSum) {
    if constexpr (DT == kF32) {
      return __float_as_uint(__uint_as_float(p) + __uint_as_float(c));
    } else {
      return p + c;
    }
  } else {
    constexpr bool is_min = OP == kMin;
    if constexpr (DT == kU32) {
      return (is_min ? c < p : c > p) ? c : p;
    } else if constexpr (DT == kI32) {
      const int a = static_cast<int>(p);
      const int b = static_cast<int>(c);
      return static_cast<uint32_t>(is_min ? min(a, b) : max(a, b));
    } else {
      const float a = __uint_as_float(p);
      const float b = __uint_as_float(c);
      if (a != a) return p;
      if (b != b) return c;
      if (a < b) return is_min ? p : c;
      if (b < a) return is_min ? c : p;
      return is_min ? (p | c) : (p & c);
    }
  }
}

// The value part of a scan element: M values and, for fill, M flags as the
// bits of h.
template <int OP, int DT, int M>
struct Val {
  uint32_t v[M];
  uint32_t h;

  // this = prev (earlier) combined with this (later)
  __device__ __forceinline__ void absorb(const Val& prev) {
    if constexpr (OP == kFill) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (!((h >> j) & 1) && ((prev.h >> j) & 1)) v[j] = prev.v[j];
      }
      h |= prev.h;
    } else {
      v[0] = combine_scalar<OP, DT>(prev.v[0], v[0]);
    }
  }
};

// A run summary of a stretch of rows: its last key, the aggregate of its
// last run, and whether the stretch is one run.
template <int OP, int DT, int M>
struct Run {
  int key;
  int whole;
  Val<OP, DT, M> val;
};

// The summary of stretch a followed by stretch b.  b's last run reaches into
// a iff b is one run whose key is a's last key.
template <int OP, int DT, int M>
__device__ __forceinline__ Run<OP, DT, M> join(const Run<OP, DT, M>& a,
                                               Run<OP, DT, M> b) {
  if (b.whole && a.key == b.key) {
    b.val.absorb(a.val);
    b.whole = a.whole;
  } else {
    b.whole = 0;
  }
  return b;
}

template <int OP, int DT, int M>
__device__ __forceinline__ Run<OP, DT, M> shfl_up(const Run<OP, DT, M>& r,
                                                  int off) {
  Run<OP, DT, M> o;
  o.key = __shfl_up_sync(~0u, r.key, off);
  o.whole = __shfl_up_sync(~0u, r.whole, off);
#pragma unroll
  for (int j = 0; j < M; ++j) o.val.v[j] = __shfl_up_sync(~0u, r.val.v[j], off);
  o.val.h = __shfl_up_sync(~0u, r.val.h, off);
  return o;
}

// Block-wide inclusive scan of one summary per thread (blockDim.x a
// multiple of 32).  Also returns the inclusive summary of the thread before
// (prev, valid iff has_prev).  warp_tot: shared memory for 32 summaries.
template <int OP, int DT, int M>
__device__ void block_scan(Run<OP, DT, M>& x, Run<OP, DT, M>& prev,
                           bool& has_prev, Run<OP, DT, M>* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Run<OP, DT, M> o = shfl_up(x, off);
    if (lane >= off) x = join(o, x);
  }
  const Run<OP, DT, M> up1 = shfl_up(x, 1);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  Run<OP, DT, M> wp;
  if (warp > 0) {
    wp = warp_tot[0];
    for (int w = 1; w < warp; ++w) wp = join(wp, warp_tot[w]);
  }
  if (lane > 0) {
    prev = warp > 0 ? join(wp, up1) : up1;
    has_prev = true;
  } else {
    prev = wp;
    has_prev = warp > 0;
  }
  if (warp > 0) x = join(wp, x);
  __syncthreads();  // warp_tot is reused by the caller's next scan
}

// Shared-memory index with one pad word per 32, so that threads reading
// their own consecutive rows (stride = rows per thread) hit distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Tile tails / carries: struct of arrays over the tiles.
struct Tails {
  int* key;
  int* whole;
  uint32_t* h;
  uint32_t* v;  // v[j * tiles + t]
  int64_t tiles;
};

Tails tails_of(void* scratch, int64_t tiles) {
  int* p = static_cast<int*>(scratch);
  return Tails{p, p + tiles, reinterpret_cast<uint32_t*>(p + 2 * tiles),
               reinterpret_cast<uint32_t*>(p + 3 * tiles), tiles};
}

template <int OP, int DT, int M>
__device__ __forceinline__ Val<OP, DT, M> load_tail(const Tails& t, int64_t i) {
  Val<OP, DT, M> x;
#pragma unroll
  for (int j = 0; j < M; ++j) x.v[j] = t.v[j * t.tiles + i];
  x.h = t.h[i];
  return x;
}

template <int OP, int DT, int M>
__device__ __forceinline__ void store_tail(const Tails& t, int64_t i,
                                           const Run<OP, DT, M>& r) {
  t.key[i] = r.key;
  t.whole[i] = r.whole;
#pragma unroll
  for (int j = 0; j < M; ++j) t.v[j * t.tiles + i] = r.val.v[j];
  t.h[i] = r.val.h;
}

template <int OP, int DT, int M>
__global__ void segscan_tile_kernel(const int* __restrict__ key, Planes io,
                                    int64_t n, int log_tile, Tails tails) {
  using V = Val<OP, DT, M>;
  using R = Run<OP, DT, M>;
  constexpr bool kFlags = OP == kFill;
  extern __shared__ uint32_t smem[];
  __shared__ R warp_tot[32];
  const int tile = 1 << log_tile;
  const int width = pad(tile);
  int* sk = reinterpret_cast<int*>(smem);
  uint32_t* sv = smem + width;             // M planes
  uint32_t* sh = smem + (1 + M) * width;   // flags, fill only
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_tile;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t g = base + i;
    const bool in = g < n;
    sk[pad(i)] = in ? key[g] : -1;
#pragma unroll
    for (int j = 0; j < M; ++j) sv[j * width + pad(i)] = in ? io.v[j][g] : 0u;
    if constexpr (kFlags) {
      uint32_t h = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) h |= (in && io.h[j][g] != 0 ? 1u : 0u) << j;
      sh[pad(i)] = h;
    }
  }
  __syncthreads();

  auto load = [&](int i) {
    V x;
#pragma unroll
    for (int j = 0; j < M; ++j) x.v[j] = sv[j * width + pad(i)];
    x.h = kFlags ? sh[pad(i)] : 0u;
    return x;
  };
  auto store = [&](int i, const V& x) {
#pragma unroll
    for (int j = 0; j < M; ++j) sv[j * width + pad(i)] = x.v[j];
    if constexpr (kFlags) sh[pad(i)] = x.h;
  };

  // each thread scans its own consecutive rows
  const int items = tile / blockDim.x;
  const int i0 = threadIdx.x * items;
  R acc;
  acc.key = sk[pad(i0)];
  acc.whole = 1;
  acc.val = load(i0);
  for (int j = 1; j < items; ++j) {
    const int k = sk[pad(i0 + j)];
    V x = load(i0 + j);
    if (k == acc.key) {
      x.absorb(acc.val);
      store(i0 + j, x);
    } else {
      acc.whole = 0;
    }
    acc.key = k;
    acc.val = x;
  }

  // carry across threads: combine the run open before this thread into its
  // leading rows of the same key
  R prev;
  bool has_prev = false;
  block_scan(acc, prev, has_prev, warp_tot);
  if (has_prev) {
    for (int j = 0; j < items && sk[pad(i0 + j)] == prev.key; ++j) {
      V x = load(i0 + j);
      x.absorb(prev.val);
      store(i0 + j, x);
    }
  }
  if (threadIdx.x == blockDim.x - 1) store_tail(tails, blockIdx.x, acc);
  __syncthreads();

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t g = base + i;
    if (g >= n) break;
#pragma unroll
    for (int j = 0; j < M; ++j) io.vo[j][g] = sv[j * width + pad(i)];
    if constexpr (kFlags) {
      const uint32_t h = sh[pad(i)];
#pragma unroll
      for (int j = 0; j < M; ++j) io.ho[j][g] = (h >> j) & 1;
    }
  }
}

// One block: tails[t] <- the summary of tiles 0..t (its value is the
// aggregate of the run open at the end of tile t).
template <int OP, int DT, int M>
__global__ void segscan_carry_kernel(Tails tails) {
  using R = Run<OP, DT, M>;
  __shared__ R warp_tot[32];
  __shared__ R carry;
  for (int64_t r0 = 0; r0 < tails.tiles; r0 += blockDim.x) {
    const int64_t t = r0 + threadIdx.x;
    R x;
    if (t < tails.tiles) {
      x.key = tails.key[t];
      x.whole = tails.whole[t];
      x.val = load_tail<OP, DT, M>(tails, t);
    } else {  // past the end: a summary that nothing before it reads
      x.key = 0;
      x.whole = 0;
      x.val = Val<OP, DT, M>{};
    }
    R prev;
    bool has_prev;
    block_scan(x, prev, has_prev, warp_tot);
    if (r0 > 0) x = join(carry, x);
    __syncthreads();  // every thread has read carry
    if (t < tails.tiles) store_tail(tails, t, x);
    if (threadIdx.x == blockDim.x - 1) carry = x;
    __syncthreads();
  }
}

// One block per tile t >= 1: combine carry t-1 into the tile's leading rows
// of the carry's key.
template <int OP, int DT, int M>
__global__ void segscan_apply_kernel(const int* __restrict__ key, Planes io,
                                     int64_t n, int log_tile, Tails tails) {
  using V = Val<OP, DT, M>;
  const int64_t tile = blockIdx.x + 1;
  const int64_t base = tile << log_tile;
  const int64_t end_tile = base + (static_cast<int64_t>(1) << log_tile);
  const int64_t end = end_tile < n ? end_tile : n;
  const int ckey = tails.key[tile - 1];
  const V cval = load_tail<OP, DT, M>(tails, tile - 1);
  for (int64_t r0 = base; r0 < end; r0 += blockDim.x) {
    const int64_t i = r0 + threadIdx.x;
    const bool in_run = i < end && key[i] == ckey;
    if (in_run) {
      V x;
#pragma unroll
      for (int j = 0; j < M; ++j) x.v[j] = io.vo[j][i];
      x.h = 0;
      if constexpr (OP == kFill) {
#pragma unroll
        for (int j = 0; j < M; ++j) x.h |= (io.ho[j][i] != 0 ? 1u : 0u) << j;
      }
      x.absorb(cval);
#pragma unroll
      for (int j = 0; j < M; ++j) io.vo[j][i] = x.v[j];
      if constexpr (OP == kFill) {
#pragma unroll
        for (int j = 0; j < M; ++j) io.ho[j][i] = (x.h >> j) & 1;
      }
    }
    if (!__syncthreads_and(in_run)) break;
  }
}

int64_t num_tiles(int64_t n, int log_tile) { return ((n - 1) >> log_tile) + 1; }

template <int OP, int DT, int M>
cudaError_t run_tile(const int* key, const Planes& io, int64_t n, int log_tile,
                     void* scratch, cudaStream_t stream) {
  const int tile = 1 << log_tile;
  const int threads = tile < kTileThreads ? tile : kTileThreads;
  const int planes = 1 + M + (OP == kFill ? 1 : 0);
  const size_t smem = sizeof(uint32_t) * planes * (tile + (tile >> 5));
  auto kernel = segscan_tile_kernel<OP, DT, M>;
  if (smem > kStaticSmemBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles = num_tiles(n, log_tile);
  kernel<<<static_cast<unsigned>(tiles), threads, smem, stream>>>(
      key, io, n, log_tile, tails_of(scratch, tiles));
  return cudaGetLastError();
}

template <int OP, int DT, int M>
cudaError_t run_carry(int64_t n, int log_tile, void* scratch,
                      cudaStream_t stream) {
  segscan_carry_kernel<OP, DT, M><<<1, kCarryThreads, 0, stream>>>(
      tails_of(scratch, num_tiles(n, log_tile)));
  return cudaGetLastError();
}

template <int OP, int DT, int M>
cudaError_t run_apply(const int* key, const Planes& io, int64_t n,
                      int log_tile, void* scratch, cudaStream_t stream) {
  const int tile = 1 << log_tile;
  const int threads = tile < kTileThreads ? tile : kTileThreads;
  const int64_t tiles = num_tiles(n, log_tile);
  segscan_apply_kernel<OP, DT, M>
      <<<static_cast<unsigned>(tiles - 1), threads, 0, stream>>>(
          key, io, n, log_tile, tails_of(scratch, tiles));
  return cudaGetLastError();
}

// phase 0: tile, 1: carry, 2: apply
template <int OP, int DT, int M>
cudaError_t run(int phase, const int* key, const Planes& io, int64_t n,
                int log_tile, void* scratch, cudaStream_t stream) {
  switch (phase) {
    case 0: return run_tile<OP, DT, M>(key, io, n, log_tile, scratch, stream);
    case 1: return run_carry<OP, DT, M>(n, log_tile, scratch, stream);
    case 2: return run_apply<OP, DT, M>(key, io, n, log_tile, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int OP>
cudaError_t run_typed(int phase, int dtype, const int* key, const Planes& io,
                      int64_t n, int log_tile, void* scratch,
                      cudaStream_t stream) {
  switch (dtype) {
    case kU32: return run<OP, kU32, 1>(phase, key, io, n, log_tile, scratch, stream);
    case kI32: return run<OP, kI32, 1>(phase, key, io, n, log_tile, scratch, stream);
    case kF32: return run<OP, kF32, 1>(phase, key, io, n, log_tile, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One phase of the scan (0: segscan_tile, 1: segscan_carry, 2:
// segscan_apply) of op (0 sum, 1 min, 2 max, 3 fill) over values of dtype
// (0 uint32, 1 int32, 2 float32; ignored by fill) with m value planes (1,
// or 1..4 for fill).  vals / flags / outs / out_flags: host arrays of m
// device pointers (flags only for fill).  scratch: int32 device memory of
// (3 + m) * tiles words, shared by the three phases.
int radx_segscan(int64_t phase, void* key, int64_t n, int64_t log_tile,
                 void** vals, void** flags, void** outs, void** out_flags,
                 void* scratch, int64_t op, int64_t dtype, int64_t m,
                 void* stream) {
  const bool fill = op == kFill;
  if (n < 1 || m < 1 || m > (fill ? kMaxFill : 1)) return cudaErrorInvalidValue;
  Planes io = {};
  for (int j = 0; j < m; ++j) {
    io.v[j] = static_cast<const uint32_t*>(vals[j]);
    io.vo[j] = static_cast<uint32_t*>(outs[j]);
    if (fill) {
      io.h[j] = static_cast<const int*>(flags[j]);
      io.ho[j] = static_cast<int*>(out_flags[j]);
    }
  }
  const int* k = static_cast<const int*>(key);
  const int p = static_cast<int>(phase);
  const int lt = static_cast<int>(log_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      // uint32 and int32 sums are the same mod-2^32 add
      return dtype == kF32 ? run<kSum, kF32, 1>(p, k, io, n, lt, scratch, s)
                           : run<kSum, kU32, 1>(p, k, io, n, lt, scratch, s);
    case kMin: return run_typed<kMin>(p, static_cast<int>(dtype), k, io, n, lt, scratch, s);
    case kMax: return run_typed<kMax>(p, static_cast<int>(dtype), k, io, n, lt, scratch, s);
    case kFill:
      switch (m) {
        case 1: return run<kFill, kU32, 1>(p, k, io, n, lt, scratch, s);
        case 2: return run<kFill, kU32, 2>(p, k, io, n, lt, scratch, s);
        case 3: return run<kFill, kU32, 3>(p, k, io, n, lt, scratch, s);
        case 4: return run<kFill, kU32, 4>(p, k, io, n, lt, scratch, s);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
