// Segmented inclusive scan over sorted keys for Hopper (sm_90a): the port of
// radx_tpu/kernels/segscan.py::_segscan_kernel (:78), in one pass.
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
// the carry becomes a decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back") over run summaries:
//
//   * a block takes its tile of 2^log_tile rows from an atomic counter, so
//     every tile it waits on belongs to a block already running;
//   * the tile is staged in shared memory; each thread scans its rows
//     serially, a block scan (warp shuffles, then the warp totals) carries
//     runs across threads, giving the tile's summary A (its last key,
//     whether it is one run, the aggregate of its last run);
//   * where the row before the tile has another key than its first row, no
//     run crosses into the tile: it publishes P(t) = A(t) (not one run with
//     what precedes it) at once and needs no look-back.  Else it publishes
//     A under flag A, and warp 0 walks back from tile t - 1 to the nearest
//     tile whose summary starts the fold: one that carries its inclusive
//     prefix (flag P), or
//     whose A is not one run, or whose key is not this tile's first key
//     (there the open run starts, so its A is the prefix already).  It then
//     folds left, from that summary forward to t - 1, so the prefix is
//     always join(P(t - 2), A(t - 1)) whatever the walk saw: float32 sums
//     come out bit-identical from run to run.  (Integer ops, min / max and
//     fill are associative bit for bit, so there a window of 32 summaries
//     folds as a tree; the float32 sum folds one summary at a time.)
//   * the block publishes P(t) = join(prefix, A(t)), folds the prefix into
//     the tile's leading run while writing the tile out once.  One thread
//     publishes while the others go on, so a release stalls only its warp.
//
// A tile's status record is 16 words: the flag, then the A and the P
// summaries (key, whole, fill flags, M values).  A summary is written first
// and its flag released after it (cuda::atomic_ref, release / acquire at
// device scope); readers acquire the flag before they read the summary.
//
// Bound on the card: device-memory bandwidth.  Keys and values are read
// once and the values written once, in int4s where the planes are 16-byte
// aligned; the look-back reads records of 64 bytes a tile from L2.  Offsets
// are 64-bit.

#include <cuda/atomic>
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
constexpr int kStaticSmemBytes = 48 * 1024;
// status record of a tile: [flag, A summary, P summary], kSummary words each
constexpr int kSummary = 3 + kMaxFill;
constexpr int kRecord = 16;
constexpr uint32_t kEmpty = 0;
constexpr uint32_t kAggregate = 1;
constexpr uint32_t kPrefix = 2;

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

using FlagRef = cuda::atomic_ref<uint32_t, cuda::thread_scope_device>;

template <int OP, int DT, int M>
__device__ __forceinline__ Run<OP, DT, M> shfl_idx(const Run<OP, DT, M>& r,
                                                   int src) {
  Run<OP, DT, M> o;
  o.key = __shfl_sync(~0u, r.key, src);
  o.whole = __shfl_sync(~0u, r.whole, src);
#pragma unroll
  for (int j = 0; j < M; ++j) o.val.v[j] = __shfl_sync(~0u, r.val.v[j], src);
  o.val.h = __shfl_sync(~0u, r.val.h, src);
  return o;
}

template <int OP, int DT, int M>
__device__ __forceinline__ Run<OP, DT, M> shfl_down(const Run<OP, DT, M>& r,
                                                    int off) {
  Run<OP, DT, M> o;
  o.key = __shfl_down_sync(~0u, r.key, off);
  o.whole = __shfl_down_sync(~0u, r.whole, off);
#pragma unroll
  for (int j = 0; j < M; ++j) o.val.v[j] = __shfl_down_sync(~0u, r.val.v[j], off);
  o.val.h = __shfl_down_sync(~0u, r.val.h, off);
  return o;
}

template <int OP, int DT, int M>
__device__ __forceinline__ void store_summary(uint32_t* s,
                                              const Run<OP, DT, M>& r) {
  s[0] = static_cast<uint32_t>(r.key);
  s[1] = static_cast<uint32_t>(r.whole);
  s[2] = r.val.h;
#pragma unroll
  for (int j = 0; j < M; ++j) s[3 + j] = r.val.v[j];
}

template <int OP, int DT, int M>
__device__ __forceinline__ Run<OP, DT, M> load_summary(const uint32_t* s) {
  Run<OP, DT, M> r;
  r.key = static_cast<int>(__ldcg(s));
  r.whole = static_cast<int>(__ldcg(s + 1));
  r.val.h = __ldcg(s + 2);
#pragma unroll
  for (int j = 0; j < M; ++j) r.val.v[j] = __ldcg(s + 3 + j);
  return r;
}

// The prefix of tile t (t >= 1) for its leading run, by warp 0: the summary
// of tiles 0 .. t-1 (its key is tile t-1's last key; where that is not
// first_key, a summary of a stretch that ends at t-1, which t does not
// read).  records: tile u's status record at records + kRecord * u.
template <int OP, int DT, int M>
__device__ Run<OP, DT, M> look_back(uint32_t* records, int64_t t,
                                    int first_key) {
  using R = Run<OP, DT, M>;
  constexpr bool kTree = !(OP == kSum && DT == kF32);
  const int lane = threadIdx.x & 31;
  // phase 1: the nearest tile that starts the fold, and its flag
  int64_t base = t - 1;
  int64_t stop;
  bool stop_prefix;
  while (true) {
    const int64_t u = base - lane;
    uint32_t f = kPrefix;  // past tile 0 (tile 0 publishes P: never reached)
    bool halt = true;
    if (u >= 0) {
      uint32_t* rec = records + kRecord * u;
      f = FlagRef(*rec).load(cuda::memory_order_acquire);
      if (f == kAggregate) {
        halt = __ldcg(rec + 2) == 0 || static_cast<int>(__ldcg(rec + 1)) !=
                                            first_key;
      } else {
        halt = f == kPrefix;
      }
    }
    const unsigned valid = __ballot_sync(~0u, f != kEmpty);
    const unsigned halts = __ballot_sync(~0u, halt && f != kEmpty);
    if (halts) {
      const int h = __ffs(halts) - 1;
      const unsigned upto = h == 31 ? ~0u : (2u << h) - 1;
      if ((valid & upto) == upto) {
        stop = base - h;
        stop_prefix = __shfl_sync(~0u, f, h) == kPrefix;
        break;
      }
    } else if (valid == ~0u) {
      base -= 32;
    }
  }
  __syncwarp();  // orders the lanes' acquires before every lane's reads
  // phase 2: fold left from the stop's summary through A(stop+1 .. t-1)
  R acc = load_summary<OP, DT, M>(records + kRecord * stop + 1 +
                                  (stop_prefix ? kSummary : 0));
  for (int64_t v0 = stop + 1; v0 < t; v0 += 32) {
    const int64_t v = v0 + lane;
    const int cnt = static_cast<int>(t - v0 < 32 ? t - v0 : 32);
    R x = acc;  // lanes past t-1 hold a value nothing reads
    if (v < t) x = load_summary<OP, DT, M>(records + kRecord * v + 1);
    if constexpr (kTree) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const R y = shfl_down(x, off);
        if (lane + off < cnt && (lane & (2 * off - 1)) == 0) x = join(x, y);
      }
      acc = join(acc, shfl_idx(x, 0));
    } else {
      for (int i = 0; i < cnt; ++i) acc = join(acc, shfl_idx(x, i));
    }
  }
  return acc;
}

// scratch: the tile counter (words 0-1), then one status record a tile
// from word kRecord on, all zero at launch.  vec: every plane is 16-byte
// aligned, so a whole tile of at least 4 rows a thread moves in int4s.
template <int OP, int DT, int M>
__global__ void __launch_bounds__(kTileThreads)
    segscan_kernel(const int* __restrict__ key, Planes io, int64_t n,
                   int log_tile, bool vec, uint32_t* __restrict__ scratch) {
  using V = Val<OP, DT, M>;
  using R = Run<OP, DT, M>;
  constexpr bool kFlags = OP == kFill;
  extern __shared__ uint32_t smem[];
  __shared__ R warp_tot[32];
  __shared__ R s_tile;
  __shared__ R s_prefix;
  __shared__ int64_t s_t;
  __shared__ int s_prev_key;
  const int tile = 1 << log_tile;
  const int width = pad(tile);
  int* sk = reinterpret_cast<int*>(smem);
  uint32_t* sv = smem + width;             // M planes
  uint32_t* sh = smem + (1 + M) * width;   // flags, fill only
  uint32_t* records = scratch + kRecord;
  if (threadIdx.x == 0) {
    s_t = static_cast<int64_t>(
        atomicAdd(reinterpret_cast<unsigned long long*>(scratch), 1ull));
  }
  __syncthreads();
  const int64_t t = s_t;
  const int64_t base = t << log_tile;
  if (threadIdx.x == 0 && t > 0) s_prev_key = key[base - 1];
  const bool quad = vec && base + tile <= n && tile >= 4 * blockDim.x;
  const int quads = tile >> 2;

  if (quad) {  // int4 loads, four rounds in flight
#pragma unroll 4
    for (int c = threadIdx.x; c < quads; c += blockDim.x) {
      const int64_t g = base + 4 * c;
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(key + g));
      uint4 v4[M];
      uint32_t h[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < M; ++j) {
        v4[j] = __ldg(reinterpret_cast<const uint4*>(io.v[j] + g));
        if constexpr (kFlags) {
          const int4 f = __ldg(reinterpret_cast<const int4*>(io.h[j] + g));
          h[0] |= (f.x != 0 ? 1u : 0u) << j;
          h[1] |= (f.y != 0 ? 1u : 0u) << j;
          h[2] |= (f.z != 0 ? 1u : 0u) << j;
          h[3] |= (f.w != 0 ? 1u : 0u) << j;
        }
      }
      const int i = pad(4 * c);  // four rows in one 32-row group
      sk[i] = k4.x;
      sk[i + 1] = k4.y;
      sk[i + 2] = k4.z;
      sk[i + 3] = k4.w;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        sv[j * width + i] = v4[j].x;
        sv[j * width + i + 1] = v4[j].y;
        sv[j * width + i + 2] = v4[j].z;
        sv[j * width + i + 3] = v4[j].w;
      }
      if constexpr (kFlags) {
#pragma unroll
        for (int r = 0; r < 4; ++r) sh[i + r] = h[r];
      }
    }
  } else {
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
  if (threadIdx.x == blockDim.x - 1) s_tile = acc;
  if (has_prev) {
    for (int j = 0; j < items && sk[pad(i0 + j)] == prev.key; ++j) {
      V x = load(i0 + j);
      x.absorb(prev.val);
      store(i0 + j, x);
    }
  }
  __syncthreads();

  // The status is published by one thread while the others go on (a
  // release stalls only its own warp).  Where the row before the tile has
  // another key, no run crosses into the tile: P(t) is A(t), not one run
  // with what precedes it, and there is no look-back.
  uint32_t* rec = records + kRecord * t;
  const bool carry = t > 0 && s_prev_key == sk[pad(0)];
  if (!carry) {
    if (threadIdx.x == 0) {
      R p = s_tile;
      if (t > 0) p.whole = 0;
      store_summary(rec + 1 + kSummary, p);
      FlagRef(*rec).store(kPrefix, cuda::memory_order_release);
    }
  } else {
    if (threadIdx.x == 32) {
      store_summary(rec + 1, s_tile);
      FlagRef(*rec).store(kAggregate, cuda::memory_order_release);
    }
    if (threadIdx.x < 32) {
      const R prefix = look_back<OP, DT, M>(records, t, sk[pad(0)]);
      if (threadIdx.x == 0) s_prefix = prefix;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      store_summary(rec + 1 + kSummary, join(s_prefix, s_tile));
      FlagRef(*rec).store(kPrefix, cuda::memory_order_release);
    }
  }

  // write the tile out, the prefix folded into its leading run
  auto carried = [&](int i) {
    V x = load(i);
    if (carry && sk[pad(i)] == s_prefix.key) x.absorb(s_prefix.val);
    return x;
  };
  if (quad) {
    for (int c = threadIdx.x; c < quads; c += blockDim.x) {
      const int64_t g = base + 4 * c;
      V x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = carried(4 * c + r);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        *reinterpret_cast<uint4*>(io.vo[j] + g) =
            make_uint4(x[0].v[j], x[1].v[j], x[2].v[j], x[3].v[j]);
        if constexpr (kFlags) {
          *reinterpret_cast<int4*>(io.ho[j] + g) = make_int4(
              (x[0].h >> j) & 1, (x[1].h >> j) & 1, (x[2].h >> j) & 1,
              (x[3].h >> j) & 1);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int64_t g = base + i;
      if (g >= n) break;
      const V x = carried(i);
#pragma unroll
      for (int j = 0; j < M; ++j) io.vo[j][g] = x.v[j];
      if constexpr (kFlags) {
#pragma unroll
        for (int j = 0; j < M; ++j) io.ho[j][g] = (x.h >> j) & 1;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int OP, int DT, int M>
cudaError_t run(const int* key, const Planes& io, int64_t n, int log_tile,
                uint32_t* scratch, cudaStream_t stream) {
  bool vec = aligned16(key);
  for (int j = 0; j < M; ++j) {
    vec = vec && aligned16(io.v[j]) && aligned16(io.vo[j]);
    if (OP == kFill) vec = vec && aligned16(io.h[j]) && aligned16(io.ho[j]);
  }
  const int tile = 1 << log_tile;
  const int threads = tile < kTileThreads ? tile : kTileThreads;
  const int planes = 1 + M + (OP == kFill ? 1 : 0);
  const size_t smem = sizeof(uint32_t) * planes * (tile + (tile >> 5));
  auto kernel = segscan_kernel<OP, DT, M>;
  if (smem > kStaticSmemBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles = ((n - 1) >> log_tile) + 1;
  kernel<<<static_cast<unsigned>(tiles), threads, smem, stream>>>(
      key, io, n, log_tile, vec, scratch);
  return cudaGetLastError();
}

template <int OP>
cudaError_t run_typed(int dtype, const int* key, const Planes& io, int64_t n,
                      int log_tile, uint32_t* scratch, cudaStream_t stream) {
  switch (dtype) {
    case kU32: return run<OP, kU32, 1>(key, io, n, log_tile, scratch, stream);
    case kI32: return run<OP, kI32, 1>(key, io, n, log_tile, scratch, stream);
    case kF32: return run<OP, kF32, 1>(key, io, n, log_tile, scratch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The scan of op (0 sum, 1 min, 2 max, 3 fill) over values of dtype (0
// uint32, 1 int32, 2 float32; ignored by fill) with m value planes (1, or
// 1..4 for fill), in one launch.  vals / flags / outs / out_flags: host
// arrays of m device pointers (flags only for fill).  scratch: kRecord *
// (tiles + 1) zeroed 32-bit words.
int radx_segscan(void* key, int64_t n, int64_t log_tile, void** vals,
                 void** flags, void** outs, void** out_flags, void* scratch,
                 int64_t op, int64_t dtype, int64_t m, void* stream) {
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
  const int lt = static_cast<int>(log_tile);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      // uint32 and int32 sums are the same mod-2^32 add
      return dtype == kF32 ? run<kSum, kF32, 1>(k, io, n, lt, sc, s)
                           : run<kSum, kU32, 1>(k, io, n, lt, sc, s);
    case kMin: return run_typed<kMin>(static_cast<int>(dtype), k, io, n, lt, sc, s);
    case kMax: return run_typed<kMax>(static_cast<int>(dtype), k, io, n, lt, sc, s);
    case kFill:
      switch (m) {
        case 1: return run<kFill, kU32, 1>(k, io, n, lt, sc, s);
        case 2: return run<kFill, kU32, 2>(k, io, n, lt, sc, s);
        case 3: return run<kFill, kU32, 3>(k, io, n, lt, sc, s);
        case 4: return run<kFill, kU32, 4>(k, io, n, lt, sc, s);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
