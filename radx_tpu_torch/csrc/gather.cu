// Gather of int32 value planes by an int32 index plane for Hopper (sm_90a).
//
// No Pallas kernel has this job.  On the TPU a gather is slow, so the JAX
// package pushes every value plane through the sort network beside the
// compare planes (radx_tpu/ops/join.py:70, the join's tagged union over
// (key, tie, build value, probe value); radx_tpu/ops/sort.py:136, the
// stable sorts over (key, index, payloads...)).  On the card the network's
// cost grows with its plane count (a lex4 sort takes 2.3x a lex2 sort of
// the same rows), so the port sorts only the two compare planes and these
// kernels then fetch the value planes by the tie or index plane, which is
// unique for every real row.
//
// Two modes over an index plane `idx` of n rows:
//   * index:  out_g[i] = src_g[idx[i]] for G = 1..4 source planes (the
//             stable sorts' payloads by their original index);
//   * tagged: two outputs from the join's tie plane: a tie t < 2^30 is
//             build row t (bval = build[t], pval = 0), 2^30 <= t <
//             0x7FFFFFFF is probe row t - 2^30 (bval = 0, pval =
//             probe[t - 2^30]), and the pad tie 0x7FFFFFFF gives 0 and 0:
//             the values a four-plane sort leaves in those rows.
// An index outside its source's rows reads nothing and gives 0 (so a pad
// never reads a source).
//
// Bound on the card: device-memory bandwidth, and in practice the random
// reads.  Each row reads 4 bytes of index and writes 4 bytes a plane, both
// coalesced, and reads 4 bytes a plane at a random place, which costs the
// DRAM one 32-byte sector when the source is larger than the 50 MB L2.
// Two routes, chosen by the wrapper (kernels/gather.py) by the sources'
// size alone:
//
// Direct (gather_planes_kernel, sources within one window): many random
// reads in flight, in the order of the output.
//   * a block takes a tile of kTile = 4096 rows; in round v thread t loads
//     the 16-byte index vector v * kThreads + t of the tile (coalesced), so
//     a thread holds kVecs x 4 = 16 indices;
//   * it issues all 16 x G random reads (read-only path, no dependence
//     between them) before the first store, then writes each plane's rows
//     as 16-byte vectors at the positions of their indices (coalesced);
//   * the ragged last tile, or planes not 16-byte aligned, take a scalar
//     loop (one row a thread per step).
// Where the sources fit in L2 these reads hit it.  Above that they do not:
// in the order of the output the reads land anywhere in the source, and
// each one costs a DRAM sector (9.4 ms for 2^28 rows from 1 GiB, the rate
// of index_select).
//
// Partitioned (sources above one window): the reads are reordered so that
// they reach the memory one window of W bytes of source at a time, a window
// that L2 holds, so each source sector leaves DRAM about once and every
// other pass is sequential.  A row's bucket d is the window its index names
// (index mode: t >> log2(W / 4) for 0 <= t < rows; tagged: the build
// windows, then the probe windows), or the null bucket nb for an index
// outside the sources and the pad tie.  Tiles of T rows:
//   count   per tile, the rows of each bucket (warp-private shared counters)
//           into a bucket-major table of counts (64-bit);
//   scan    one block a bucket: its row of counts gives its exclusive
//           prefix over the tiles c[d][.] and the bucket's total.  A tile's
//           rows of bucket d then start at base[d] + c[d][tile] in P, base
//           being the exclusive prefix of the totals, which part and place
//           take in shared memory (a block scan of nb + 1 numbers).  A count
//           launch and a scan rather than one pass with a look-back per
//           bucket: the table is a few MB, the scan takes microseconds, and
//           no block ever waits on another;
//   part    per tile: the tile's index rows go to P[base[d] + c[d][tile] +
//           rank], rank being the row's place among the tile's rows of its
//           bucket, in row order (a stable partition);
//   window  V[k] = src[P[k]] in P's order (the direct kernel on P): blocks
//           run roughly in order, so the reads in flight cover one or two
//           windows and hit L2.  Tagged: one value, from the side the tie
//           names.  V may be P itself;
//   place   the twin of part: the tile recomputes every row's (d, rank),
//           reads V[base[d] + c[d][tile] + rank] (one contiguous run a
//           bucket) and writes out[i] coalesced; tagged writes (got, 0) or
//           (0, got) by the tie.
// part and place rank a tile in shared memory: the tile's rows are staged
// there (16-byte loads), warp w owns rows w * T / 8 .. (w + 1) * T / 8 - 1.
// Each warp first counts its rows by bucket (shared atomics into its own
// counters); the counters, scanned across warps and buckets, give each
// warp its start in each bucket; then the warp walks its rows again, 32 a
// step, in order: the lanes of one bucket in a step find each other by an
// atomic OR of their lane bits into the warp's word for that bucket (one
// shared atomic a row, whatever the number of buckets; one ballot a bit
// of the bucket number made part and place over twice as slow on an H100,
// bound by their instructions), a row's slot is the warp's start plus the
// lanes of its bucket below it, and the lowest of them advances the
// start.  The slots, in the tile's bucket order, are written out (part)
// or read back (place) as contiguous runs.
// One source: 36 bytes a row in sequential passes (count 4, part 8,
// window 12, place 12), where the direct route pays a DRAM sector a row.
// The window's random reads then hit L2 but are bound by L2's rate of
// sector reads, which leaves it the longest step (PERF.md; python -m
// radx_tpu_torch.bench sweep_gather times the route at each window and
// tile).  Offsets into P are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte index vectors a thread
constexpr int kTile = kThreads * kVecs * 4;
constexpr int kMaxPlanes = 4;
constexpr int kProbeTie = 1 << 30;
constexpr int kPadTie = 0x7FFFFFFF;

// What the direct kernel writes for a row: G values (index), the build and
// probe values (tagged), or the one value the tie names (side: the
// partitioned route's tagged window)
enum Mode { kIndex = 0, kTagged = 1, kSide = 2 };

struct Args {
  const int* idx;
  const int* src[kMaxPlanes];
  int64_t rows[kMaxPlanes];
  int* out[kMaxPlanes];
  int64_t n;
  bool vec;  // idx and every output 16-byte aligned
};

// src[i], or 0 where i lies outside [0, rows)
__device__ __forceinline__ int take(const int* __restrict__ src, int64_t rows,
                                    int i) {
  return (i >= 0 && i < rows) ? __ldg(src + i) : 0;
}

// The output rows of index t: G values in index mode, (build, probe) in
// tagged mode, the side's value in side mode (one read: the side that the
// tie names).
template <int G, int kMode>
__device__ __forceinline__ void row(const Args& a, int t, int (&v)[G]) {
  if constexpr (kMode != kIndex) {
    const bool probe = t >= kProbeTie;
    const int got = t == kPadTie ? 0
                    : probe      ? take(a.src[1], a.rows[1], t - kProbeTie)
                                 : take(a.src[0], a.rows[0], t);
    if constexpr (kMode == kSide) {
      v[0] = got;
    } else {
      v[0] = probe ? 0 : got;
      v[1] = probe ? got : 0;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = take(a.src[g], a.rows[g], t);
  }
}

template <int G, int kMode>
__global__ void __launch_bounds__(kThreads)
    gather_planes_kernel(const Args a) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  if (a.vec && base + kTile <= a.n) {
    const int4* idx4 = reinterpret_cast<const int4*>(a.idx + base);
    int t[kVecs][4];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int4 x = __ldg(idx4 + v * kThreads + threadIdx.x);
      t[v][0] = x.x;
      t[v][1] = x.y;
      t[v][2] = x.z;
      t[v][3] = x.w;
    }
    int val[kVecs][4][G];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
#pragma unroll
      for (int q = 0; q < 4; ++q) row<G, kMode>(a, t[v][q], val[v][q]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int4* out4 = reinterpret_cast<int4*>(a.out[g] + base);
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        out4[v * kThreads + threadIdx.x] =
            make_int4(val[v][0][g], val[v][1][g], val[v][2][g], val[v][3][g]);
      }
    }
    return;
  }
  const int64_t end = base + kTile < a.n ? base + kTile : a.n;
  for (int64_t r = base + threadIdx.x; r < end; r += kThreads) {
    int v[G];
    row<G, kMode>(a, __ldg(a.idx + r), v);
#pragma unroll
    for (int g = 0; g < G; ++g) a.out[g][r] = v[g];
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int G, int kMode>
int run(const Args& a, cudaStream_t s) {
  const int64_t blocks = (a.n + kTile - 1) / kTile;
  gather_planes_kernel<G, kMode>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- the partitioned route ---------------------------------------------------

constexpr int kPartThreads = 256;
constexpr int kWarps = kPartThreads / 32;
constexpr int kMaxWindows = 1024;  // buckets besides the null one
constexpr int kPlaceBatch = 8;     // V reads in flight a place thread
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;      // counts a scan thread takes a round

// The route's geometry (kernels/gather.py::Geometry computes the same).
struct Part {
  const int* idx;
  int64_t n;
  int64_t rows0, rows1;  // index: the largest source's rows; tagged: build,
                         // probe rows
  int log_w;             // log2 of a window's rows
  int log_tile;          // log2 of a tile's rows
  int nbw;               // windows of rows0 (the probe windows follow)
  int nb;                // windows in all: the null bucket's number
  int64_t tiles;
  bool vec;              // idx 16-byte aligned
  int64_t* offsets;      // (nb + 1) x tiles: counts (count), prefixes
  const int64_t* totals;  // nb + 1 rows a bucket
};

template <bool kTag>
__device__ __forceinline__ int bucket(const Part& a, int t) {
  if (t >= 0 && t < a.rows0 && (!kTag || t < kProbeTie)) return t >> a.log_w;
  if constexpr (kTag) {
    if (t >= kProbeTie && t != kPadTie && t - kProbeTie < a.rows1) {
      return a.nbw + ((t - kProbeTie) >> a.log_w);
    }
  }
  return a.nb;
}

// Exclusive prefix sums of x[0 .. m) in shared memory, in place, by the
// whole block (a thread takes a contiguous run); returns the total.
template <typename V>
__device__ __forceinline__ V block_scan(V* x, int m) {
  __shared__ V warp_sum[kWarps];
  __syncthreads();
  const int per = (m + kPartThreads - 1) / kPartThreads;
  const int lo = static_cast<int>(threadIdx.x) * per < m
                     ? static_cast<int>(threadIdx.x) * per : m;
  const int hi = lo + per < m ? lo + per : m;
  V sum = 0;
  for (int i = lo; i < hi; ++i) sum += x[i];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  V incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  V run = incl - sum, total = 0;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    run += j < w ? warp_sum[j] : 0;
    total += warp_sum[j];
  }
  for (int i = lo; i < hi; ++i) {
    const V t = x[i];
    x[i] = run;
    run += t;
  }
  __syncthreads();
  return total;
}

// Shared memory of part / place: the staged index rows and the slots
// (16-byte aligned: the rows take 16-byte stores), the tile's P offsets a
// bucket, the warps' counters and match words, a scratch row of bucket
// starts.  (One 64-bit word a warp and bucket for the counter and the
// lanes took twice the time: 64-bit shared atomics are not native.)
struct Smem {
  int* rows;         // the tile's index rows (place: then their values)
  int* slot;         // the rows in bucket order: part their index values,
                     // place d << 16 | row
  int64_t* adj;      // slot i of bucket d goes to P[adj[d] + i]
  int* cnt;          // kWarps x (nb + 1): the warp's rows, then its next
                     // slot, of each bucket
  unsigned* match;   // kWarps x (nb + 1): a step's lanes of each bucket
  int* loc;          // where bucket d starts among the tile's slots
};

size_t smem_bytes(int nbk, int tile) {
  return (sizeof(int64_t) + sizeof(int) * (2 * kWarps + 1)) * nbk +
         2 * sizeof(int) * static_cast<size_t>(tile);
}

__device__ __forceinline__ Smem carve(int nbk, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  s.rows = reinterpret_cast<int*>(smem_raw);
  s.slot = s.rows + tile;
  s.adj = reinterpret_cast<int64_t*>(s.slot + tile);
  s.cnt = reinterpret_cast<int*>(s.adj + nbk);
  s.match = reinterpret_cast<unsigned*>(s.cnt + kWarps * nbk);
  s.loc = reinterpret_cast<int*>(s.match + kWarps * nbk);
  return s;
}

// Stage the tile's index rows in shared memory and give every row its slot
// in the tile's bucket order (slot[at] = the row's index value, or d << 16 |
// row with kPlace); returns the tile's rows.  On return s.adj holds the
// tile's P offsets.  Warp w loads and ranks rows w * T / 8 ..
// (w + 1) * T / 8 - 1, 16-byte vectors where the tile is whole and aligned.
template <bool kTag, bool kPlace>
__device__ __forceinline__ int layout(const Part& a, const Smem s,
                                      int64_t base) {
  const int nbk = a.nb + 1;
  const int tile = 1 << a.log_tile;
  const int valid = static_cast<int>(a.n - base < tile ? a.n - base : tile);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per_warp = tile / kWarps, lo = w * per_warp;
  const unsigned below = (1u << lane) - 1;
  for (int i = threadIdx.x; i < kWarps * nbk; i += kPartThreads) {
    s.cnt[i] = 0;
    s.match[i] = 0;
  }
  __syncthreads();
  int* mine = s.cnt + w * nbk;
  unsigned* match = s.match + w * nbk;
  // load the warp's rows and count them by bucket (in no order)
  if (a.vec && valid == tile) {
    const int4* src = reinterpret_cast<const int4*>(a.idx + base + lo);
    int4* dst = reinterpret_cast<int4*>(s.rows + lo);
#pragma unroll 4
    for (int i = lane; i < per_warp / 4; i += 32) {
      const int4 x = __ldg(src + i);
      dst[i] = x;
      atomicAdd(mine + bucket<kTag>(a, x.x), 1);
      atomicAdd(mine + bucket<kTag>(a, x.y), 1);
      atomicAdd(mine + bucket<kTag>(a, x.z), 1);
      atomicAdd(mine + bucket<kTag>(a, x.w), 1);
    }
  } else {
    const int end = valid < lo + per_warp ? valid : lo + per_warp;
    for (int r = lo + lane; r < end; r += 32) {
      const int t = __ldg(a.idx + base + r);
      s.rows[r] = t;
      atomicAdd(mine + bucket<kTag>(a, t), 1);
    }
  }
  __syncthreads();
  // the tile's bucket starts, its P offsets, each warp's start a bucket
  for (int d = threadIdx.x; d < nbk; d += kPartThreads) {
    int t = 0;
    for (int v = 0; v < kWarps; ++v) t += s.cnt[v * nbk + d];
    s.loc[d] = t;
    s.adj[d] = a.totals[d];
  }
  block_scan(s.loc, nbk);
  block_scan(s.adj, nbk);
  for (int d = threadIdx.x; d < nbk; d += kPartThreads) {
    int run = s.loc[d];
    s.adj[d] +=
        a.offsets[static_cast<int64_t>(d) * a.tiles + blockIdx.x] - run;
    for (int v = 0; v < kWarps; ++v) {
      const int t = s.cnt[v * nbk + d];
      s.cnt[v * nbk + d] = run;
      run += t;
    }
  }
  __syncthreads();
  // each row's slot, in row order: the warp's next slot in the bucket +
  // the step's lanes of the bucket below it; the lowest of them advances
  // the counter and clears the match word (a warp-uniform trip count: the
  // lanes meet at every __syncwarp)
  for (int j = lane; j < per_warp; j += 32) {
    const int r = lo + j;
    const bool ok = r < valid;
    const int t = ok ? s.rows[r] : 0;
    const int d = ok ? bucket<kTag>(a, t) : 0;
    if (ok) atomicOr(match + d, 1u << lane);
    __syncwarp();
    const unsigned p = ok ? match[d] : 0;
    const int at = mine[d] + __popc(p & below);
    __syncwarp();
    if (ok) {
      if ((p & below) == 0) {
        mine[d] += __popc(p);
        match[d] = 0;
      }
      s.slot[at] = kPlace ? d << 16 | r : t;
    }
    __syncwarp();
  }
  __syncthreads();
  return valid;
}

template <bool kTag>
__global__ void __launch_bounds__(kPartThreads)
    gather_count_kernel(const Part a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* cnt = reinterpret_cast<int*>(smem_raw);  // kWarps x (nb + 1)
  const int nbk = a.nb + 1;
  const int tile = 1 << a.log_tile;
  for (int i = threadIdx.x; i < kWarps * nbk; i += kPartThreads) cnt[i] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) << a.log_tile;
  const int valid = static_cast<int>(a.n - base < tile ? a.n - base : tile);
  int* mine = cnt + (threadIdx.x >> 5) * nbk;
  if (a.vec && valid == tile) {
    const int4* src = reinterpret_cast<const int4*>(a.idx + base);
#pragma unroll 4
    for (int i = threadIdx.x; i < tile / 4; i += kPartThreads) {
      const int4 x = __ldg(src + i);
      atomicAdd(mine + bucket<kTag>(a, x.x), 1);
      atomicAdd(mine + bucket<kTag>(a, x.y), 1);
      atomicAdd(mine + bucket<kTag>(a, x.z), 1);
      atomicAdd(mine + bucket<kTag>(a, x.w), 1);
    }
  } else {
    for (int i = threadIdx.x; i < valid; i += kPartThreads) {
      atomicAdd(mine + bucket<kTag>(a, __ldg(a.idx + base + i)), 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < nbk; d += kPartThreads) {
    int t = 0;
    for (int v = 0; v < kWarps; ++v) t += cnt[v * nbk + d];
    a.offsets[static_cast<int64_t>(d) * a.tiles + blockIdx.x] = t;
  }
}

// One block a bucket: its row of counts to exclusive prefixes over the
// tiles, its total to totals[d].
__global__ void __launch_bounds__(kScanThreads)
    gather_scan_kernel(const int64_t* __restrict__ counts, int64_t tiles,
                int64_t* __restrict__ offsets, int64_t* __restrict__ totals) {
  __shared__ int64_t warp_sum[kScanThreads / 32];
  const int64_t* line = counts + blockIdx.x * tiles;
  int64_t* prefix = offsets + blockIdx.x * tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int64_t carry = 0;
  for (int64_t start = 0; start < tiles;
       start += kScanThreads * kScanItems) {
    const int64_t lo = start + threadIdx.x * kScanItems;
    int64_t v[kScanItems], sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = lo + i < tiles ? line[lo + i] : 0;
      sum += v[i];
    }
    int64_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[w] = incl;
    __syncthreads();
    int64_t run = carry + incl - sum, round = 0;
#pragma unroll
    for (int j = 0; j < kScanThreads / 32; ++j) {
      run += j < w ? warp_sum[j] : 0;
      round += warp_sum[j];
    }
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (lo + i < tiles) prefix[lo + i] = run;
      run += v[i];
    }
    carry += round;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <bool kTag>
__global__ void __launch_bounds__(kPartThreads)
    gather_part_kernel(const Part a, int* __restrict__ out) {
  const Smem s = carve(a.nb + 1, 1 << a.log_tile);
  const int valid = layout<kTag, false>(
      a, s, static_cast<int64_t>(blockIdx.x) << a.log_tile);
#pragma unroll 4
  for (int i = threadIdx.x; i < valid; i += kPartThreads) {
    const int t = s.slot[i];
    out[s.adj[bucket<kTag>(a, t)] + i] = t;
  }
}

template <bool kTag>
__global__ void __launch_bounds__(kPartThreads)
    gather_place_kernel(const Part a, const int* __restrict__ v,
                        int* __restrict__ out0, int* __restrict__ out1) {
  const Smem s = carve(a.nb + 1, 1 << a.log_tile);
  const int64_t base = static_cast<int64_t>(blockIdx.x) << a.log_tile;
  const int valid = layout<kTag, true>(a, s, base);
  // each slot's value (one contiguous run of V a bucket) to its row, eight
  // reads in flight a thread; the staged index rows are not needed after
  // the layout (tagged mode reads its ties again)
  for (int i0 = threadIdx.x; i0 < valid; i0 += kPlaceBatch * kPartThreads) {
    int got[kPlaceBatch], at[kPlaceBatch];
#pragma unroll
    for (int k = 0; k < kPlaceBatch; ++k) {
      const int i = i0 + k * kPartThreads;
      at[k] = -1;
      if (i < valid) {
        const int pk = s.slot[i];
        at[k] = pk & 0xFFFF;
        got[k] = __ldg(v + s.adj[pk >> 16] + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kPlaceBatch; ++k) {
      if (at[k] >= 0) s.rows[at[k]] = got[k];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < valid; r += kPartThreads) {
    const int got = s.rows[r];
    if constexpr (kTag) {
      const bool probe = __ldg(a.idx + base + r) >= kProbeTie;
      out0[base + r] = probe ? 0 : got;
      out1[base + r] = probe ? got : 0;
    } else {
      out0[base + r] = got;
    }
  }
}

// The geometry from the wrapper's numbers; false if out of range.
bool geometry(Part& a, void* idx, int64_t n, int64_t rows0, int64_t rows1,
              int64_t tagged, int64_t log_w, int64_t log_tile,
              void* offsets, void* totals) {
  if (n < 1 || rows0 < 0 || rows1 < 0 || log_w < 0 || log_w > 30 ||
      log_tile < 8 || log_tile > 13) {
    return false;
  }
  a.idx = static_cast<const int*>(idx);
  a.n = n;
  a.rows0 = rows0;
  a.rows1 = tagged ? rows1 : 0;
  a.log_w = static_cast<int>(log_w);
  a.log_tile = static_cast<int>(log_tile);
  const int64_t w = int64_t{1} << log_w;
  const int64_t nbw = (rows0 + w - 1) / w, npw = (a.rows1 + w - 1) / w;
  if (nbw + npw > kMaxWindows) return false;
  a.nbw = static_cast<int>(nbw);
  a.nb = static_cast<int>(nbw + npw);
  a.tiles = (n + (int64_t{1} << log_tile) - 1) >> log_tile;
  a.vec = aligned(idx);
  a.offsets = static_cast<int64_t*>(offsets);
  a.totals = static_cast<const int64_t*>(totals);
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB).
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch of a per-tile kernel of the route: count, part or place.
template <typename K, typename... T>
int launch_tiles(K* kernel, const Part& a, size_t smem, cudaStream_t s,
                 T... rest) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(a.tiles), kPartThreads, smem, s>>>(a,
                                                                    rest...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx: n int32 rows on the card; srcs / outs: host arrays of num_src (1..4;
// 2 when tagged or side) device pointers, outs of n rows each (one when
// side); rows: a host array of the sources' row counts.  mode: 0 index, 1
// tagged, 2 side (one output: the value the tie names).  outs may be idx
// itself where num_src is 1 (the partitioned route's window).
int radx_gather_planes(void* idx, int64_t n, void* const* srcs,
                       const int64_t* rows, void* const* outs,
                       int64_t num_src, int64_t mode, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) * kTile || num_src < 1 ||
      num_src > kMaxPlanes || mode < kIndex || mode > kSide ||
      (mode != kIndex && num_src != 2)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.idx = static_cast<const int*>(idx);
  a.n = n;
  a.vec = aligned(idx);
  const int num_out = mode == kSide ? 1 : static_cast<int>(num_src);
  for (int g = 0; g < num_src; ++g) {
    a.src[g] = static_cast<const int*>(srcs[g]);
    a.rows[g] = rows[g];
  }
  for (int g = 0; g < num_out; ++g) {
    a.out[g] = static_cast<int*>(outs[g]);
    a.vec = a.vec && aligned(outs[g]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kTagged) return run<2, kTagged>(a, s);
  if (mode == kSide) return run<1, kSide>(a, s);
  switch (num_src) {
    case 1: return run<1, kIndex>(a, s);
    case 2: return run<2, kIndex>(a, s);
    case 3: return run<3, kIndex>(a, s);
    default: return run<4, kIndex>(a, s);
  }
}

// The partitioned route's steps (kernels/gather.py runs them in order).
// idx: n int32 rows; rows0 / rows1: the largest source's rows (index mode)
// or the build / probe rows (tagged); log_w / log_tile: log2 of a window's
// and a tile's rows; offsets: an int64 table of (windows + 1) x tiles
// rows, bucket-major (count writes the counts there, scan their prefixes
// into another); totals: (windows + 1) int64.
int radx_gather_count(void* idx, int64_t n, int64_t rows0, int64_t rows1,
                      int64_t tagged, int64_t log_w, int64_t log_tile,
                      void* counts, void* stream) {
  Part a;
  if (!geometry(a, idx, n, rows0, rows1, tagged, log_w, log_tile, counts,
                nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int) * kWarps * (a.nb + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tagged ? launch_tiles(gather_count_kernel<true>, a, smem, s)
                : launch_tiles(gather_count_kernel<false>, a, smem, s);
}

int radx_gather_scan(void* counts, int64_t buckets, int64_t tiles,
                     void* offsets, void* totals, void* stream) {
  if (buckets < 1 || buckets > kMaxWindows + 1 || tiles < 1) {
    return cudaErrorInvalidValue;
  }
  gather_scan_kernel<<<static_cast<unsigned>(buckets), kScanThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(counts), tiles,
      static_cast<int64_t*>(offsets), static_cast<int64_t*>(totals));
  return static_cast<int>(cudaGetLastError());
}

// out: n int32 rows (P).
int radx_gather_part(void* idx, int64_t n, int64_t rows0, int64_t rows1,
                     int64_t tagged, int64_t log_w, int64_t log_tile,
                     void* offsets, void* totals, void* out, void* stream) {
  Part a;
  if (!geometry(a, idx, n, rows0, rows1, tagged, log_w, log_tile, offsets,
                totals)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(a.nb + 1, 1 << a.log_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  return tagged ? launch_tiles(gather_part_kernel<true>, a, smem, s, o)
                : launch_tiles(gather_part_kernel<false>, a, smem, s, o);
}

// v: the window's values (n rows, in P's order); out0 (and out1 when
// tagged): n int32 rows.
int radx_gather_place(void* idx, int64_t n, int64_t rows0, int64_t rows1,
                      int64_t tagged, int64_t log_w, int64_t log_tile,
                      void* offsets, void* totals, void* v, void* out0,
                      void* out1, void* stream) {
  Part a;
  if (!geometry(a, idx, n, rows0, rows1, tagged, log_w, log_tile, offsets,
                totals)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(a.nb + 1, 1 << a.log_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vv = static_cast<const int*>(v);
  int* o0 = static_cast<int*>(out0);
  int* o1 = static_cast<int*>(out1);
  return tagged
             ? launch_tiles(gather_place_kernel<true>, a, smem, s, vv, o0, o1)
             : launch_tiles(gather_place_kernel<false>, a, smem, s, vv, o0,
                            o1);
}

}  // extern "C"
