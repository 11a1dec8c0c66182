// Radix distribution sort kernels for Hopper (sm_90a): the counting,
// ranking, scattering and concatenation steps of strategy="radix"
// (radx_tpu_torch/kernels/radix_sort.py).  The comparison work (phase 1's
// chunk sorts, phase C's slot merges) runs on csrc/bitonic.cu.
//
//   radix_hist   <- radx_tpu/kernels/radix.py::_chunk_hist_kernel (:104) and
//                   _hist_kernel (:38).  Per-tile 256-bin histogram of
//                   ((x ^ bias) >> shift) & 255 over the first n keys, and
//                   optionally the 256 totals.
//   radix_rank   <- radx_tpu/kernels/msd.py::_rank_kernel (:117), with the
//                   XLA around it (radix_sort.py::choose_splitters' clamp,
//                   the run bounds and the overflow flag): from the sorted
//                   samples and the digit totals to the splitters, their
//                   ranks in every sorted chunk, the run bounds, the
//                   overflow flag and the concatenation's segment tables,
//                   in one launch.
//   radix_pack   <- radx_tpu/kernels/msd.py::_pack_kernel (:194).  Copies
//                   every (chunk, bucket) run into its fill-padded slot,
//                   bucket-major.
//   radix_concat <- radx_tpu/kernels/msd.py::_concat_kernel (:243).  Puts
//                   every merged bucket's valid prefix at its global offset
//                   and the per-plane fill past n_valid.
//
// The histogram and the ranks read plane 0 only (the histogram has one
// instance for tiles a warp counts and one for larger ones); pack and
// concat move every plane and are templated on the compare mode
// and the plane count (NCMP, P) as csrc/bitonic.cu is (planes.cuh), the
// mode choosing the fill of plane 1.  Offsets are 64-bit.  Each entry point
// launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError().

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kConcatRowsLog = 14;  // output rows per concat block
constexpr int kPad = 0x7FFFFFFF;    // plane-0 fill: sorts after every key
constexpr int kPadIdx = 0x7FFFFFFF;  // plane-1 fill of the lex mode

// The fill of plane j (radx_tpu/kernels/msd.py::_fill).
template <int NCMP>
__device__ __forceinline__ int fill(int j) {
  return j == 0 ? kPad : (j == 1 && NCMP == 2) ? kPadIdx : 0;
}

// --- radix_hist ----------------------------------------------------------------
//
// Replaces _chunk_hist_kernel (the radix sort's counting step: the top byte
// of the pre-sort plane per radix chunk, and the 256 digit totals that
// radix_rank reads) and _hist_kernel (tile_histograms: any digit, 1024-key
// tiles).  Bound on the card: device memory, every key read once and every
// row written once (the TPU formulation's nibble one-hot matmuls are gone:
// counting in shared memory costs less than the read).
//
// Design: keys are read with 16-byte loads (scalar ones for a misaligned
// head and the ragged tail), kHistUnroll vectors a thread in flight, and
// counted with one shared-memory atomic a key into a warp-private 256-bin
// histogram, so no two warps share a counter.  Timed against per-lane run
// counters (a lane holds the two digits it met last and adds a count only
// when a third displaces one), plain atomics were as fast or faster on
// uniform, all-equal and two-valued keys (PERF.md, §6): the read hides
// the atomics, and a warp's 32 atomics on one address do not serialise
// visibly.
//   * tile <= 2^kTileLogMax keys (K14's 1024): one warp owns a whole tile and
//     writes its row of 256 counts with plain coalesced stores: no global
//     atomics, and the output needs no zeroing;
//   * larger tiles (K10's 2^19-key chunks): a block counts a segment of
//     2^kSegLog keys in its warps' sub-histograms, merges them in shared
//     memory and adds each nonzero bin to its tile's row with one global
//     atomic (the caller zeroes the rows: several blocks meet in a row).
// With `totals`, every nonzero bin is also added to the totals row.

constexpr int kHistWarps = kThreads / 32;
constexpr int kTileLogMax = 13;  // one warp a tile up to 2^13 keys
constexpr int kSegLog = 16;      // keys a block counts of a larger tile
constexpr int kHistUnroll = 8;   // 16-byte loads a thread has in flight

struct HistArgs {
  const uint32_t* x;
  int64_t n;
  int log_tile, shift;
  uint32_t bias;
};

__device__ __forceinline__ void count(const HistArgs& a, int* h, uint32_t v) {
  atomicAdd(&h[((v ^ a.bias) >> a.shift) & 255u], 1);
}

// Count keys [lo, hi) into h: thread `tid` of a group of `nthr`.  Vectors
// from the first 16-byte boundary at or after lo; the keys before it and
// after the last whole vector one a thread.
__device__ void count_range(const HistArgs& a, int64_t lo, int64_t hi, int tid,
                            int nthr, int* h) {
  const int head =
      static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(a.x + lo) >> 2) & 3)) &
                       3);
  const int64_t v0 = lo + head < hi ? lo + head : hi;
  const int64_t nv = (hi - v0) >> 2;
  const int64_t t0 = v0 + 4 * nv;
  if (tid < v0 - lo) count(a, h, a.x[lo + tid]);
  if (tid < hi - t0) count(a, h, a.x[t0 + tid]);
  const uint4* xv = reinterpret_cast<const uint4*>(a.x + v0);
  for (int64_t i = tid; i < nv; i += static_cast<int64_t>(nthr) * kHistUnroll) {
    uint4 v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t k = i + static_cast<int64_t>(u) * nthr;
      if (k < nv) v[u] = __ldcs(xv + k);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (i + static_cast<int64_t>(u) * nthr < nv) {
        count(a, h, v[u].x);
        count(a, h, v[u].y);
        count(a, h, v[u].z);
        count(a, h, v[u].w);
      }
    }
  }
}

// Tiles of at most 2^kTileLogMax keys: warp w of block b owns tile 8 b + w.
__global__ void __launch_bounds__(kThreads)
    radix_hist_tile_kernel(HistArgs a, int64_t rows, int* out, int* totals) {
  __shared__ int hs[kHistWarps][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kHistWarps + warp;
  if (t >= rows) return;
  int* h = hs[warp];
  for (int i = lane; i < 256; i += 32) h[i] = 0;
  __syncwarp();
  const int64_t lo = t << a.log_tile;
  const int64_t end = lo + (static_cast<int64_t>(1) << a.log_tile);
  const int64_t hi = end < a.n ? end : a.n;
  if (lo < hi) count_range(a, lo, hi, lane, 32, h);
  __syncwarp();
  int* row = out + (t << 8);
  for (int i = lane; i < 256; i += 32) {
    const int v = h[i];
    row[i] = v;
    if (totals != nullptr && v) atomicAdd(&totals[i], v);
  }
}

// Larger tiles: block b counts keys [b 2^log_seg, (b + 1) 2^log_seg) of one
// tile.  Its 256 threads are the 256 bins of the merge.
__global__ void __launch_bounds__(kThreads)
    radix_hist_seg_kernel(HistArgs a, int log_seg, int* out, int* totals) {
  __shared__ int hs[kHistWarps][256];
  for (int i = threadIdx.x; i < kHistWarps * 256; i += kThreads) {
    hs[i >> 8][i & 255] = 0;
  }
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(blockIdx.x) << log_seg;
  const int64_t end = lo + (static_cast<int64_t>(1) << log_seg);
  const int64_t hi = end < a.n ? end : a.n;
  count_range(a, lo, hi, threadIdx.x, kThreads, hs[threadIdx.x >> 5]);
  __syncthreads();
  const int b = threadIdx.x;
  int v = 0;
#pragma unroll
  for (int w = 0; w < kHistWarps; ++w) v += hs[w][b];
  if (v) {
    atomicAdd(&out[((lo >> a.log_tile) << 8) + b], v);
    if (totals != nullptr) atomicAdd(&totals[b], v);
  }
}

// --- radix_rank ----------------------------------------------------------------
//
// Replaces _rank_kernel and the XLA around it: the tail of choose_splitters
// (the digit CDF, the sample count below the sentinel, the sample
// quantiles and their clamp into the digit interval of each bucket's exact
// target), the ranks, and the run bounds / overflow flag / concatenation
// segments (radix_sort.run_bounds), which the port computed in about fifty
// small launches before the host read the flag.
//
// Bound on the card: latency, then the windows' bytes.  The data are small
// (the totals, m splitters from the sorted samples, one window a splitter
// and chunk; the outputs n_chunks x (nb_pad + 1) ints), so what counts is
// the chain of dependent round trips to device memory.  The first port ran
// a binary search per (chunk, splitter): log2(C) = 19 dependent loads.
// Here:
//   * prologue, in every block: the 256 totals and a block scan give the
//     digit CDF; the count of samples below the sentinel is a lower bound
//     found by two rounds of kRankThreads probes (__syncthreads_count);
//     thread j then computes splitter j exactly as choose_splitters does
//     (int64 targets j * n_keys / nb), into shared memory.  The loads of
//     the chunk's heads, the totals and the first probes go out together;
//   * ranks by a two-level search: the heads are the chunk's regular
//     samples (every R-th key from `first`, R = C / H: the splitter
//     samples before they were sorted, contiguous, so a block stages its H
//     heads with coalesced loads); thread j finds the heads below splitter
//     j in shared memory, which leaves one window of R keys; warps read
//     the windows in parts of 128 keys (one 16-byte load a lane, kRankBatch
//     parts a warp in flight) and count the keys below the splitter with
//     four ballots: two dependent round trips, not 19.  A first design
//     staged every 128th key of the sorted chunk: C / 128 scattered 32-byte
//     sectors a chunk, 27 us at 2^26 on an H100 (PERF.md, §6);
//   * one block a chunk (kRankThreads threads: up to 32 window parts a warp
//     round, and the chunks fill the card from 128 of them);
//   * epilogue: each block writes its chunk's row of run bounds, sets the
//     overflow flag if a run outgrows its slot, adds its bucket sizes to
//     the scratch's per-bucket sums (atomics) and, with a tail, its
//     sentinel-key rows' count and source offset.  The last block to take
//     a ticket from the scratch (thread 0's acq_rel fetch_add after the
//     block's barrier: it releases the block's writes and acquires the
//     others') scans the bucket sums (then the tail counts) into the
//     segment starts.

constexpr int kRankThreads = 1024;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kPartKeys = 128;   // keys of a window part: a 16-byte load a lane
constexpr int kRankBatch = 4;    // window parts a warp has in flight
constexpr int kHeadLoads = 2;    // heads a thread stages (H <= 2048)
constexpr int kScanItems = 4;    // segments a thread of the last block scans

struct RankArgs {
  const int* keys;      // n_chunks sorted chunks of 2^log_c keys
  const int* heads;     // n_chunks x 2^(log_c - log_r): key first + k R
  const int* samples;   // n_samples ascending splitter samples
  const int* totals;    // 256 digit totals (top byte, original order)
  const int64_t* pads;  // sentinel keys among the first n_valid, or null
  int64_t n_chunks, n_samples, n_valid;
  int log_c, log_r, first, log_tile, log_slot, nb, nb_pad, m, tail;
  int* splitters;      // m
  int* bounds;         // n_chunks x (nb_pad + 1)
  int64_t* start;      // n_seg + 1
  int64_t* src;        // n_seg
  unsigned long long* overflow;  // 0-d, zeroed
  unsigned long long* scratch;   // ticket, nb_pad bucket sums, n_chunks tail
                                 // counts; zeroed
};

using TicketRef =
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// Inclusive prefix sum over the block's threads; every thread calls it.
__device__ int64_t block_scan(int64_t x, int64_t* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t y = __shfl_up_sync(~0u, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kRankWarps ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_up_sync(~0u, w, off);
      if (lane >= off) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += wsum[warp - 1];
  __syncthreads();
  return x;
}

// Rows below n_valid in chunk c: its block-cyclic tiles g n_chunks + c,
// g < 2^(log_c - log_tile), the first `full` tiles whole and tile `full`
// holding `rem` rows.
__device__ int64_t chunk_valid(const RankArgs& a, int64_t c) {
  const int64_t tiles = static_cast<int64_t>(1) << (a.log_c - a.log_tile);
  const int64_t full = a.n_valid >> a.log_tile;
  const int64_t rem = a.n_valid & ((static_cast<int64_t>(1) << a.log_tile) - 1);
  int64_t whole = full > c ? (full - c + a.n_chunks - 1) / a.n_chunks : 0;
  whole = whole < tiles ? whole : tiles;
  const bool part = rem && full % a.n_chunks == c && full / a.n_chunks < tiles;
  return (whole << a.log_tile) + (part ? rem : 0);
}

__global__ void __launch_bounds__(kRankThreads) radix_rank_kernel(RankArgs a) {
  extern __shared__ int smem[];
  int* spl = smem;          // m splitters
  int* rnk = spl + a.m;     // m: the window's first key, then the rank
  int* cnt = rnk + a.m;     // m: keys below the splitter in its window
  int* heads = cnt + a.m;   // H
  __shared__ int64_t cdf[256];
  __shared__ int64_t wsum[kRankWarps];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c = blockIdx.x;
  const int64_t C = static_cast<int64_t>(1) << a.log_c;
  const int R = 1 << a.log_r;
  const int H = static_cast<int>(C >> a.log_r);
  const int* row = a.keys + (c << a.log_c);

  // one round trip for the chunk's heads, the totals and the first probes
  // of the samples: none depends on another
  const int64_t S = a.n_samples;
  const int64_t w = (S + kRankThreads - 1) / kRankThreads;
  const int64_t p1 = tid * w;
  const int probe = p1 < S ? __ldg(a.samples + p1) : kPad;
  const int64_t tot = tid < 256 ? __ldg(a.totals + tid) : 0;
  int hv[kHeadLoads];
#pragma unroll
  for (int u = 0; u < kHeadLoads; ++u) {
    const int k = tid + u * kRankThreads;
    if (k < H) hv[u] = __ldg(a.heads + c * H + k);
  }
#pragma unroll
  for (int u = 0; u < kHeadLoads; ++u) {
    const int k = tid + u * kRankThreads;
    if (k < H) heads[k] = hv[u];
  }
  for (int j = tid; j < a.m; j += kRankThreads) cnt[j] = 0;
  // the digit CDF: keys of a smaller top byte
  const int64_t incl = block_scan(tot, wsum);
  if (tid < 256) cdf[tid] = incl - tot;
  // nvs: samples below the sentinel.  Probes every w-th sample, then the
  // w - 1 samples after the last probe below it.
  const int below = __syncthreads_count(probe < kPad);
  int64_t nvs = 0;
  if (below > 0) {
    const int64_t base = (below - 1) * w + 1;
    const int64_t end = base + w - 1 < S ? base + w - 1 : S;
    int64_t n_below = 0;
    for (int64_t p = base; p < end; p += kRankThreads) {
      n_below += __syncthreads_count(p + tid < end &&
                                     __ldg(a.samples + p + tid) < kPad);
    }
    nvs = base + n_below;
  }
  // the splitters (radix_sort.choose_splitters)
  const int64_t n_keys = a.pads != nullptr ? a.n_valid - __ldg(a.pads)
                                           : a.n_valid;
  for (int j = tid; j < a.m; j += kRankThreads) {
    int s = kPad;  // with a tail, the last one ends the last bucket
    if (j < a.nb - 1) {
      const int64_t jj = j + 1;
      int64_t spos = jj * nvs / a.nb;
      spos = spos < S - 1 ? spos : S - 1;
      const int64_t sval = __ldg(a.samples + spos);
      const int64_t t = jj * n_keys / a.nb;  // the bucket's exact target
      int lo = 1, hi = 256;  // the first digit d >= 1 with cdf[d] > t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cdf[mid] <= t) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      // first biased key of the target's top byte lo - 1
      const int64_t dlo = static_cast<int>(static_cast<uint32_t>((lo - 1) ^ 128)
                                           << 24);
      const int64_t v = sval > dlo ? sval : dlo;
      s = static_cast<int>(v < dlo + 0x00FFFFFF ? v : dlo + 0x00FFFFFF);
    }
    spl[j] = s;
  }
  __syncthreads();
  // level 1: i heads below the splitter leave the window of R keys from
  // first + (i - 1) R (from 0 if i = 0, to C if i = H)
  for (int j = tid; j < a.m; j += kRankThreads) {
    const int s = spl[j];
    int lo = 0, hi = H;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (heads[mid] < s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t w0 = lo == 0 ? 0 : a.first + static_cast<int64_t>(lo - 1) * R;
    rnk[j] = static_cast<int>(w0 < C - R ? w0 : C - R);
  }
  __syncthreads();
  // level 2: warps count the keys below each splitter in its window's parts
  const int parts = R / kPartKeys;
  const int n_parts = a.m * parts;
  for (int t0 = warp; t0 < n_parts; t0 += kRankWarps * kRankBatch) {
    int4 v[kRankBatch];
#pragma unroll
    for (int b = 0; b < kRankBatch; ++b) {
      const int t = t0 + b * kRankWarps;
      if (t < n_parts) {
        const int j = t / parts;
        v[b] = __ldg(reinterpret_cast<const int4*>(
                         row + rnk[j] + (t - j * parts) * kPartKeys) +
                     lane);
      }
    }
#pragma unroll
    for (int b = 0; b < kRankBatch; ++b) {
      const int t = t0 + b * kRankWarps;
      if (t < n_parts) {
        const int j = t / parts;
        const int s = spl[j];
        const int k = __popc(__ballot_sync(~0u, v[b].x < s)) +
                      __popc(__ballot_sync(~0u, v[b].y < s)) +
                      __popc(__ballot_sync(~0u, v[b].z < s)) +
                      __popc(__ballot_sync(~0u, v[b].w < s));
        if (lane == 0 && k) atomicAdd(&cnt[j], k);
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < a.m; j += kRankThreads) rnk[j] += cnt[j];
  __syncthreads();
  // the chunk's run bounds [0, ranks..., top, ..., top], bucket sizes and
  // overflow
  const int64_t valid = chunk_valid(a, c);
  const int top = a.tail ? rnk[a.nb - 1] : static_cast<int>(valid);
  int* brow = a.bounds + c * (a.nb_pad + 1);
  int big = 0;
  for (int b = tid; b <= a.nb_pad; b += kRankThreads) {
    const int lo = b == 0 ? 0 : b < a.nb ? rnk[b - 1] : top;
    brow[b] = lo;
    if (b < a.nb) {  // buckets from nb on are empty
      const int size = (b + 1 < a.nb ? rnk[b] : top) - lo;
      big |= size > (1 << a.log_slot);
      if (size) atomicAdd(a.scratch + 1 + b, static_cast<unsigned long long>(size));
    }
  }
  if (tid == 0 && a.tail) {
    a.scratch[1 + a.nb_pad + c] = static_cast<unsigned long long>(valid - top);
    a.src[a.nb_pad + c] = c * C + top;
  }
  if (c == 0) {
    for (int j = tid; j < a.m; j += kRankThreads) a.splitters[j] = spl[j];
    for (int b = tid; b < a.nb_pad; b += kRankThreads) a.src[b] = b * C;
  }
  if (__syncthreads_or(big) && tid == 0) *a.overflow = 1;
  // every write of the block precedes the barrier above; thread 0 releases
  // them with its ticket, and the last block acquires all the others'
  if (tid == 0) {
    last = TicketRef(a.scratch[0]).fetch_add(1, cuda::memory_order_acq_rel) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: start = [0, cumsum(bucket sums, then tail counts)]
  const int n_scan = a.nb_pad + (a.tail ? static_cast<int>(a.n_chunks) : 0);
  int64_t sv[kScanItems];
  int64_t sum = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int i = tid * kScanItems + u;
    sv[u] = i < n_scan ? static_cast<int64_t>(__ldcg(a.scratch + 1 + i)) : 0;
    sum += sv[u];
  }
  int64_t run = block_scan(sum, wsum) - sum;
  if (tid == 0) a.start[0] = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int i = tid * kScanItems + u;
    run += sv[u];
    if (i < n_scan) a.start[1 + i] = run;
  }
}

// radix_pack — replaces _pack_kernel (the scattering step).
// Bound on the card: device memory, the sorted chunks read once and the
// packed slots (nb_pad / n_chunks times the input) written once.  The TPU
// kernel assembles each run from a sublane window and two lane gathers; here
// one block per (chunk c, bucket b) copies keys [bounds[c, b], bounds[c,
// b+1]) of chunk c, contiguously, to slot (b, c) and writes the per-plane
// fill past the run.  A run longer than the slot is cut at the slot (the
// host's overflow flag reports it), so no write leaves the slot.
template <int NCMP, int P>
__global__ void radix_pack_kernel(Planes in, Planes out, const int* bounds,
                                  int nb_pad, int log_c, int log_slot) {
  const int64_t n_chunks = gridDim.x;
  const int64_t c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int slot = 1 << log_slot;
  const int* row = bounds + c * (nb_pad + 1);
  const int lo = row[b];
  const int cnt = max(0, min(row[b + 1] - lo, slot));
  const int64_t src = (c << log_c) + lo;
  const int64_t dst = (b * n_chunks + c) << log_slot;
  for (int i = threadIdx.x; i < slot; i += blockDim.x) {
    if (i < cnt) {
#pragma unroll
      for (int j = 0; j < P; ++j) out.p[j][dst + i] = in.p[j][src + i];
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) out.p[j][dst + i] = fill<NCMP>(j);
    }
  }
}

// Index of the last segment whose start is <= i (starts ascend; n_seg + 1
// entries, the last one the end).
__device__ __forceinline__ int segment_of(const int64_t* start, int n_seg,
                                          int64_t i) {
  int lo = 0, hi = n_seg;  // answer in [lo, hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(start + mid) <= i) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// radix_concat — replaces _concat_kernel (the exact concatenation).
// Bound on the card: device memory, every output row written once and read
// once from its bucket.  The output is a list of segments: segment s covers
// rows [start[s], start[s+1]) and reads them from offset src[s] of the
// merged buckets (s < n_merged) or of the sorted chunks (the rider mode's
// sentinel-key rows, kernels/radix_sort.py).  The TPU kernel walks a window
// of K buckets per output block and needs the K-window overflow test; here
// each thread finds the segment of its first row by a binary search of the
// segment starts (cached reads, shared by the block's threads) and walks
// forward, so any number of buckets may meet a block.  Rows from start
// [n_seg] (= n_valid) to `total` get the per-plane fill.  Row i of plane j
// is stored through `store` (PlaneStore: out.p[j][i]; KeyStore: plane 0 to
// the caller's keys, unbiased).
template <int NCMP, int P, typename Store>
__device__ __forceinline__ void concat_rows(const Planes& merged,
                                            const Planes& sorted,
                                            const Store& store,
                                            const int64_t* start,
                                            const int64_t* src, int n_seg,
                                            int n_merged, int64_t total) {
  const int64_t n_valid = __ldg(start + n_seg);
  const int64_t o = static_cast<int64_t>(blockIdx.x) << kConcatRowsLog;
  const int64_t block_end = o + (static_cast<int64_t>(1) << kConcatRowsLog);
  const int64_t end = block_end < total ? block_end : total;
  int s = -1;
  for (int64_t i = o + threadIdx.x; i < end; i += blockDim.x) {
    if (i >= n_valid) {
#pragma unroll
      for (int j = 0; j < P; ++j) store(j, i, fill<NCMP>(j));
      continue;
    }
    if (s < 0) {
      s = segment_of(start, n_seg, i);
    } else {
      while (__ldg(start + s + 1) <= i) ++s;
    }
    const int64_t k = __ldg(src + s) + (i - __ldg(start + s));
    const bool from_merged = s < n_merged;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      store(j, i, (from_merged ? merged.p[j] : sorted.p[j])[k]);
    }
  }
}

struct PlaneStore {
  Planes out;
  __device__ __forceinline__ void operator()(int j, int64_t i, int v) const {
    out.p[j][i] = v;
  }
};

// The last store of a radix sort (radix_concat's unbiasing form, as
// csrc/tile_engine.cuh's KeyOut is the network's): plane 0's row i goes to
// key[i] ^ xr for i below `rows` (in place: key = plane 0, or the caller's
// output of its real rows, the pads past it not stored); the other planes
// go to `out`.
struct ConcatKeyOut {
  int* key;
  int64_t rows;
  int xr;
};

struct KeyStore {
  Planes out;
  ConcatKeyOut key;
  __device__ __forceinline__ void operator()(int j, int64_t i, int v) const {
    if (j != 0) {
      out.p[j][i] = v;
    } else if (i < key.rows) {
      key.key[i] = v ^ key.xr;
    }
  }
};

template <int NCMP, int P>
__global__ void radix_concat_kernel(Planes merged, Planes sorted, Planes out,
                                    const int64_t* start, const int64_t* src,
                                    int n_seg, int n_merged, int64_t total) {
  concat_rows<NCMP, P>(merged, sorted, PlaneStore{out}, start, src, n_seg,
                       n_merged, total);
}

// radix_concat's unbiasing form: the radix sort's last launch writes the
// keys back unbiased (radx_tpu/ops/sort.py:118, the bias XORed out), so no
// pass follows it.  Same bound and design; plane 0 adds no byte (the pads
// past `rows` are not stored).  Keys, (key, rider) and lex2.
template <int NCMP, int P>
__global__ void radix_concat_kernel(Planes merged, Planes sorted, Planes out,
                                    ConcatKeyOut key, const int64_t* start,
                                    const int64_t* src, int n_seg,
                                    int n_merged, int64_t total) {
  concat_rows<NCMP, P>(merged, sorted, KeyStore{out, key}, start, src, n_seg,
                       n_merged, total);
}

struct PackLaunch {
  Planes in, out;
  const int* bounds;
  int64_t n_chunks;
  int nb_pad, log_c, log_slot;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    const dim3 grid(static_cast<unsigned>(n_chunks),
                    static_cast<unsigned>(nb_pad));
    radix_pack_kernel<NCMP, P><<<grid, kThreads, 0, stream>>>(
        in, out, bounds, nb_pad, log_c, log_slot);
    return cudaGetLastError();
  }
};

struct ConcatLaunch {
  Planes merged, sorted, out;
  const int64_t* start;
  const int64_t* src;
  int n_seg, n_merged;
  int64_t total;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    radix_concat_kernel<NCMP, P>
        <<<blocks(), kThreads, 0, stream>>>(merged, sorted, out, start, src,
                                            n_seg, n_merged, total);
    return cudaGetLastError();
  }
  unsigned blocks() const {
    return static_cast<unsigned>(
        (total + (static_cast<int64_t>(1) << kConcatRowsLog) - 1) >>
        kConcatRowsLog);
  }
};

struct ConcatOutLaunch {
  ConcatLaunch c;
  ConcatKeyOut key;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    radix_concat_kernel<NCMP, P><<<c.blocks(), kThreads, 0, c.stream>>>(
        c.merged, c.sorted, c.out, key, c.start, c.src, c.n_seg, c.n_merged,
        c.total);
    return cudaGetLastError();
  }
};

// The launch of radix_concat (either form) from the C entry's arguments.
bool make_concat(void* const* merged, void* const* sorted, void* const* out,
                 int64_t np, const void* start, const void* src, int64_t n_seg,
                 int64_t n_merged, int64_t total, void* stream,
                 ConcatLaunch* c) {
  if (!make_planes(merged, np, &c->merged) ||
      !make_planes(sorted, np, &c->sorted) || !make_planes(out, np, &c->out) ||
      n_seg <= 0 || total <= 0 || n_merged > n_seg) {
    return false;
  }
  c->start = static_cast<const int64_t*>(start);
  c->src = static_cast<const int64_t*>(src);
  c->n_seg = static_cast<int>(n_seg);
  c->n_merged = static_cast<int>(n_merged);
  c->total = total;
  c->stream = static_cast<cudaStream_t>(stream);
  return true;
}

}  // namespace

extern "C" {

// keys: n uint32 (or int32) values; out: rows x 256 int32, rows = ceil(keys
// / 2^log_tile) (zeroed by the caller where log_tile > kTileLogMax); totals:
// 256 int32, zeroed by the caller, or null.
int radx_radix_hist(const void* keys, int64_t n, int64_t rows, int64_t log_tile,
                    int64_t shift, int64_t bias, void* out, void* totals,
                    void* stream) {
  if (n <= 0 || rows <= 0 || log_tile < 0 || log_tile > 40 || shift < 0 ||
      shift > 31 || ((n - 1) >> log_tile) >= rows) {
    return cudaErrorInvalidValue;
  }
  const HistArgs a{static_cast<const uint32_t*>(keys), n,
                   static_cast<int>(log_tile), static_cast<int>(shift),
                   static_cast<uint32_t>(bias)};
  const auto s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  int* t = static_cast<int*>(totals);
  if (log_tile <= kTileLogMax) {
    const auto blocks =
        static_cast<unsigned>((rows + kHistWarps - 1) / kHistWarps);
    radix_hist_tile_kernel<<<blocks, kThreads, 0, s>>>(a, rows, o, t);
  } else {
    const int log_seg = static_cast<int>(log_tile < kSegLog ? log_tile : kSegLog);
    const auto blocks = static_cast<unsigned>(
        (n + (static_cast<int64_t>(1) << log_seg) - 1) >> log_seg);
    radix_hist_seg_kernel<<<blocks, kThreads, 0, s>>>(a, log_seg, o, t);
  }
  return cudaGetLastError();
}

// keys: n_chunks sorted chunks of 2^log_c int32 keys (16-byte aligned);
// heads: n_chunks x 2^(log_c - log_r) int32, key first + k 2^log_r of each
// chunk; samples: n_samples ascending int32; totals: 256 int32; pads: one
// int64 or null; splitters: m = nb - 1 + tail int32; bounds: n_chunks x
// (nb_pad + 1) int32; start / src: n_seg + 1 / n_seg int64, n_seg = nb_pad
// (+ n_chunks with tail); overflow: one int64 and scratch: 1 + nb_pad +
// n_chunks uint64, both zeroed.  At most 2048 heads a chunk, windows of at
// least 128 keys, n_seg <= 4096.
int radx_radix_rank(const void* keys, int64_t n_chunks, int64_t log_c,
                    const void* heads, int64_t log_r, int64_t first,
                    const void* samples, int64_t n_samples, const void* totals,
                    const void* pads, int64_t n_valid, int64_t log_tile,
                    int64_t log_slot, int64_t nb, int64_t nb_pad, int64_t tail,
                    void* splitters, void* bounds, void* start, void* src,
                    void* overflow, void* scratch, void* stream) {
  const int64_t m = nb - 1 + (tail ? 1 : 0);
  if (n_chunks <= 0 || n_chunks > 0x7FFFFFFF || log_c < 0 || log_c > 30 ||
      log_r < 7 || log_r > log_c ||
      (static_cast<int64_t>(1) << (log_c - log_r)) >
          static_cast<int64_t>(kHeadLoads) * kRankThreads ||
      first < 0 || first >= (static_cast<int64_t>(1) << log_r) ||
      nb_pad + (tail ? n_chunks : 0) > kScanItems * kRankThreads ||
      n_samples <= 0 || nb < 2 || nb_pad < nb || log_tile < 0 ||
      log_tile > log_c || log_slot < 0 || log_slot > log_c || n_valid < 0 ||
      n_valid > (n_chunks << log_c) ||
      (reinterpret_cast<uintptr_t>(keys) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  RankArgs a;
  a.keys = static_cast<const int*>(keys);
  a.heads = static_cast<const int*>(heads);
  a.samples = static_cast<const int*>(samples);
  a.totals = static_cast<const int*>(totals);
  a.pads = static_cast<const int64_t*>(pads);
  a.n_chunks = n_chunks;
  a.n_samples = n_samples;
  a.n_valid = n_valid;
  a.log_c = static_cast<int>(log_c);
  a.log_r = static_cast<int>(log_r);
  a.first = static_cast<int>(first);
  a.log_tile = static_cast<int>(log_tile);
  a.log_slot = static_cast<int>(log_slot);
  a.nb = static_cast<int>(nb);
  a.nb_pad = static_cast<int>(nb_pad);
  a.m = static_cast<int>(m);
  a.tail = tail ? 1 : 0;
  a.splitters = static_cast<int*>(splitters);
  a.bounds = static_cast<int*>(bounds);
  a.start = static_cast<int64_t*>(start);
  a.src = static_cast<int64_t*>(src);
  a.overflow = static_cast<unsigned long long*>(overflow);
  a.scratch = static_cast<unsigned long long*>(scratch);
  const size_t smem =
      sizeof(int) * (3 * m + (static_cast<int64_t>(1) << (log_c - log_r)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        radix_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  radix_rank_kernel<<<static_cast<unsigned>(n_chunks), kRankThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// in: np planes of n_chunks sorted chunks of 2^log_c keys; bounds: n_chunks
// x (nb_pad + 1) int32 run bounds; out: np planes of nb_pad x n_chunks slots
// of 2^log_slot keys.
int radx_radix_pack(void* const* in, void* const* out, int64_t np,
                    int64_t ncmp, int64_t n_chunks, int64_t log_c,
                    const void* bounds, int64_t nb_pad, int64_t log_slot,
                    void* stream) {
  PackLaunch launch;
  if (!make_planes(in, np, &launch.in) || !make_planes(out, np, &launch.out) ||
      n_chunks <= 0 || nb_pad <= 0 || nb_pad > 65535 || log_slot > log_c ||
      log_c > 30) {
    return cudaErrorInvalidValue;
  }
  launch.bounds = static_cast<const int*>(bounds);
  launch.n_chunks = n_chunks;
  launch.nb_pad = static_cast<int>(nb_pad);
  launch.log_c = static_cast<int>(log_c);
  launch.log_slot = static_cast<int>(log_slot);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// merged / sorted / out: np planes each; start: n_seg + 1 int64 segment
// starts (start[n_seg] = n_valid); src: n_seg int64 source offsets, into
// `merged` for the first n_merged segments and into `sorted` after them;
// total: rows of every output plane.
int radx_radix_concat(void* const* merged, void* const* sorted,
                      void* const* out, int64_t np, int64_t ncmp,
                      const void* start, const void* src, int64_t n_seg,
                      int64_t n_merged, int64_t total, void* stream) {
  ConcatLaunch launch;
  if (!make_concat(merged, sorted, out, np, start, src, n_seg, n_merged,
                   total, stream, &launch)) {
    return cudaErrorInvalidValue;
  }
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// radix_concat's unbiasing form: as radx_radix_concat, plane 0 to `key`
// (its first key_rows rows, XORed with key_xor) and not to out[0]; keys,
// rider and lex2.
int radx_radix_concat_out(void* const* merged, void* const* sorted,
                          void* const* out, int64_t np, int64_t ncmp,
                          const void* start, const void* src, int64_t n_seg,
                          int64_t n_merged, int64_t total, void* key,
                          int64_t key_rows, int64_t key_xor, void* stream) {
  ConcatOutLaunch launch;
  if (!make_concat(merged, sorted, out, np, start, src, n_seg, n_merged,
                   total, stream, &launch.c) ||
      key_rows < 0 || (key == nullptr && key_rows > 0)) {
    return cudaErrorInvalidValue;
  }
  launch.key = {static_cast<int*>(key), key_rows, static_cast<int>(key_xor)};
  return dispatch_edges(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

}  // extern "C"
