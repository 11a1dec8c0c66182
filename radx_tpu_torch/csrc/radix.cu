// Radix distribution sort kernels for Hopper (sm_90a): the counting,
// ranking, scattering and concatenation steps of strategy="radix"
// (radx_tpu_torch/kernels/radix_sort.py).  The comparison work (phase 1's
// chunk sorts, phase C's slot merges) runs on csrc/bitonic.cu.
//
//   radix_hist   <- radx_tpu/kernels/radix.py::_chunk_hist_kernel (:104) and
//                   _hist_kernel (:38).  Per-tile 256-bin histogram of
//                   ((x ^ bias) >> shift) & 255 over the first n keys.
//   radix_rank   <- radx_tpu/kernels/msd.py::_rank_kernel (:117).  For each
//                   sorted chunk and splitter, the count of keys below it.
//   radix_pack   <- radx_tpu/kernels/msd.py::_pack_kernel (:194).  Copies
//                   every (chunk, bucket) run into its fill-padded slot,
//                   bucket-major.
//   radix_concat <- radx_tpu/kernels/msd.py::_concat_kernel (:243).  Puts
//                   every merged bucket's valid prefix at its global offset
//                   and the per-plane fill past n_valid.
//
// The histogram and the ranks read plane 0 only, so they have one instance
// each; pack and concat move every plane and are templated on the compare
// mode and the plane count (NCMP, P) as csrc/bitonic.cu is (planes.cuh), the
// mode choosing the fill of plane 1.  Offsets are 64-bit.  Each entry point
// launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHistSegLog = 13;     // keys per histogram block (at most)
constexpr int kConcatRowsLog = 14;  // output rows per concat block
constexpr int kPad = 0x7FFFFFFF;    // plane-0 fill: sorts after every key
constexpr int kPadIdx = 0x7FFFFFFF;  // plane-1 fill of the lex mode

// The fill of plane j (radx_tpu/kernels/msd.py::_fill).
template <int NCMP>
__device__ __forceinline__ int fill(int j) {
  return j == 0 ? kPad : (j == 1 && NCMP == 2) ? kPadIdx : 0;
}

// radix_hist — replaces _chunk_hist_kernel (the radix sort's counting step,
// top byte of the pre-sort plane per radix chunk) and _hist_kernel
// (tile_histograms: any digit, 1024-key tiles).
// Bound on the card: device memory, one read of every key (the TPU
// formulation's nibble one-hot matmuls are gone: a shared-memory atomic per
// key costs less than the read).  Design: one block per segment of at most
// 2^13 keys inside one tile, read contiguously and masked by n; 256 counters
// in shared memory with plain atomics (warp-merged atomics measured 8x
// their cost in csrc/aggregate.cu, PERF.md); the block then adds its
// nonzero counters to its tile's row with global atomics, so the wrapper
// zeroes the output.
__global__ void radix_hist_kernel(const uint32_t* x, int64_t n, int log_tile,
                                  int log_seg, int shift, uint32_t bias,
                                  int* out) {
  __shared__ int h[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_seg;
  const int64_t seg_end = base + (static_cast<int64_t>(1) << log_seg);
  const int64_t end = seg_end < n ? seg_end : n;
  for (int64_t i = base + threadIdx.x; i < end; i += blockDim.x) {
    atomicAdd(&h[((x[i] ^ bias) >> shift) & 255], 1);
  }
  __syncthreads();
  int* row = out + ((base >> log_tile) << 8);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    if (h[i]) atomicAdd(&row[i], h[i]);
  }
}

// radix_rank — replaces _rank_kernel.
// Bound on the card: latency (log2(C) dependent loads per thread; the data
// is n_chunks x splitters ints).  The TPU kernel counts row heads below each
// splitter and fetches the boundary row with a one-hot bf16 matmul; here
// one thread per (chunk, splitter) runs a lower-bound search over plane 0 of
// its sorted chunk.  Neighbouring threads search one chunk for neighbouring
// splitters, so the top of their search paths is shared in the caches.
__global__ void radix_rank_kernel(const int* x, int64_t n_chunks, int log_c,
                                  const int* splitters, int m, int* ranks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_chunks * m) return;
  const int64_t c = t / m;
  const int s = splitters[t - c * m];
  const int* row = x + (c << log_c);
  int64_t lo = 0, hi = static_cast<int64_t>(1) << log_c;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  ranks[t] = static_cast<int>(lo);
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
// [n_seg] (= n_valid) to `total` get the per-plane fill.
template <int NCMP, int P>
__global__ void radix_concat_kernel(Planes merged, Planes sorted, Planes out,
                                    const int64_t* start, const int64_t* src,
                                    int n_seg, int n_merged, int64_t total) {
  const int64_t n_valid = __ldg(start + n_seg);
  const int64_t o = static_cast<int64_t>(blockIdx.x) << kConcatRowsLog;
  const int64_t block_end = o + (static_cast<int64_t>(1) << kConcatRowsLog);
  const int64_t end = block_end < total ? block_end : total;
  int s = -1;
  for (int64_t i = o + threadIdx.x; i < end; i += blockDim.x) {
    if (i >= n_valid) {
#pragma unroll
      for (int j = 0; j < P; ++j) out.p[j][i] = fill<NCMP>(j);
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
      out.p[j][i] = (from_merged ? merged.p[j] : sorted.p[j])[k];
    }
  }
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
    const int64_t blocks =
        (total + (static_cast<int64_t>(1) << kConcatRowsLog) - 1) >>
        kConcatRowsLog;
    radix_concat_kernel<NCMP, P>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            merged, sorted, out, start, src, n_seg, n_merged, total);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// keys: n uint32 (or int32) values; out: ceil(n / 2^log_tile) x 256 int32,
// zeroed by the caller.
int radx_radix_hist(const void* keys, int64_t n, int64_t log_tile,
                    int64_t shift, int64_t bias, void* out, void* stream) {
  if (n <= 0 || log_tile < 0 || shift < 0 || shift > 31) {
    return cudaErrorInvalidValue;
  }
  const int log_seg = static_cast<int>(log_tile < kHistSegLog ? log_tile
                                                              : kHistSegLog);
  const int64_t blocks = (n + (static_cast<int64_t>(1) << log_seg) - 1) >>
                         log_seg;
  radix_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, static_cast<int>(log_tile),
      log_seg, static_cast<int>(shift), static_cast<uint32_t>(bias),
      static_cast<int*>(out));
  return cudaGetLastError();
}

// keys: n_chunks sorted chunks of 2^log_c int32 keys; splitters: m int32;
// ranks: n_chunks x m int32.
int radx_radix_rank(const void* keys, int64_t n_chunks, int64_t log_c,
                    const void* splitters, int64_t m, void* ranks,
                    void* stream) {
  if (n_chunks <= 0 || m <= 0 || log_c < 0 || log_c > 30) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (n_chunks * m + kThreads - 1) / kThreads;
  radix_rank_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n_chunks, static_cast<int>(log_c),
      static_cast<const int*>(splitters), static_cast<int>(m),
      static_cast<int*>(ranks));
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
  if (!make_planes(merged, np, &launch.merged) ||
      !make_planes(sorted, np, &launch.sorted) ||
      !make_planes(out, np, &launch.out) || n_seg <= 0 || total <= 0 ||
      n_merged > n_seg) {
    return cudaErrorInvalidValue;
  }
  launch.start = static_cast<const int64_t*>(start);
  launch.src = static_cast<const int64_t*>(src);
  launch.n_seg = static_cast<int>(n_seg);
  launch.n_merged = static_cast<int>(n_merged);
  launch.total = total;
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

}  // extern "C"
