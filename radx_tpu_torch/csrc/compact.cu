// Stable mask compaction for Hopper (sm_90a): the port of
// radx_tpu/kernels/compact.py::_compact_chunk_kernel (:54) and of the XLA
// stitch after it (compact_flat, :229-243).
//
// Input: an int32 mask of n rows (nonzero = keep) and P int32 planes of n
// rows (P <= kMaxPlanes).  Output: P planes of n rows whose first `count`
// rows are the kept rows in their original order; the rows after them are
// left as they were (the caller allocates them, their contents are not part
// of the result).  The array is cut into tiles of 2^log_tile rows, one block
// per tile.
//
// The TPU compacts each chunk in VMEM (per-row leftpack, then run merges)
// and stitches the chunks' prefixes with a serial loop of
// dynamic_update_slice over the ordered grid.  Blocks on a GPU run in no
// order, so the port splits the work into two passes over the mask:
//
//   compact_count  — each block counts the kept rows of its tile;
//   (host)         — an inclusive scan of the tile counts gives each tile's
//                    output offset (torch.cumsum over n / 2^log_tile
//                    counts, the counterpart of the XLA cumsum at :229-232);
//   compact_write  — each block walks its tile in rounds of blockDim rows,
//                    ranks every kept row by __ballot_sync / __popc within
//                    its warp plus a scan of the warp counts, and writes the
//                    row's P values at offset + rank.
//
// Bound on the card: device-memory bandwidth.  The mask is read twice, the
// planes once, and only the kept rows are written; every access of a warp
// is to consecutive addresses.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 4;

struct Planes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
};

__device__ __forceinline__ int64_t tile_end(int64_t base, int log_tile,
                                            int64_t n) {
  const int64_t end = base + (static_cast<int64_t>(1) << log_tile);
  return end < n ? end : n;
}

__global__ void compact_count_kernel(const int* __restrict__ mask, int64_t n,
                                     int log_tile,
                                     int64_t* __restrict__ counts) {
  __shared__ int warp_total[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_tile;
  const int64_t end = tile_end(base, log_tile, n);
  int c = 0;
  for (int64_t i = base + threadIdx.x; i < end; i += kThreads) {
    c += mask[i] != 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(~0u, c, off);
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_total[w];
    counts[blockIdx.x] = total;
  }
}

// inclusive[t] is the number of kept rows in tiles 0..t.  Templated on the
// plane count so the planes' pointers stay in registers.
template <int P>
__global__ void compact_write_kernel(const int* __restrict__ mask, int64_t n,
                                     int log_tile,
                                     const int64_t* __restrict__ inclusive,
                                     Planes planes) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_tile;
  const int64_t end = tile_end(base, log_tile, n);
  int64_t out = blockIdx.x == 0 ? 0 : inclusive[blockIdx.x - 1];
  const unsigned below = (1u << lane) - 1;
  for (int64_t r0 = base; r0 < end; r0 += kThreads) {
    const int64_t i = r0 + threadIdx.x;
    const bool keep = i < end && mask[i] != 0;
    const unsigned ballot = __ballot_sync(~0u, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    if (keep) {
      const int64_t dst = out + before + __popc(ballot & below);
#pragma unroll
      for (int p = 0; p < P; ++p) planes.out[p][dst] = planes.in[p][i];
    }
    out += round_total;
    __syncthreads();  // warp_count is rewritten by the next round
  }
}

template <int P>
cudaError_t compact_write(const int* mask, int64_t n, int log_tile,
                          const int64_t* inclusive, const Planes& planes,
                          cudaStream_t stream) {
  const int64_t tiles = ((n - 1) >> log_tile) + 1;
  compact_write_kernel<P><<<static_cast<unsigned>(tiles), kThreads, 0,
                            stream>>>(mask, n, log_tile, inclusive, planes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int radx_compact_count(void* mask, int64_t n, int64_t log_tile, void* counts,
                       void* stream) {
  const int64_t tiles = ((n - 1) >> log_tile) + 1;
  compact_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask), n, static_cast<int>(log_tile),
      static_cast<int64_t*>(counts));
  return cudaGetLastError();
}

// ins / outs: arrays of num_planes device pointers (host memory).
int radx_compact_write(void* mask, int64_t n, int64_t log_tile,
                       void* inclusive, void** ins, void** outs,
                       int64_t num_planes, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes) return cudaErrorInvalidValue;
  Planes planes = {};
  for (int p = 0; p < num_planes; ++p) {
    planes.in[p] = static_cast<const int*>(ins[p]);
    planes.out[p] = static_cast<int*>(outs[p]);
  }
  const int* m = static_cast<const int*>(mask);
  const int lt = static_cast<int>(log_tile);
  const int64_t* inc = static_cast<const int64_t*>(inclusive);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_planes) {
    case 1: return compact_write<1>(m, n, lt, inc, planes, s);
    case 2: return compact_write<2>(m, n, lt, inc, planes, s);
    case 3: return compact_write<3>(m, n, lt, inc, planes, s);
    default: return compact_write<4>(m, n, lt, inc, planes, s);
  }
}

}  // extern "C"
