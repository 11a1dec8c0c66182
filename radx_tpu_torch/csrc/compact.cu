// Stable mask compaction for Hopper (sm_90a): the port of
// radx_tpu/kernels/compact.py::_compact_chunk_kernel (:54) and of the XLA
// stitch after it (compact_flat, :229-243), in one pass.
//
// Input: a mask of n rows, one byte (bool / uint8) or four (int32) a row,
// nonzero = keep, and P int32 planes of n rows (P <= kMaxPlanes); with
// n_valid (a 0-d int32 on the card: LazyTable's row count) only the rows
// below it may be kept, read on the device, so no host sync.  Output:
// P planes of n rows whose first `count` rows are the kept rows in their
// original order (the rows after them are not written: the caller
// allocates them, their contents are not part of the result), and `count`
// itself, a 0-d int32 on the card.
//
// The TPU compacts each chunk in VMEM and stitches the chunks' prefixes with
// a serial loop over its ordered grid.  Blocks on a GPU run in no order, so
// the stitch becomes a decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back"):
//
//   * tiles of kThreads x kItems = 4096 rows (of 2^10..2^13 the one
//     nearest the fastest on every shape the paths give it);
//     a block takes its tile from an atomic counter, so every tile it waits on belongs to a block already running
//     (no deadlock, whatever the grid and residency);
//   * each warp owns 32 x kItems consecutive rows: in round j lane l holds
//     rows 4 (32 j + l) .. +3 of them, one 16-byte vector of an int32 plane
//     (scalar loads where a plane is not 16-byte aligned or the tile is the
//     ragged last one); a row's rank in its warp comes from four ballots a
//     round, the warps' offsets from their counts in shared memory;
//   * the block publishes its tile's count under flag A as soon as the mask
//     is read, then loads plane 0's vectors that hold a kept row; warp 0
//     reads its predecessors' status words 32 at a time, backwards, until
//     it meets an inclusive prefix (flag P); the block publishes its own
//     prefix under P and writes each kept row at offset + rank: a warp
//     with at least kStageMin kept rows stages them in shared memory and
//     writes one contiguous run a plane, a warp with fewer writes each row
//     from its thread; the planes after the first are loaded and written
//     one at a time (a thread holds one plane's rows).  A status word is
//     the flag in its top two bits and the count below: one 64-bit store;
//   * the last tile writes the total to `count`.
//
// Bound on the card: device-memory bandwidth.  The mask is read once, a
// plane's vector only where one of its four rows is kept, and each kept row
// is written once; the status words are one 8-byte word a tile.  Offsets
// are 64-bit.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 4;
constexpr int kItems = 16;  // rows a thread
constexpr unsigned long long kFlagA = 1ull << 62;
constexpr unsigned long long kFlagP = 2ull << 62;
constexpr unsigned long long kCount = kFlagA - 1;
// kept rows of a warp from which it writes through shared memory
constexpr int kStageMin = 32;

struct Planes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
};

using StatusRef = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// Keep bits of rows r .. r+3 (bit q: row r + q); r is a multiple of 4.
// vec: all four rows exist and the mask's base is aligned for one load.
template <int MB>
__device__ __forceinline__ unsigned keep4(const void* mask, int64_t r,
                                          int64_t n, bool vec) {
  if (vec) {
    if constexpr (MB == 4) {
      const int4 m = __ldg(reinterpret_cast<const int4*>(
          static_cast<const int*>(mask) + r));
      return (m.x != 0) | (m.y != 0) << 1 | (m.z != 0) << 2 |
             (m.w != 0) << 3;
    } else {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
          static_cast<const uint8_t*>(mask) + r));
      return ((w & 0xFFu) != 0) | ((w & 0xFF00u) != 0) << 1 |
             ((w & 0xFF0000u) != 0) << 2 | ((w & 0xFF000000u) != 0) << 3;
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (r + q < n) {
      const bool k = MB == 4 ? static_cast<const int*>(mask)[r + q] != 0
                             : static_cast<const uint8_t*>(mask)[r + q] != 0;
      bits |= static_cast<unsigned>(k) << q;
    }
  }
  return bits;
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(~0u, x, off);
  return x;
}

// The kept rows of all tiles before tile t (t >= 1), by warp 0: status
// words 32 at a time, backwards from t - 1, summed up to and including the
// nearest inclusive prefix.  A window is read again while a word it needs
// is still empty.
__device__ int64_t look_back(unsigned long long* status, int64_t t) {
  const int lane = threadIdx.x & 31;
  int64_t base = t - 1;
  int64_t prefix = 0;
  while (true) {
    const int64_t u = base - lane;
    // past tile 0: a prefix of 0 (tile 0 publishes P, so it ends the walk)
    const unsigned long long w = u >= 0 ? StatusRef(status[u]).load(
        cuda::memory_order_relaxed) : kFlagP;
    const unsigned valid = __ballot_sync(~0u, w != 0);
    const unsigned halt = __ballot_sync(~0u, (w & kFlagP) != 0);
    if (halt) {
      const int h = __ffs(halt) - 1;
      const unsigned upto = h == 31 ? ~0u : (2u << h) - 1;
      if ((valid & upto) == upto) {
        return prefix + warp_sum(lane <= h ? static_cast<int64_t>(w & kCount)
                                           : 0);
      }
    } else if (valid == ~0u) {
      prefix += warp_sum(static_cast<int64_t>(w & kCount));
      base -= 32;
    }
  }
}

// MB: mask bytes a row (1 or 4).  scratch: the tile counter, then one
// status word a tile, all zero at launch.
template <int P, int MB>
__global__ void __launch_bounds__(kThreads) compact_kernel(
    const void* __restrict__ mask, bool vec_mask, int64_t n,
    const int* __restrict__ n_valid, Planes planes, unsigned vec_planes,
    unsigned long long* __restrict__ scratch, int* __restrict__ count) {
  constexpr int V = kItems / 4;  // rounds of 4-row vectors
  constexpr int kTile = kThreads * kItems;
  constexpr int kWarpRows = 32 * kItems;
  __shared__ int64_t s_tile;
  __shared__ int64_t s_offset;
  __shared__ int s_warp_count[kWarps];
  __shared__ int s_stage[kWarps * kWarpRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0) s_tile = static_cast<int64_t>(atomicAdd(scratch, 1ull));
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t tiles = (n + kTile - 1) / kTile;
  // rows at or past lim are not kept
  int64_t lim = n;
  if (n_valid != nullptr) {
    const int64_t v = *n_valid;
    lim = v < 0 ? 0 : (v < n ? v : n);
  }
  const bool full = (t + 1) * kTile <= lim;
  const int64_t wbase = t * kTile + static_cast<int64_t>(warp) * kWarpRows;

  // keep bits: bit 4 j + q is row wbase + 4 (32 j + lane) + q
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    bits |= keep4<MB>(mask, wbase + 4 * (32 * j + lane), lim, full && vec_mask)
            << (4 * j);
  }
  // ranks in the warp: kept rows before round j's row of this lane
  const unsigned below = (1u << lane) - 1;
  int before[V];
  int wcount = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int b = 0;
    int c = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned ballot = __ballot_sync(~0u, (bits >> (4 * j + q)) & 1);
      b += __popc(ballot & below);
      c += __popc(ballot);
    }
    before[j] = wcount + b;
    wcount += c;
  }
  if (lane == 0) s_warp_count[warp] = wcount;
  __syncthreads();
  int wprefix = 0;
  int tile_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp_count[w];
    wprefix += w < warp ? c : 0;
    tile_count += c;
  }
  if (threadIdx.x == 0) {
    StatusRef(status[t]).store((t == 0 ? kFlagP : kFlagA) | tile_count,
                               cuda::memory_order_relaxed);
  }

  // a plane's vectors that hold a kept row (plane 0's are in flight during
  // the look-back; one plane at a time keeps the registers few)
  int vals[kItems];
  auto load_plane = [&](int p) {
    const bool vec = full && ((vec_planes >> p) & 1);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const unsigned b4 = (bits >> (4 * j)) & 15;
      const int* src = planes.in[p] + wbase + 4 * (32 * j + lane);
      if (vec && b4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(src));
        vals[4 * j] = x.x;
        vals[4 * j + 1] = x.y;
        vals[4 * j + 2] = x.z;
        vals[4 * j + 3] = x.w;
      } else if (!vec) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((b4 >> q) & 1) vals[4 * j + q] = src[q];
        }
      }
    }
  };
  load_plane(0);

  if (t == 0) {
    if (threadIdx.x == 0) s_offset = 0;
  } else if (warp == 0) {
    const int64_t prefix = look_back(status, t);
    if (lane == 0) {
      StatusRef(status[t]).store(kFlagP | (prefix + tile_count),
                                 cuda::memory_order_relaxed);
      s_offset = prefix;
    }
  }
  __syncthreads();
  const int64_t out = s_offset + wprefix;
  if (threadIdx.x == 0 && t == tiles - 1) {
    *count = static_cast<int>(s_offset + tile_count);
  }
  // A warp with many kept rows stages them in shared memory and writes one
  // contiguous run a plane; a warp with few writes each row from its thread.
  int* stage = s_stage + warp * kWarpRows;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p > 0) load_plane(p);
    if (wcount >= kStageMin) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const unsigned b4 = (bits >> (4 * j)) & 15;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((b4 >> q) & 1) {
            stage[before[j] + __popc(b4 & ((1u << q) - 1))] = vals[4 * j + q];
          }
        }
      }
      __syncwarp();
      for (int i = lane; i < wcount; i += 32) planes.out[p][out + i] = stage[i];
      __syncwarp();
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const unsigned b4 = (bits >> (4 * j)) & 15;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((b4 >> q) & 1) {
            planes.out[p][out + before[j] + __popc(b4 & ((1u << q) - 1))] =
                vals[4 * j + q];
          }
        }
      }
    }
  }
}

struct Args {
  const void* mask;
  bool vec_mask;
  int64_t n;
  const int* n_valid;
  Planes planes;
  unsigned vec_planes;
  unsigned long long* scratch;
  int* count;
};

template <int P, int MB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int64_t kTile = kThreads * kItems;
  const unsigned tiles = static_cast<unsigned>((a.n + kTile - 1) / kTile);
  compact_kernel<P, MB><<<tiles, kThreads, 0, stream>>>(
      a.mask, a.vec_mask, a.n, a.n_valid, a.planes, a.vec_planes, a.scratch,
      a.count);
  return cudaGetLastError();
}

template <int P>
cudaError_t by_mask(int mask_bytes, const Args& a, cudaStream_t s) {
  switch (mask_bytes) {
    case 1: return launch<P, 1>(a, s);
    case 4: return launch<P, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// mask: n rows of mask_bytes (1 or 4) each; n_valid: a device int32 or
// null; ins / outs: host arrays of num_planes device pointers;
// scratch: (ceil(n / 4096) + 1) zeroed 64-bit words; count: one int32.
int radx_compact(void* mask, int64_t mask_bytes, int64_t n, void* n_valid,
                 void** ins, void** outs, int64_t num_planes, void* scratch,
                 void* count, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes || n < 1) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.mask = mask;
  a.vec_mask = aligned(mask, mask_bytes == 4 ? 16 : 4);
  a.n = n;
  a.n_valid = static_cast<const int*>(n_valid);
  for (int p = 0; p < num_planes; ++p) {
    a.planes.in[p] = static_cast<const int*>(ins[p]);
    a.planes.out[p] = static_cast<int*>(outs[p]);
    a.vec_planes |= static_cast<unsigned>(aligned(ins[p], 16)) << p;
  }
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.count = static_cast<int*>(count);
  const int mb = static_cast<int>(mask_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_planes) {
    case 1: return by_mask<1>(mb, a, s);
    case 2: return by_mask<2>(mb, a, s);
    case 3: return by_mask<3>(mb, a, s);
    default: return by_mask<4>(mb, a, s);
  }
}

}  // extern "C"
