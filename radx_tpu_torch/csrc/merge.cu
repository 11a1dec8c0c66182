// Merge of two ascending runs of int32 planes for Hopper (sm_90a).
//
// No Pallas kernel has this job.  The JAX package's distributed sort
// (radx_tpu/parallel/dist_sort.py:112-126, :200-222) merges the runs a
// shard receives with the bitonic network's run merge over slots of a fixed
// size, padded with sentinels, because XLA needs static shapes.  The port
// sends each run at its own length and merges two runs of any lengths,
// 0 included, with these kernels: the sorted union, the function the
// network computed over the padded slots.
//
// Rows are P = 1..4 int32 planes, plane 0 the sign-biased key.  The order
// is the key's (NCMP = 1) or (key, plane 1)'s, both as signed int32
// (NCMP = 2: the stable sorts' global index).  Planes past NCMP ride along.
// On equal compare planes A's row comes first.  The store XORs `key_xor`
// into plane 0 (the last merge of the sort un-biases its keys there).
//
// Bound on the card: device-memory bandwidth.  Each row of each plane is
// read once and written once; the splits cost a few searches a tile.
//
// Merge path (Odeh et al., "Merge Path - Parallel Merging Made Simple",
// 2012).  The output of na + nb rows is cut into tiles of kTile rows.
//   path  one thread a tile boundary d = t * kTile: a binary search on the
//         cross-diagonal i + j = d for the split (i, j): i rows of A and
//         j = d - i rows of B precede output row d.  Written as i (int64).
//   merge one block a tile: A[i0, i1) and B[j0, j1) (kTile rows together)
//         are loaded into shared memory with coalesced loads; thread t
//         searches its own diagonal t * kItems in shared memory, merges its
//         kItems rows serially into registers, writes them back to shared
//         memory at their output positions, and the block stores the tile
//         with coalesced stores.
// Row counts and offsets are int64: a card can hold 2^31 output rows.
// Shared memory: kTile x P x 4 bytes = 32 KB at P = 4 (static).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // output rows a thread
constexpr int kTile = kThreads * kItems;
constexpr int kPathThreads = 256;
constexpr int kMaxPlanes = 4;

struct Runs {
  const int* a[kMaxPlanes];
  const int* b[kMaxPlanes];
  int* out[kMaxPlanes];
  int64_t na;
  int64_t nb;
  int key_xor;
};

// Row (ka, ia) goes before row (kb, ib): A's on a tie.
template <int NCMP>
__device__ __forceinline__ bool a_first(int ka, int ia, int kb, int ib) {
  if constexpr (NCMP == 1) {
    return ka <= kb;
  } else {
    return ka < kb || (ka == kb && ia <= ib);
  }
}

// The split of diagonal d over runs a (na rows) and b (nb rows): the
// number of A rows among the first d output rows.  ra(i, key, tie) /
// rb(j, key, tie) read the compare values of a row of a / b.
template <int NCMP, typename RowA, typename RowB>
__device__ __forceinline__ int64_t split_of(int64_t d, int64_t na, int64_t nb,
                                            const RowA& ra, const RowB& rb) {
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    int ka, ia, kb, ib;
    ra(mid, ka, ia);
    rb(d - 1 - mid, kb, ib);
    if (a_first<NCMP>(ka, ia, kb, ib)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int NCMP>
__global__ void __launch_bounds__(kPathThreads)
    merge_path_kernel(Runs r, int64_t tiles, int64_t* __restrict__ split) {
  const int64_t t = int64_t{blockIdx.x} * kPathThreads + threadIdx.x;
  if (t > tiles) return;
  const int64_t n = r.na + r.nb;
  const int64_t d = t * kTile < n ? t * kTile : n;
  auto row = [](const int* const* planes, int64_t x, int& k, int& tie) {
    k = __ldg(planes[0] + x);
    if constexpr (NCMP == 2) {
      tie = __ldg(planes[1] + x);
    } else {
      tie = 0;
    }
  };
  auto ra = [&](int64_t i, int& k, int& tie) { row(r.a, i, k, tie); };
  auto rb = [&](int64_t j, int& k, int& tie) { row(r.b, j, k, tie); };
  split[t] = split_of<NCMP>(d, r.na, r.nb, ra, rb);
}

template <int NCMP, int P>
__global__ void __launch_bounds__(kThreads)
    merge_runs_kernel(Runs r, const int64_t* __restrict__ split) {
  __shared__ int s[P][kTile];
  const int64_t n = r.na + r.nb;
  const int64_t d0 = int64_t{blockIdx.x} * kTile;
  const int64_t d1 = d0 + kTile < n ? d0 + kTile : n;
  const int64_t i0 = split[blockIdx.x];
  const int64_t i1 = split[blockIdx.x + 1];
  const int64_t j0 = d0 - i0;
  const int la = static_cast<int>(i1 - i0);
  const int len = static_cast<int>(d1 - d0);
  const int lb = len - la;

  // A's rows, then B's, each plane in its own shared row
  for (int x = threadIdx.x; x < len; x += kThreads) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      s[p][x] = x < la ? __ldg(r.a[p] + i0 + x) : __ldg(r.b[p] + j0 + x - la);
    }
  }
  __syncthreads();

  // this thread's first output row of the tile, and its split there
  const int dt = min(static_cast<int>(threadIdx.x) * kItems, len);
  auto at = [&](int64_t x, int& k, int& tie) {
    k = s[0][x];
    if constexpr (NCMP == 2) {
      tie = s[1][x];
    } else {
      tie = 0;
    }
  };
  auto sa = [&](int64_t i, int& k, int& tie) { at(i, k, tie); };
  auto sb = [&](int64_t j, int& k, int& tie) { at(la + j, k, tie); };
  int i = static_cast<int>(split_of<NCMP>(dt, la, lb, sa, sb));
  int j = dt - i;
  int v[P][kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bool take_a = j >= lb;
    if (!take_a && i < la) {
      int ka, ia, kb, ib;
      at(i, ka, ia);
      at(la + j, kb, ib);
      take_a = a_first<NCMP>(ka, ia, kb, ib);
    }
    // rows past the tile's end read row 0 and are never stored
    const int src = dt + k >= len ? 0 : take_a ? i : la + j;
#pragma unroll
    for (int p = 0; p < P; ++p) v[p][k] = s[p][src];
    if (dt + k < len) {
      i += take_a;
      j += !take_a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (dt + k < len) {
#pragma unroll
      for (int p = 0; p < P; ++p) s[p][dt + k] = v[p][k];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < len; x += kThreads) {
    r.out[0][d0 + x] = s[0][x] ^ r.key_xor;
#pragma unroll
    for (int p = 1; p < P; ++p) r.out[p][d0 + x] = s[p][x];
  }
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

bool make_runs(void* const* a, int64_t na, void* const* b, int64_t nb,
               void* const* out, int64_t np, int64_t ncmp, Runs* r) {
  if (np < 1 || np > kMaxPlanes || ncmp < 1 || ncmp > 2 || np < ncmp ||
      na < 0 || nb < 0 || na + nb < 1 ||
      tiles_of(na + nb) >= (int64_t{1} << 31)) {
    return false;
  }
  *r = Runs{};
  for (int p = 0; p < np; ++p) {
    r->a[p] = static_cast<const int*>(a[p]);
    r->b[p] = static_cast<const int*>(b[p]);
    r->out[p] = out == nullptr ? nullptr : static_cast<int*>(out[p]);
  }
  r->na = na;
  r->nb = nb;
  return true;
}

template <int NCMP, int P>
int launch_merge(const Runs& r, const int64_t* split, cudaStream_t s) {
  merge_runs_kernel<NCMP, P>
      <<<static_cast<unsigned>(tiles_of(r.na + r.nb)), kThreads, 0, s>>>(
          r, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a / b: host arrays of np device pointers, the planes of runs of na and nb
// rows (either may be 0, not both); split: tiles + 1 int64 on the card,
// tiles = ceil((na + nb) / kTile).  Only the ncmp compare planes are read.
int radx_merge_path(void* const* a, int64_t na, void* const* b, int64_t nb,
                    int64_t np, int64_t ncmp, void* split, void* stream) {
  Runs r;
  if (!make_runs(a, na, b, nb, nullptr, np, ncmp, &r)) {
    return cudaErrorInvalidValue;
  }
  const int64_t tiles = tiles_of(na + nb);
  const unsigned blocks =
      static_cast<unsigned>((tiles + kPathThreads) / kPathThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* sp = static_cast<int64_t*>(split);
  if (ncmp == 1) {
    merge_path_kernel<1><<<blocks, kPathThreads, 0, s>>>(r, tiles, sp);
  } else {
    merge_path_kernel<2><<<blocks, kPathThreads, 0, s>>>(r, tiles, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: host array of np device pointers, na + nb rows each (no overlap with
// a or b); split: what radx_merge_path wrote for the same runs.
int radx_merge_runs(void* const* a, int64_t na, void* const* b, int64_t nb,
                    void* const* out, int64_t np, int64_t ncmp,
                    int64_t key_xor, void* split, void* stream) {
  Runs r;
  if (!make_runs(a, na, b, nb, out, np, ncmp, &r)) {
    return cudaErrorInvalidValue;
  }
  r.key_xor = static_cast<int>(key_xor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* sp = static_cast<const int64_t*>(split);
  if (ncmp == 1) {
    switch (np) {
      case 1: return launch_merge<1, 1>(r, sp, s);
      case 2: return launch_merge<1, 2>(r, sp, s);
      case 3: return launch_merge<1, 3>(r, sp, s);
      default: return launch_merge<1, 4>(r, sp, s);
    }
  }
  switch (np) {
    case 2: return launch_merge<2, 2>(r, sp, s);
    case 3: return launch_merge<2, 3>(r, sp, s);
    default: return launch_merge<2, 4>(r, sp, s);
  }
}

}  // extern "C"
