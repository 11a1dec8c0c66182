// Merge of two ascending runs of int32 planes for Hopper (sm_90a).
//
// No Pallas kernel has this job.  The JAX package's distributed sort
// (radx_tpu/parallel/dist_sort.py:112-126, :200-222) merges the runs a
// shard receives with the bitonic network's run merge over slots of a fixed
// size, padded with sentinels, because XLA needs static shapes.  The port
// sends each run at its own length and merges two runs of any lengths,
// 0 included, with this kernel: the sorted union, the function the network
// computed over the padded slots.
//
// Rows are P = 1..4 int32 planes, plane 0 the sign-biased key.  The order
// is the key's (NCMP = 1) or (key, plane 1)'s, both as signed int32
// (NCMP = 2: the stable sorts' global index).  Planes past NCMP ride along.
// On equal compare planes A's row comes first.  The store XORs `key_xor`
// into plane 0 (the last merge of the sort un-biases its keys there).
//
// Bound on the card: device-memory bandwidth.  Each row of each plane is
// read once and written once.  What held the first version (a path launch,
// then one block a 2048-row tile) below half of that bound: a binary search
// of ~27 dependent device-memory loads a tile boundary in its own launch;
// 4-byte loads with nothing of the next tile in flight; 8 rows a thread, so
// the write-back to shared memory was an 8-way bank conflict.
//
// This design (merge path: Odeh et al., "Merge Path - Parallel Merging Made
// Simple", 2012; ModernGPU's odd rows a thread) is one launch:
//   * a persistent grid (as many blocks as fit on the card at once); block b
//     owns a contiguous range of output tiles of kTile = 256 x VT rows;
//   * the block finds the splits of its range's two ends itself: 128 threads
//     a diagonal probe 128 points of it a round (__syncthreads_count): 4
//     rounds of one device-memory load at 2^27 rows instead of 27 dependent
//     loads;
//   * it streams both runs through a ring in shared memory: 16-byte cp.async
//     loads of the aligned-down superset of each window (a row lies in the
//     ring slot of its address, so a group lands aligned whatever row the run
//     starts at), two tiles ahead: the next tile's rows load while this one
//     merges, and every row is read once;
//   * each tile's end split is the last thread's position after its serial
//     merge: no search in device memory after the block's first;
//   * VT (15 for one plane, 7 for two to four) is odd, so the write-back
//     of a thread's VT rows to the stage in output order is free of bank
//     conflicts; the stage is stored with 16-byte stores (scalar ones at a
//     misaligned head and tail).  Of VT = 7 and 15, each plane count keeps
//     the faster on the card: with more planes the 15-row tiles' rings
//     leave one block an SM (and four planes' do not fit).
// Row counts and offsets are int64: a card can hold 2^31 output rows.
// Shared memory (dynamic): 2 x P x kRing + min(P, 2) x (kTile + 4) words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProbes = kThreads / 2;  // threads a boundary search
constexpr int kMaxPlanes = 4;
constexpr int kMaxDevices = 64;

struct Runs {
  const int* a[kMaxPlanes];
  const int* b[kMaxPlanes];
  int* out[kMaxPlanes];
  int64_t na;
  int64_t nb;
  int key_xor;
};

// A tile's rows, and the ring's: the next tile's window (one tile) and the
// one after it (another) must fit beside the rows being merged, and the
// 16-byte groups round each end out by up to 3 rows.
constexpr int ring_rows(int tile) {
  int r = 4;
  while (r < 2 * tile + 8) r *= 2;
  return r;
}

template <int P, int VT>
struct Geometry {
  static constexpr int kTile = kThreads * VT;
  static constexpr int kRing = ring_rows(kTile);
  static constexpr int kStagePlanes = P < 2 ? P : 2;
  static constexpr int kStage = kTile + 4;  // a misaligned start shifts by <= 3
  static constexpr size_t kBytes =
      sizeof(int) * (size_t{2} * P * kRing + size_t{kStagePlanes} * kStage);
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

// Rows past the last 16-byte boundary of a plane's address.
__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every group but the newest `N` of this thread has landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int64_t upto(int64_t x, int64_t end) {
  return x < end ? x : end;
}

// Ask for rows [from, to) of a run of n rows (to <= n) into its ring, all
// threads together.  A plane's row x has the address index u = x + m (m its
// misalignment) and lands in ring slot u mod RING: the 16-byte group u / 4
// is one cp.async whenever all its rows lie in the run, else one per row
// that does.  `first`: the group that holds row `from` is asked for too;
// otherwise the fill that asked for rows up to `from` brought it.
template <int P, int RING>
__device__ __forceinline__ void fill(const int* const* planes, int64_t n,
                                     int64_t from, int64_t to, bool first,
                                     int* ring) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int m = misalign(planes[p]);
    const int64_t u0 = (from + m + (first ? 0 : 3)) & ~int64_t{3};
    const int64_t u1 = (to + m + 3) & ~int64_t{3};
    int* rp = ring + p * RING;
    for (int64_t u = u0 + 4 * threadIdx.x; u < u1; u += 4 * kThreads) {
      const int64_t x = u - m;
      int* dst = rp + (u & (RING - 1));
      if (x >= 0 && x + 4 <= n) {
        cp_async16(dst, planes[p] + x);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x + e >= 0 && x + e < n) cp_async4(dst + e, planes[p] + x + e);
        }
      }
    }
  }
}

// The splits of the output diagonals d_lo and d_hi (A's rows among the
// first d output rows), each found by kProbes threads: a round probes
// kProbes evenly spaced points of the range left and keeps the gap between
// the last one that takes A's row and the first that does not.
template <int NCMP>
__device__ void block_splits(const Runs& r, int64_t d_lo, int64_t d_hi,
                             int64_t* s_split, int64_t& s_lo,
                             int64_t& s_hi) {
  const int half = threadIdx.x >= kProbes;
  const int k = static_cast<int>(threadIdx.x) - half * kProbes;
  const int64_t d = half ? d_hi : d_lo;
  int64_t lo = d > r.nb ? d - r.nb : 0;
  int64_t hi = d < r.na ? d : r.na;
  while (!__syncthreads_and(lo == hi)) {
    const int64_t len = hi - lo;
    const int64_t step = (len + kProbes - 1) / kProbes;
    const int64_t p = lo + k * step;
    bool takes_a = false;
    if (len > 0 && p < hi) {
      const int64_t q = d - 1 - p;
      int ta = 0, tb = 0;
      if constexpr (NCMP == 2) {
        ta = __ldg(r.a[1] + p);
        tb = __ldg(r.b[1] + q);
      }
      takes_a = a_first<NCMP>(__ldg(r.a[0] + p), ta, __ldg(r.b[0] + q), tb);
    }
    // the probes that take A's row are a prefix: count them
    const int c_lo = __syncthreads_count(takes_a && !half);
    const int c_hi = __syncthreads_count(takes_a && half);
    const int c = half ? c_hi : c_lo;
    if (len > 0) {
      if (c == 0) {
        hi = lo;
      } else {
        const int64_t last = lo + (c - 1) * step;
        hi = last + step < hi ? last + step : hi;
        lo = last + 1;
      }
    }
  }
  if (k == 0) s_split[half] = lo;
  __syncthreads();
  s_lo = s_split[0];
  s_hi = s_split[1];
}

template <int NCMP, int P, int VT>
__global__ void __launch_bounds__(kThreads)
    merge_runs_kernel(Runs r, int64_t tiles) {
  using G = Geometry<P, VT>;
  constexpr int T = G::kTile;
  constexpr int RING = G::kRing;
  constexpr int M = RING - 1;
  extern __shared__ int4 smem4[];
  int* ring_a = reinterpret_cast<int*>(smem4);  // [P][RING]
  int* ring_b = ring_a + P * RING;              // [P][RING]
  int* stage = ring_b + P * RING;               // [kStagePlanes][kStage]
  __shared__ int64_t s_split[2];
  __shared__ int s_took;

  // this block's output tiles [t0, t1): rows [d_begin, d_end)
  const int64_t n = r.na + r.nb;
  const int64_t t0 = int64_t{blockIdx.x} * tiles / gridDim.x;
  const int64_t t1 = (int64_t{blockIdx.x} + 1) * tiles / gridDim.x;
  const int64_t d_begin = t0 * T;
  const int64_t d_end = t1 * T < n ? t1 * T : n;
  int64_t ia, ia_end;
  block_splits<NCMP>(r, d_begin, d_end, s_split, ia, ia_end);
  int64_t jb = d_begin - ia;
  const int64_t jb_end = d_end - ia_end;

  // the first tile's windows, then the next tile's: each run's rows up to
  // a tile past its position, then two (the block's own rows only)
  int64_t fa = upto(ia + T, ia_end);
  int64_t fb = upto(jb + T, jb_end);
  fill<P, RING>(r.a, r.na, ia, fa, true, ring_a);
  fill<P, RING>(r.b, r.nb, jb, fb, true, ring_b);
  cp_async_commit();
  {
    const int64_t ta = upto(ia + 2 * T, ia_end);
    const int64_t tb = upto(jb + 2 * T, jb_end);
    fill<P, RING>(r.a, r.na, fa, ta, false, ring_a);
    fill<P, RING>(r.b, r.nb, fb, tb, false, ring_b);
    cp_async_commit();
    fa = ta;
    fb = tb;
  }

  int ma[P], mb[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ma[p] = misalign(r.a[p]);
    mb[p] = misalign(r.b[p]);
  }

  for (int64_t d0 = d_begin; d0 < d_end; d0 += T) {
    cp_async_wait<1>();
    __syncthreads();
    const int len = static_cast<int>(d_end - d0 < T ? d_end - d0 : T);
    const int na_av = static_cast<int>(ia_end - ia < T ? ia_end - ia : T);
    const int nb_av = static_cast<int>(jb_end - jb < T ? jb_end - jb : T);
    // ring slot of the window's row x: (x + off[p]) & M
    int offa[P], offb[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      offa[p] = static_cast<int>((ia + ma[p]) & M);
      offb[p] = static_cast<int>((jb + mb[p]) & M);
    }
    auto at_a = [&](int p, int x) {
      return ring_a[p * RING + ((x + offa[p]) & M)];
    };
    auto at_b = [&](int p, int x) {
      return ring_b[p * RING + ((x + offb[p]) & M)];
    };
    // the tie plane (NCMP = 2) of a window's row, else 0
    auto tie_a = [&](int x) {
      if constexpr (NCMP == 2) return at_a(1, x);
      return 0;
    };
    auto tie_b = [&](int x) {
      if constexpr (NCMP == 2) return at_b(1, x);
      return 0;
    };

    // this thread's first row of the tile, and its split there
    const int dt = min(static_cast<int>(threadIdx.x) * VT, len);
    int lo = dt > nb_av ? dt - nb_av : 0;
    int hi = dt < na_av ? dt : na_av;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int q = dt - 1 - mid;
      if (a_first<NCMP>(at_a(0, mid), tie_a(mid), at_b(0, q), tie_b(q))) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo, j = dt - lo;
    int ka = at_a(0, i), kb = at_b(0, j);
    int ta = tie_a(i), tb = tie_b(j);

    // VT rows merged serially (rows past the tile's end are not stored)
    int v[P][VT];
#pragma unroll
    for (int k = 0; k < VT; ++k) {
      const bool take_a =
          j >= nb_av || (i < na_av && a_first<NCMP>(ka, ta, kb, tb));
      const int* run = take_a ? ring_a : ring_b;
      const int x = take_a ? i : j;
      v[0][k] = take_a ? ka : kb;
      if constexpr (NCMP == 2) v[1][k] = take_a ? ta : tb;
#pragma unroll
      for (int p = NCMP; p < P; ++p) {
        v[p][k] = run[p * RING + ((x + (take_a ? offa[p] : offb[p])) & M)];
      }
      if (dt + k < len) {
        i += take_a;
        j += !take_a;
      }
      // the next compare values of the run just taken from
      const int nx = take_a ? i : j;
      const int nk = run[(nx + (take_a ? offa[0] : offb[0])) & M];
      if (take_a) {
        ka = nk;
      } else {
        kb = nk;
      }
      if constexpr (NCMP == 2) {
        const int nt = run[RING + ((nx + (take_a ? offa[1] : offb[1])) & M)];
        if (take_a) {
          ta = nt;
        } else {
          tb = nt;
        }
      }
    }
    // the tile's end split: A's rows among its len rows
    if (dt < len && len <= dt + VT) s_took = i;
    __syncthreads();  // the windows are read: their slots may be refilled
    const int took = s_took;
    ia += took;
    jb += len - took;
    {
      const int64_t ta2 = upto(ia + 2 * T, ia_end);
      const int64_t tb2 = upto(jb + 2 * T, jb_end);
      fill<P, RING>(r.a, r.na, fa, ta2, false, ring_a);
      fill<P, RING>(r.b, r.nb, fb, tb2, false, ring_b);
      cp_async_commit();
      fa = ta2;
      fb = tb2;
    }

    // plane by plane through the stage in output order (two stage planes
    // in turn), then 16-byte stores: the stage row of output row d0 + x is
    // x + sh, sh = (d0 + misalignment) & 3, so the groups align
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int* st = stage + (p & 1) * G::kStage;
      int* o = r.out[p] + d0;
      const int sh = static_cast<int>((d0 + misalign(r.out[p])) & 3);
      const int flip = p == 0 ? r.key_xor : 0;
#pragma unroll
      for (int k = 0; k < VT; ++k) {
        if (dt + k < len) st[dt + k + sh] = v[p][k] ^ flip;
      }
      __syncthreads();
      const int groups = (len + sh + 3) >> 2;
      for (int g = threadIdx.x; g < groups; g += kThreads) {
        const int x = 4 * g - sh;
        if (x >= 0 && x + 4 <= len) {
          *reinterpret_cast<int4*>(o + x) =
              *reinterpret_cast<const int4*>(st + 4 * g);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (x + e >= 0 && x + e < len) o[x + e] = st[4 * g + e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

int64_t tiles_of(int64_t n, int tile) { return (n + tile - 1) / tile; }

template <int NCMP, int P, int VT>
int launch_merge(const Runs& r, cudaStream_t s) {
  using G = Geometry<P, VT>;
  auto kernel = merge_runs_kernel<NCMP, P, VT>;
  // the blocks the card holds at once, found once a device (0: unknown)
  static int resident[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  if (resident[dev] < 1) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::kBytes));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, G::kBytes);
    }
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int64_t tiles = tiles_of(r.na + r.nb, G::kTile);
  const int64_t cap = resident[dev];
  const unsigned blocks = static_cast<unsigned>(tiles < cap ? tiles : cap);
  kernel<<<blocks, kThreads, G::kBytes, s>>>(r, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Rows a thread (kernels/merge.py ITEMS).
constexpr int items_of(int planes) { return planes == 1 ? 15 : 7; }

template <int NCMP>
int launch_planes(const Runs& r, int64_t np, cudaStream_t s) {
  switch (np) {
    case 1:
      if constexpr (NCMP == 1) return launch_merge<1, 1, items_of(1)>(r, s);
      return cudaErrorInvalidValue;
    case 2: return launch_merge<NCMP, 2, items_of(2)>(r, s);
    case 3: return launch_merge<NCMP, 3, items_of(3)>(r, s);
    default: return launch_merge<NCMP, 4, items_of(4)>(r, s);
  }
}

}  // namespace

extern "C" {

// a / b: host arrays of np device pointers, the planes of runs of na and nb
// rows (either may be 0, not both); out: np device pointers of na + nb rows
// each (no overlap with a or b).
int radx_merge_runs(void* const* a, int64_t na, void* const* b, int64_t nb,
                    void* const* out, int64_t np, int64_t ncmp,
                    int64_t key_xor, void* stream) {
  if (np < 1 || np > kMaxPlanes || ncmp < 1 || ncmp > 2 || np < ncmp ||
      na < 0 || nb < 0 || na + nb < 1 || na + nb > (int64_t{1} << 31)) {
    return cudaErrorInvalidValue;
  }
  Runs r{};
  for (int p = 0; p < np; ++p) {
    r.a[p] = static_cast<const int*>(a[p]);
    r.b[p] = static_cast<const int*>(b[p]);
    r.out[p] = static_cast<int*>(out[p]);
  }
  r.na = na;
  r.nb = nb;
  r.key_xor = static_cast<int>(key_xor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ncmp == 1 ? launch_planes<1>(r, np, s) : launch_planes<2>(r, np, s);
}

}  // extern "C"
