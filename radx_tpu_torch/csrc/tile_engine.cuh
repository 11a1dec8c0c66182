// The register tile engine of the bitonic kernels (csrc/bitonic.cu), shared
// with the first loads and last stores of a sort (csrc/bitonic_io.cu): the
// engine's phases, the row -> address maps of a tile pass's first load and
// last store, the plans laid out at compile time (top_pass), and the host
// helpers that check a plan and launch a tile pass.  csrc/bitonic.cu's
// header comment describes the network and the kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "planes.cuh"

namespace {

constexpr int kStaticSmemBytes = 48 * 1024;
constexpr int kCyclicLog = 10;  // block-cyclic tile: 1024 keys (JAX t_rows=8)

// log2 of the rows a thread holds in the register tile engine at P planes:
// 2^R * P values live in registers per thread, at most 48 (no spills;
// ptxas report in PERF.md).  Kept in step with bitonic.py::max_fusion.
__host__ __device__ constexpr int max_fusion(int np) {
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

// ---------------------------------------------------------------------------
// The register tile engine of chunk_sort, cross_stage, finish,
// chunk_sort_cyclic and slot_merge.
//
// A tile pass runs merge levels over one tile of 2^log_t rows in one block.
// Each thread holds W = 2^R rows of every plane in registers, R =
// max_fusion(P) (2^R * P <= 48 values), and the pass is cut into phases by
// a plan the host computes (kernels/bitonic.py::tile_plan; tile_pass reads
// it, top_pass lays the plans of the modes' own tiles out at compile
// time).  In a phase a thread holds the rows whose tile indices differ
// only in bits wlo .. wlo+R-1 and runs there, without synchronisation,
// every substage of the phase (index bits lo..hi of levels kk_a..kk_b);
// between two phases the tile goes once through shared memory: store,
// __syncthreads(), load in the next phase's layout.  The first phase reads
// device memory through a row -> address map (the tile itself for
// chunk_sort / finish, the cyclic tiles of a radix chunk, the reversed odd
// slots, the strided segments of a cross pass) and the last one writes it
// through a map of its own: the tile contiguously, in place or to other
// planes, or the segments in place.  A finish tile of 2^14 rows at R = 4
// runs bits {13..10}, {9..6}, {5..2}, {1, 0}: 3 round trips where a loop of
// one substage per round trip made 14; a 2^14 chunk runs stages 1..4 in
// registers at load time, then ceil(kk / 4) phases for each stage kk > 4:
// 28 round trips where the loop made 105.
//
// The network is the plain one: the same pairs in the same order, the same
// direction rule (bit kk of (gbase & dmask) + row, then `invert`) and the
// same tie-safe exchange, so the output is bit-equal to the plain versions.
//
// Shared memory is swizzled: row i of a plane lives at i ^ ((i >> R) & 31).
// In a phase whose register bits are the low ones (wlo = 0), neighbouring
// lanes hold rows 2^R apart, a 2^R-way bank conflict in a plain layout;
// the XOR moves the lane bits above the register window onto the bank bits,
// so every phase's loads and stores are conflict-free (the map from a
// warp's lanes to banks is triangular with a unit diagonal for every wlo).
// Where a thread's rows are contiguous in device memory (wlo = 0: the
// first phase of a chunk sort, the last phase of every pass), the map keeps
// them contiguous and every plane is 16-byte aligned, they move as int4
// vectors.
// ---------------------------------------------------------------------------

constexpr int kMaxPhases = 64;

// Threads per block of a tile pass (more groups than threads: a thread
// takes several in turn).  A tile's planes in shared memory leave few
// blocks per SM (three of 64 KB); small blocks let one block's device-memory
// loads overlap another's register phases.  The launch bound names one
// block per SM as the minimum, so ptxas may give a thread every register
// its 16-48 rows need instead of spilling them for occupancy.
constexpr int kTileThreads = 256;

struct TilePlan {
  int n;                   // phases
  int code[kMaxPhases];    // kk_a | kk_b << 6 | hi << 12 | lo << 16 | wlo << 20
};

struct Phase {
  int kk_a, kk_b, hi, lo, wlo;
};

__host__ __device__ __forceinline__ Phase decode_phase(int code) {
  return {code & 63, (code >> 6) & 63, (code >> 12) & 15, (code >> 16) & 15,
          (code >> 20) & 15};
}

__host__ __device__ constexpr int low_bit(int u) {
  return (u & 1) ? 0 : 1 + low_bit(u >> 1);
}

template <int R>
__device__ __forceinline__ int swizzle(int i) {
  return i ^ ((i >> R) & 31);
}

// The exchange of registers u < o for the pair's direction.
template <int NCMP, int P, int W>
__device__ __forceinline__ void exchange(int (&v)[P][W], int u, int o,
                                         bool up) {
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

// The substages at register bits sb_hi .. sb_lo of one level, directions
// known at compile time: register u ascends iff bit KW of u equals FLIP
// (KW = R: every register shares FLIP).  An exchange is then a min and a
// max (one plane) or one comparison and the selects.
template <int NCMP, int P, int R, int KW, int FLIP>
__device__ __forceinline__ void level_fixed(int (&v)[P][1 << R], int sb_hi,
                                            int sb_lo) {
  constexpr int W = 1 << R;
#pragma unroll
  for (int sb = R - 1; sb >= 0; --sb) {
    if (sb > sb_hi || sb < sb_lo) continue;
#pragma unroll
    for (int u = 0; u < W; ++u) {
      if (u & (1 << sb)) continue;
      exchange<NCMP, P, W>(v, u, u | (1 << sb), ((u >> KW) & 1) == FLIP);
    }
  }
}

// The same with the direction bit kw of the register index known only at
// run time: the levels whose bit kk lies inside the register window (a
// chunk's first R stages, the top phase of levels just below the tile).
template <int NCMP, int P, int R>
__device__ __forceinline__ void level_runtime(int (&v)[P][1 << R], int kw,
                                              int flip, int sb_hi,
                                              int sb_lo) {
  constexpr int W = 1 << R;
#pragma unroll
  for (int sb = R - 1; sb >= 0; --sb) {
    if (sb > sb_hi || sb < sb_lo) continue;
#pragma unroll
    for (int u = 0; u < W; ++u) {
      if (u & (1 << sb)) continue;
      exchange<NCMP, P, W>(v, u, u | (1 << sb), ((u >> kw) & 1) == flip);
    }
  }
}

// The substages of one phase in registers.  Register u holds tile row
// gb | (u << wlo).  Bit kk of a row's direction index is bit kk of the
// tile's (masked) base when kk >= log_t, else bit kk of the row: bit kk of
// gb when kk lies above the register window (one direction for the
// thread: most levels), else bit kk - wlo of u (gb is 0 there).  The
// window holds bits lo..hi < kk, so kk - wlo >= 1.
template <int NCMP, int P, int R>
__device__ __forceinline__ void phase_substages(int (&v)[P][1 << R],
                                                const Phase& f, int gb,
                                                int64_t dbase, int log_t,
                                                int invert) {
  for (int kk = f.kk_a; kk <= f.kk_b; ++kk) {
    const int sb_hi = min(f.hi, kk - 1) - f.wlo;
    const int sb_lo = f.lo - f.wlo;
    const int bit = kk >= log_t ? static_cast<int>((dbase >> kk) & 1)
                                : (gb >> min(kk, 30)) & 1;
    // register u ascends iff bit (kk - wlo) of u == invert ^ bit
    const int flip = invert ^ bit;
    const int kw = kk - f.wlo;
    if (kw < R) {
      level_runtime<NCMP, P, R>(v, kw, flip, sb_hi, sb_lo);
    } else if (flip) {
      level_fixed<NCMP, P, R, R, 1>(v, sb_hi, sb_lo);
    } else {
      level_fixed<NCMP, P, R, R, 0>(v, sb_hi, sb_lo);
    }
  }
}

// Row -> device-memory address maps of a tile pass's first load, one
// functor each (a template parameter of tile_pass, so no run-time branch).
// kRuns: the rows a thread holds at wlo = 0 (an aligned run of W <= 16
// tile rows) lie at ascending consecutive addresses, so they may move as
// int4 vectors.
struct Contiguous {  // chunk_sort, finish: the tile itself
  static constexpr bool kRuns = true;
  int64_t base;
  __device__ __forceinline__ int64_t operator()(int row) const {
    return base + row;
  }
};

// chunk_sort_cyclic: rows lb + i of radix chunk c, which owns the tiles
// {g * n_chunks + c} of 2^kCyclicLog rows (a run of W rows lies in one).
struct Cyclic {
  static constexpr bool kRuns = true;
  int64_t lb, c, n_chunks;
  __device__ __forceinline__ int64_t operator()(int row) const {
    const int64_t e = lb + row;
    return (((e >> kCyclicLog) * n_chunks + c) << kCyclicLog) |
           (e & ((1 << kCyclicLog) - 1));
  }
};

// slot_merge: row g = base + i of the input, read backwards (g ^ (S - 1))
// in an odd slot of S = 2^log_s rows.  A warp reads 32 consecutive rows
// per register, ascending or descending: coalesced, but no int4 runs.
struct SlotReversed {
  static constexpr bool kRuns = false;
  int64_t base, smask;
  int log_s;
  __device__ __forceinline__ int64_t operator()(int row) const {
    const int64_t g = base + row;
    return ((g >> log_s) & 1) ? g ^ smask : g;
  }
};

// cross_stage: tile row (u, l) = u * L + l is row base + u * 2^j_low + l,
// u < 2^F segments of L = 2^log_l contiguous rows (log_l <= j_low).  A
// thread's rows in a phase differ in the compared bits, so they lie
// 2^j_low apart and never form an int4 run; neighbouring lanes hold
// neighbouring l, so a warp's loads and stores coalesce.
struct Strided {
  static constexpr bool kRuns = false;
  int64_t base;
  int log_l, j_low;
  __device__ __forceinline__ int64_t operator()(int row) const {
    return base + (static_cast<int64_t>(row >> log_l) << j_low) +
           (row & ((1 << log_l) - 1));
  }
};

// A thread's rows from device memory (rows past a tile smaller than W do
// not exist).
template <int P, int W, typename Map>
__device__ __forceinline__ void rows_from_global(int (&v)[P][W],
                                                 const Planes& x,
                                                 const Map& map, int gb,
                                                 int wlo, int t, bool vec) {
  if constexpr (Map::kRuns) {
    if (vec && wlo == 0) {
      const int64_t at = map(gb);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int4* q = reinterpret_cast<const int4*>(x.p[j] + at);
#pragma unroll
        for (int c = 0; c < W / 4; ++c) {
          const int4 a = q[c];
          v[j][4 * c] = a.x;
          v[j][4 * c + 1] = a.y;
          v[j][4 * c + 2] = a.z;
          v[j][4 * c + 3] = a.w;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int row = gb | (u << wlo);
    if (row < t) {
      const int64_t at = map(row);
#pragma unroll
      for (int j = 0; j < P; ++j) v[j][u] = x.p[j][at];
    }
  }
}

template <int P, int W, typename Map>
__device__ __forceinline__ void rows_to_global(const Planes& x, const Map& map,
                                               const int (&v)[P][W], int gb,
                                               int wlo, int t, bool vec) {
  if constexpr (Map::kRuns) {
    if (vec && wlo == 0) {
      const int64_t at = map(gb);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        int4* q = reinterpret_cast<int4*>(x.p[j] + at);
#pragma unroll
        for (int c = 0; c < W / 4; ++c) {
          q[c] = make_int4(v[j][4 * c], v[j][4 * c + 1], v[j][4 * c + 2],
                           v[j][4 * c + 3]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int row = gb | (u << wlo);
    if (row < t) {
      const int64_t at = map(row);
#pragma unroll
      for (int j = 0; j < P; ++j) x.p[j][at] = v[j][u];
    }
  }
}

// ---------------------------------------------------------------------------
// A sort's first load and last store (csrc/bitonic_io.cu).  The first chunk
// sort of a sort (the network's chunk_sort, the radix sort's
// chunk_sort_cyclic) reads the caller's columns, not planes made
// beforehand: each plane's rows come from a source, biased, padded and
// numbered as the load reads them; the last launch of a network sort
// writes the keys back unbiased (the radix sort's last, radix_concat,
// does so in csrc/radix.cu).
// Both are overloads of rows_from_global / rows_to_global picked by the map
// type, so top_pass and tile_pass run them with no change of their own.
// ---------------------------------------------------------------------------

// A plane's source.  Rows [0, n) are a 32-bit column XORed with `xr` at
// load (the keys' sign bias), or two columns back to back (rows [split, n)
// from col1: the join's build keys, then its probe keys), or, with `index`,
// a number made from the row (row + add0 below split, row + add1 from it:
// the stable sorts' index, the join's tie).  Rows >= n hold the pad: `pad`,
// or with `pad_row` the row itself (the stable sorts' index of a pad row).
struct PlaneSource {
  const int* col0;
  const int* col1;
  int64_t n, split;
  int xr, add0, add1, pad, pad_row, index;
};

__device__ __forceinline__ int source_row(const PlaneSource& s, int64_t row) {
  if (row >= s.n) return s.pad_row ? static_cast<int>(row) : s.pad;
  const bool second = row >= s.split;
  if (s.index) return static_cast<int>(row) + (second ? s.add1 : s.add0);
  return (second ? s.col1[row - s.split] : s.col0[row]) ^ s.xr;
}

// The first load of chunk_sort's source form: tile row i of every plane is
// source row base + i (base: the piece's first row plus the tile's).
template <int P>
struct Sources {
  static constexpr bool kRuns = true;
  PlaneSource s[P];
  int64_t base;
  __device__ __forceinline__ int64_t operator()(int row) const {
    return base + row;
  }
};

// The first load of chunk_sort_cyclic's source form: tile row i of radix
// chunk c is source row base + Cyclic{lb, c, n_chunks}(i) (base: the
// piece's first row; the kernel sets the tile's cyclic map).  A run of W
// <= 16 rows lies inside one 1024-row cyclic tile, so its source rows are
// consecutive, as Sources' are.
template <int P>
struct CyclicSources {
  static constexpr bool kRuns = true;
  PlaneSource s[P];
  int64_t base;
  Cyclic cyclic;
  __device__ __forceinline__ int64_t operator()(int row) const {
    return base + cyclic(row);
  }
};

// A thread's rows from the sources; src(row) is tile row `row`'s source
// row.  The first phase of a chunk sort has wlo = 0 (tile_plan; the entry
// points refuse another plan), so a thread's rows are gb .. gb + W - 1,
// consecutive source rows from src(gb): the map runs once a thread, not
// once a row (the cyclic map's 64-bit product).  A run of a column moves
// as int4 vectors where it lies inside one column, below n, at a 16-byte
// aligned address; a run that holds row n or the split, or lies at an
// unaligned address (a caller's view such as keys[3:]), goes row by row,
// so no load reads past a column's end.  An index is computed, never read.
template <int P, int W, typename Src>
__device__ __forceinline__ void rows_from_sources(int (&v)[P][W],
                                                  const Src& src, int gb,
                                                  int t, bool vec) {
  const int64_t r0 = src(gb);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const PlaneSource& s = src.s[j];
    if (vec && !s.index) {
      const bool second = r0 >= s.split;
      const int* q = second ? s.col1 + (r0 - s.split) : s.col0 + r0;
      if (r0 + W <= s.n && (second || r0 + W <= s.split) &&
          (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
        const int4* q4 = reinterpret_cast<const int4*>(q);
#pragma unroll
        for (int c = 0; c < W / 4; ++c) {
          const int4 a = q4[c];
          v[j][4 * c] = a.x ^ s.xr;
          v[j][4 * c + 1] = a.y ^ s.xr;
          v[j][4 * c + 2] = a.z ^ s.xr;
          v[j][4 * c + 3] = a.w ^ s.xr;
        }
        continue;
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      if (gb + u < t) v[j][u] = source_row(s, r0 + u);
    }
  }
}

template <int P, int W>
__device__ __forceinline__ void rows_from_global(int (&v)[P][W],
                                                 const Planes& /*unused*/,
                                                 const Sources<P>& src,
                                                 int gb, int /*wlo: 0*/,
                                                 int t, bool vec) {
  rows_from_sources<P, W>(v, src, gb, t, vec);
}

template <int P, int W>
__device__ __forceinline__ void rows_from_global(int (&v)[P][W],
                                                 const Planes& /*unused*/,
                                                 const CyclicSources<P>& src,
                                                 int gb, int /*wlo: 0*/,
                                                 int t, bool vec) {
  rows_from_sources<P, W>(v, src, gb, t, vec);
}

// The last store of a sort (chunk_sort's source form, finish's unbiasing
// form): planes 1..P-1 go back to their tile in place; plane 0 goes to
// key[row] ^ xr for the rows below `rows` (row: base + the tile row), in
// place (key = plane 0) or into the caller's output of its real rows, the
// pads past it not stored.
struct KeyOut {
  static constexpr bool kRuns = true;
  int64_t base;
  int* key;
  int64_t rows;
  int xr;
};

template <int P, int W>
__device__ __forceinline__ void rows_to_global(const Planes& x,
                                               const KeyOut& o,
                                               const int (&v)[P][W], int gb,
                                               int wlo, int t, bool vec) {
  if (vec && wlo == 0) {
    const int64_t r0 = o.base + gb;
#pragma unroll
    for (int j = 1; j < P; ++j) {
      int4* q = reinterpret_cast<int4*>(x.p[j] + r0);
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        q[c] = make_int4(v[j][4 * c], v[j][4 * c + 1], v[j][4 * c + 2],
                         v[j][4 * c + 3]);
      }
    }
    int* k = o.key + r0;
    if (r0 + W <= o.rows && (reinterpret_cast<uintptr_t>(k) & 15) == 0) {
      int4* q = reinterpret_cast<int4*>(k);
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        q[c] = make_int4(v[0][4 * c] ^ o.xr, v[0][4 * c + 1] ^ o.xr,
                         v[0][4 * c + 2] ^ o.xr, v[0][4 * c + 3] ^ o.xr);
      }
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u) {
        if (r0 + u < o.rows) k[u] = v[0][u] ^ o.xr;
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int row = gb | (u << wlo);
    if (row < t) {
      const int64_t at = o.base + row;
#pragma unroll
      for (int j = 1; j < P; ++j) x.p[j][at] = v[j][u];
      if (at < o.rows) o.key[at] = v[0][u] ^ o.xr;
    }
  }
}

// The swizzled places of a thread's rows.  The swizzle is linear over XOR
// and gb | (u << wlo) = gb ^ (u << wlo), so the place of register u is the
// place of gb XOR the places of u's bits: one XOR per row.
template <int R>
__device__ __forceinline__ void shared_places(int (&at)[1 << R], int gb,
                                              int wlo) {
  int unit[R];
#pragma unroll
  for (int b = 0; b < R; ++b) unit[b] = swizzle<R>(1 << (wlo + b));
  at[0] = swizzle<R>(gb);
#pragma unroll
  for (int u = 1; u < (1 << R); ++u) {
    at[u] = at[u & (u - 1)] ^ unit[low_bit(u)];
  }
}

// Shared memory holds plane j at s + j * t, swizzled, a thread's rows at
// the places `at` (shared_places); a plan of more than one phase has t >
// W, so every row exists.
template <int P, int R>
__device__ __forceinline__ void rows_from_shared(int (&v)[P][1 << R],
                                                 const int* s,
                                                 const int (&at)[1 << R],
                                                 int t) {
#pragma unroll
  for (int u = 0; u < (1 << R); ++u) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j][u] = s[j * t + at[u]];
  }
}

template <int P, int R>
__device__ __forceinline__ void rows_to_shared(int* s,
                                               const int (&v)[P][1 << R],
                                               const int (&at)[1 << R],
                                               int t) {
#pragma unroll
  for (int u = 0; u < (1 << R); ++u) {
#pragma unroll
    for (int j = 0; j < P; ++j) s[j * t + at[u]] = v[j][u];
  }
}

// A phase stores its rows to the places it loaded them from.  At one plane
// the places stay in registers across the substages (finish 5% and
// chunk_sort 10% faster at 2^28 keys, PERF.md); at two planes that made
// the passes slower (more registers a thread), so they are computed again.
template <int P>
constexpr bool kKeepPlaces = P == 1;

// One tile pass of block blockIdx.x over the plan: the first phase reads
// tile row i of `in` at map(i), the last one writes it to `out` at
// omap(i) (in place: the same planes and maps).  dbase: the
// tile's base in the direction index (masked by the span, or 0 for
// `ascending`).  A thread takes the groups threadIdx.x, + blockDim.x, ...
// of every phase; a group's rows are its own in the phase's layout, so its
// store to shared memory cannot overwrite a row another thread has yet to
// load.
template <int NCMP, int P, typename Map, typename OutMap>
__device__ __forceinline__ void tile_pass(const Planes& in, const Planes& out,
                                          const Map& map, const OutMap& omap,
                                          int log_t, const TilePlan& plan,
                                          int64_t dbase, int invert,
                                          bool vec) {
  constexpr int R = max_fusion(P);
  constexpr int W = 1 << R;
  extern __shared__ int s[];
  const int t = 1 << log_t;
  const int groups = max(t >> R, 1);
  int v[P][W];
  for (int ph = 0; ph < plan.n; ++ph) {
    const Phase f = decode_phase(plan.code[ph]);
    const bool last = ph == plan.n - 1;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int gb = ((g >> f.wlo) << (f.wlo + R)) | (g & ((1 << f.wlo) - 1));
      int at[W];
      if (ph == 0) {
        rows_from_global<P, W>(v, in, map, gb, f.wlo, t, vec);
      } else {
        shared_places<R>(at, gb, f.wlo);
        rows_from_shared<P, R>(v, s, at, t);
      }
      phase_substages<NCMP, P, R>(v, f, gb, dbase, log_t, invert);
      if (last) {
        rows_to_global<P, W>(out, omap, v, gb, f.wlo, t, vec);
      } else {
        if (ph == 0 || !kKeepPlaces<P>) shared_places<R>(at, gb, f.wlo);
        rows_to_shared<P, R>(s, v, at, t);
      }
    }
    if (!last) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Plans laid out at compile time.  A tile pass at its mode's own tile runs a
// plan that depends only on the plane count (and a slot merge's slot): a
// chunk sort of the mode's chunk tile (chunk_sort, chunk_sort_cyclic), the
// levels above a slot (slot_merge), a finish pass at a level at or above
// the mode's finish tile, a strided cross pass of f > R distances over the
// mode's cross tile.  top_pass unrolls such a plan: no plan decoding,
// constant register windows and substage ranges, and each level's
// direction rule chosen at compile time (top_levels).  The network is the
// same bit for bit, in fewer instructions: the tile passes are bound by
// those instructions more than by device memory (tools/finish_bench.py,
// PERF.md).  The host entry points take these kernels only for a plan
// equal to the layout (is_top_plan); the run-time kernels (tile_pass) keep
// every other plan.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int plan_code(int kk_a, int kk_b, int hi,
                                            int lo, int wlo) {
  return kk_a | kk_b << 6 | hi << 12 | lo << 16 | wlo << 20;
}

// Phase ph of a compile-time plan, packed as the host packs tile_plan's
// phases, or 0 past the last phase (kernels/bitonic.py::top_plan mirrors
// it and holds it equal to tile_plan):
//   kk >= log_t, a level at or above the tile: tile_plan(log_t, kk, kk, r,
//     lo_bit), bits log_t-1 .. lo_bit in phases of r, highest first;
//   kk < log_t, the levels max(kk, 1) .. log_t of a chunk sort (kk = 0: the
//     whole sort; a slot merge: kk = log_s + 1): tile_plan(log_t, max(kk,
//     1), log_t, r), levels up to r at bits r-1..0 in one phase, then each
//     level k > r at bits k-1 .. 0 in ceil(k / r) phases.
// A phase's register window starts at its lowest bit, clamped into the
// tile.
__host__ __device__ constexpr int top_code(int log_t, int kk, int r,
                                           int lo_bit, int ph) {
  if (kk >= log_t) {
    const int hi = log_t - 1 - ph * r;
    if (hi < lo_bit) return 0;
    const int lo = hi - r + 1 > lo_bit ? hi - r + 1 : lo_bit;
    return plan_code(kk, kk, hi, lo, lo < log_t - r ? lo : log_t - r);
  }
  int k = kk > 1 ? kk : 1;
  if (k <= r) {
    if (ph == 0) return plan_code(k, r, r - 1, 0, 0);
    --ph;
    k = r + 1;
  }
  for (; k <= log_t; ++k) {
    const int phases = (k + r - 1) / r;
    if (ph < phases) {
      const int hi = k - 1 - ph * r;
      const int lo = hi - r + 1 > 0 ? hi - r + 1 : 0;
      return plan_code(k, k, hi, lo, lo < log_t - r ? lo : log_t - r);
    }
    ph -= phases;
  }
  return 0;
}

__host__ __device__ constexpr int top_phases(int log_t, int kk, int r,
                                             int lo_bit) {
  int n = 0;
  while (top_code(log_t, kk, r, lo_bit, n) != 0) ++n;
  return n;
}

// The mode's chunk and finish tile (config.py; kernels/bitonic.py
// top_tile) and its cross tile (kernels/bitonic.py cross_tile: P planes in
// 64 KB), log2.
__host__ __device__ constexpr int top_log_t(int np) {
  return np == 1 ? 14 : np <= 3 ? 13 : np <= 6 ? 12 : 11;
}

__host__ __device__ constexpr int cross_log_t(int np) {
  return np == 1 ? 14 : np == 2 ? 13 : np <= 4 ? 12 : 11;
}

// Most distances a cross pass runs (kernels/bitonic.py cross_fusion).
__host__ __device__ constexpr int cross_fusion(int np) {
  return np == 1 ? 10 : np == 2 ? 9 : 2 * max_fusion(np);
}

// The modes whose strided cross pass has a compile-time plan: those where
// it measured faster than the run-time plan (keys only; at two planes and
// more the two were within 2% of each other either way, PERF.md;
// kernels/bitonic.py TOP_MODES).
__host__ __device__ constexpr bool cross_top(int np) { return np == 1; }

// The modes whose radix tile passes (chunk_sort_cyclic, slot_merge) have
// compile-time plans: keys, rider and lex2, the modes the radix sort runs
// (kernels/bitonic.py TOP_MODES; lex3, which no path sends to radix, keeps
// the run-time plan).  slot_merge has one for every slot of 2^kMinSlotLog
// (the radix plan's least slot) up to half the tile.
__host__ __device__ constexpr bool radix_top(int np) { return np <= 2; }
constexpr int kMinSlotLog = 10;

// Phase PH of the compile-time plan of a tile of 2^LOG_T rows at P planes;
// KK: 0 for a chunk sort, log_s + 1 for the levels above a slot, LOG_T for
// every level at or above the tile (their bits are the same; the level only
// picks the tile's direction).
template <int P, int LOG_T, int KK, int LO_BIT, int PH>
struct TopPhase {
  static constexpr int kCode = top_code(LOG_T, KK, max_fusion(P), LO_BIT, PH);
  static constexpr int kKkA = kCode & 63;
  static constexpr int kKkB = (kCode >> 6) & 63;
  static constexpr int kHi = (kCode >> 12) & 15;
  static constexpr int kLo = (kCode >> 16) & 15;
  static constexpr int kWlo = (kCode >> 20) & 15;
  static constexpr bool kLast =
      top_code(LOG_T, KK, max_fusion(P), LO_BIT, PH + 1) == 0;
};

// The substages sb_hi .. sb_lo of one level whose direction is one for all
// of a thread's registers but differs across a warp's lanes (up), in one
// body, without a branch.  Keys only, with two substages or more: the rows
// of a descending thread are complemented (~x reverses the signed order),
// the ascending body runs, and they are complemented back: 2^(R+1) XORs
// against the two selects a pair that a min and a max in a run-time
// direction take (PERF.md: the SASS and the times of both).  With one
// substage a pair takes those selects; with more planes a pair compares in
// its direction and swaps by selects.
template <int NCMP, int P, int R, int SB_HI, int SB_LO>
__device__ __forceinline__ void level_lanes(int (&v)[P][1 << R], bool up) {
  constexpr int W = 1 << R;
  if constexpr (P == 1 && SB_HI > SB_LO) {
    const int m = up ? 0 : -1;
#pragma unroll
    for (int u = 0; u < W; ++u) v[0][u] ^= m;
    level_fixed<NCMP, P, R, R, 0>(v, SB_HI, SB_LO);
#pragma unroll
    for (int u = 0; u < W; ++u) v[0][u] ^= m;
    return;
  }
#pragma unroll
  for (int sb = SB_HI; sb >= SB_LO; --sb) {
#pragma unroll
    for (int u = 0; u < W; ++u) {
      if (u & (1 << sb)) continue;
      const int o = u | (1 << sb);
      if constexpr (P == 1) {
        compare_exchange(v[0][u], v[0][o], up);
      } else {
        const bool swap = must_swap<NCMP>(v[0][u], NCMP == 2 ? v[1][u] : 0,
                                          v[0][o], NCMP == 2 ? v[1][o] : 0,
                                          up);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int a = v[j][u];
          const int b = v[j][o];
          v[j][u] = swap ? b : a;
          v[j][o] = swap ? a : b;
        }
      }
    }
  }
}

// Levels KK..KK_B of one phase of a compile-time plan (tile bits HI..LO in
// registers WLO..WLO+R-1).  Register u holds tile row gb | (u << WLO).  Each
// level's direction bit is chosen at compile time from where it lies:
//   KK >= LOG_T: bit KK of the tile's base: flip_top, one for the tile;
//   KK - WLO < R: bit KK - WLO of the register index (`invert` is uniform);
//   else bit KK of gb, which is bit KK - R of the group index g: one for a
//     warp when that bit lies above its 32 lanes (KK - R >= 5), so the
//     branch between two bodies never splits a warp; below (a chunk sort's
//     levels R .. R + 4) the lanes differ and level_lanes runs the level
//     without a branch.
template <int NCMP, int P, int LOG_T, int HI, int LO, int WLO, int KK,
          int KK_B>
__device__ __forceinline__ void top_levels(int (&v)[P][1 << max_fusion(P)],
                                           int gb, int flip_top, int invert) {
  constexpr int R = max_fusion(P);
  constexpr int SB_HI = (HI < KK - 1 ? HI : KK - 1) - WLO;
  constexpr int SB_LO = LO - WLO;
  if constexpr (KK < LOG_T && KK - WLO < R) {
    if (invert) {
      level_fixed<NCMP, P, R, KK - WLO, 1>(v, SB_HI, SB_LO);
    } else {
      level_fixed<NCMP, P, R, KK - WLO, 0>(v, SB_HI, SB_LO);
    }
  } else if constexpr (KK < LOG_T && KK - R < 5) {
    level_lanes<NCMP, P, R, SB_HI, SB_LO>(v, ((gb >> KK) & 1) == invert);
  } else {
    const int flip = KK >= LOG_T ? flip_top : invert ^ ((gb >> KK) & 1);
    if (flip) {
      level_fixed<NCMP, P, R, R, 1>(v, SB_HI, SB_LO);
    } else {
      level_fixed<NCMP, P, R, R, 0>(v, SB_HI, SB_LO);
    }
  }
  if constexpr (KK < KK_B) {
    top_levels<NCMP, P, LOG_T, HI, LO, WLO, KK + 1, KK_B>(v, gb, flip_top,
                                                          invert);
  }
}

// Phases PH.. of a compile-time plan over the tile of block blockIdx.x:
// phase 0 loads the tile's rows from `in` through `map`, the last stores
// them to `out` through `omap` (in place: the same planes and maps), the
// phases between go through the swizzled shared memory s, one
// __syncthreads() after each.  flip_top: the direction of a level at or
// above the tile (bit kk of the tile's span-masked base, XOR invert).
template <int NCMP, int P, int LOG_T, int KK, int LO_BIT, int PH,
          typename Map, typename OutMap>
__device__ __forceinline__ void top_pass(const Planes& in, const Planes& out,
                                         int* s, const Map& map,
                                         const OutMap& omap, int flip_top,
                                         int invert, bool vec) {
  constexpr int R = max_fusion(P);
  constexpr int W = 1 << R;
  constexpr int T = 1 << LOG_T;
  using F = TopPhase<P, LOG_T, KK, LO_BIT, PH>;
  static_assert(F::kCode != 0, "a phase of the plan");
  for (int g = threadIdx.x; g < (T >> R); g += blockDim.x) {
    const int gb =
        ((g >> F::kWlo) << (F::kWlo + R)) | (g & ((1 << F::kWlo) - 1));
    int v[P][W];
    int at[W];
    if constexpr (PH == 0) {
      rows_from_global<P, W>(v, in, map, gb, F::kWlo, T, vec);
    } else {
      shared_places<R>(at, gb, F::kWlo);
      rows_from_shared<P, R>(v, s, at, T);
    }
    top_levels<NCMP, P, LOG_T, F::kHi, F::kLo, F::kWlo, F::kKkA, F::kKkB>(
        v, gb, flip_top, invert);
    if constexpr (F::kLast) {
      rows_to_global<P, W>(out, omap, v, gb, F::kWlo, T, vec);
    } else {
      if constexpr (PH == 0 || !kKeepPlaces<P>) {
        shared_places<R>(at, gb, F::kWlo);
      }
      rows_to_shared<P, R>(s, v, at, T);
    }
  }
  if constexpr (!F::kLast) {
    __syncthreads();
    top_pass<NCMP, P, LOG_T, KK, LO_BIT, PH + 1>(in, out, s, map, omap,
                                                 flip_top, invert, vec);
  }
}

// Copy and check a tile plan for R = max_fusion(P): every phase's bits lo..hi
// lie in its register window wlo..wlo+R-1, which lies in the tile (or is
// bits 0..R-1 of a tile smaller than W).  Only slot_merge takes an empty
// plan (min_phases 0).
template <int R>
bool make_plan(const int* codes, int64_t phases, int log_t, TilePlan* plan,
               int64_t min_phases = 1) {
  if ((codes == nullptr && phases > 0) || phases < min_phases ||
      phases > kMaxPhases || log_t < 1 || log_t > 30) {
    return false;
  }
  plan->n = static_cast<int>(phases);
  for (int i = 0; i < plan->n; ++i) {
    const Phase f = decode_phase(codes[i]);
    const bool window = log_t >= R ? f.wlo + R <= log_t : f.wlo == 0;
    if (f.kk_a < 1 || f.kk_a > f.kk_b || f.lo > f.hi || f.hi >= log_t ||
        f.lo < f.wlo || f.hi >= f.wlo + R || !window) {
      return false;
    }
    plan->code[i] = codes[i];
  }
  return true;
}

bool aligned16(const Planes& x, int np) {
  for (int j = 0; j < np; ++j) {
    if (reinterpret_cast<uintptr_t>(x.p[j]) % 16 != 0) return false;
  }
  return true;
}

// Launch a tile-engine kernel as kernel(args..., plan, vec): one block per
// tile, min(groups, the cap) threads, the tile's planes in dynamic shared
// memory when the plan has more than one phase (opted in above the 48 KB
// default), int4 rows (vec) when every plane read and written is 16-byte
// aligned and the tile holds W rows.
template <int P, typename Kernel, typename... Args>
cudaError_t launch_tile(Kernel kernel, const Planes& in, const Planes& out,
                        int64_t n, int log_t, const TilePlan& plan,
                        cudaStream_t stream, Args... args) {
  constexpr int R = max_fusion(P);
  const int threads = std::min(std::max((1 << log_t) >> R, 1),
                               kTileThreads);
  const size_t smem = plan.n > 1 ? (sizeof(int) * P) << log_t : 0;
  if (smem > kStaticSmemBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec = log_t >= R && aligned16(in, P) && aligned16(out, P);
  kernel<<<static_cast<unsigned>(n >> log_t), threads, smem, stream>>>(
      args..., plan, static_cast<int>(vec));
  return cudaGetLastError();
}

// Is the plan the one a kernel lays out at compile time (top_code) for a
// tile of 2^log_t rows: a chunk sort's levels max(kk, 1) .. log_t (kk <
// log_t; kk = log_s + 1 a slot merge's) or level kk >= log_t down to bit
// lo_bit?
template <int P>
bool is_top_plan(const TilePlan& plan, int log_t, int kk, int lo_bit) {
  constexpr int R = max_fusion(P);
  if ((kk < log_t && lo_bit != 0) ||
      plan.n != top_phases(log_t, kk, R, lo_bit)) {
    return false;
  }
  for (int i = 0; i < plan.n; ++i) {
    if (plan.code[i] != top_code(log_t, kk, R, lo_bit, i)) return false;
  }
  return true;
}

}  // namespace
