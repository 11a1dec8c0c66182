// Bitonic sort kernels for Hopper (sm_90a) over P flat int32 planes of one
// power-of-two length, sorted in place.
//
// Plane 0 holds sign-biased uint32 keys (key ^ 0x80000000, so signed order is
// unsigned order) padded with 0x7FFFFFFF.  The network is the standard
// bitonic one over the flat index: at merge level kk an element ascends iff
// bit kk of its direction index is clear (`invert` flips every direction);
// its partner at distance d is index ^ d.  Indices and offsets are 64-bit, so
// no int32 ceiling on the array length.
//
// The kernels are templated on the compare mode and the plane count
// (NCMP, P), and the planes arrive as a by-value struct of pointers:
//
//   (1, 1)      keys only, a min/max exchange (the keys-only sort);
//   (1, 2)      keys and one rider ("/rider", group-by's unstable sort);
//   (2, 2..8)   lexicographic ("/lex<P>"): planes 0 and 1 compare as signed
//               int32, (plane 0, plane 1) lexicographically; planes 2..P-1
//               ride along (the stable sorts, top_k, join, Table).
//
// With P > 1, one comparison per pair decides the swap of every plane, and a
// pair swaps only when it is strictly out of order: tied rows keep their own
// riders.  (This is the tie-safe exchange of radx_tpu/kernels/bitonic.py:
// 76-84; a form in which each element decides alone from its partner's key
// duplicated riders on the TPU.)  With a unique (plane 0, plane 1) pair, as
// the stable paths give, the order is total and the result is the JAX one.
//
// Three kernels, one per Pallas kernel family of radx_tpu/kernels/bitonic.py:
//
//   chunk_sort  <- _chunk_sort_kernel (:198).  Stages 1..log2(C) inside each
//                  chunk of C keys, on the register tile engine.
//   cross_stage <- _cross_stage_kernel / _cross_stage2/3/4_kernel (:465,
//                  :352, :374, :398).  F consecutive distances >= the
//                  finish tile in one pass over device memory: up to R in
//                  registers, more (up to 10 keys only, where the TPU
//                  fused at most 4) on the register tile engine over
//                  strided tiles.
//   finish      <- _finishw_kernel (:427).  Every distance of one level that
//                  is below the finish tile T, inside each tile of T keys,
//                  on the register tile engine.
//
// At a mode's own tiles the three run their plans laid out at compile time
// (top_pass): the chunk sort of the chunk tile, every finish level at or
// above the finish tile, and (keys) the strided pass over the cross tile.
//
// Two more kernels carry the radix distribution sort (kernels/radix_sort.py),
// on the same register tile engine.  Each reads its tile out of place
// through a row -> address map and writes it contiguously to other planes;
// at the mode's tile (keys, rider, lex2: radix_top) each runs its plan laid
// out at compile time too, chunk_sort_cyclic the chunk sort's, slot_merge
// the levels above the slot for every slot of 2^10 up to half the tile:
//
//   chunk_sort_cyclic <- _chunk_sort_cyclic_kernel (:217).  Stages
//                  1..log2(T) of an ascending sort of every radix chunk,
//                  whose tiles of 1024 keys are taken block-cyclically.
//   slot_merge  <- _slot_merge_kernel (:261).  Reverses the odd slots of
//                  every radix chunk and merges the ascending slots up to
//                  the tile.
//
// A radix chunk (2^17..2^20 keys on the card) is larger than a block's
// shared memory, so its levels above the tile run on cross_stage / finish
// with a direction span: the direction bit kk is read from the index within
// the 2^log_span block (`dmask` = 2^log_span - 1), so the top level of the
// span sorts ascending.  A span of the whole array is the plain network.
//
// The host side (radx_tpu_torch/kernels/bitonic.py) runs, per merge level,
// the cross passes for distances >= T (greedy, at most cross_fusion(P)
// distances a pass) and then one finish pass.  Each entry point launches on
// the stream it is given, does not synchronise, and returns
// cudaGetLastError() for the caller to check.

#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"
#include "tile_engine.cuh"

namespace {

// chunk_sort — replaces radx_tpu/kernels/bitonic.py::_chunk_sort_kernel.
// Bound on the card: 32-bit integer operations (105 substages at C = 2^14:
// 1.69 ms of min / max at 2^28 keys against 0.64 ms of device memory),
// then the instructions of its shared-memory round trips.  Design: one
// block per chunk on the register tile engine (tile_engine.cuh): stages
// 1..R in registers at load time, then ceil(kk / R) phases for stage kk, one
// shared-memory round trip between two phases (28 at C = 2^14, R = 4; 105
// substage round trips before).  The direction index is the global flat
// index (chunks alternate direction, as the cross-chunk merge expects);
// `ascending` uses the index within the chunk, so every chunk sorts
// ascending on its own.  The tile holds every plane, so the host shrinks
// the chunk as P grows.
//
// LOG_T = 0 reads the plan (any chunk) as tile_pass does; LOG_T = the
// mode's chunk tile runs it on the plan laid out at compile time
// (top_pass), where no level's direction branch splits a warp.
template <int NCMP, int P, int LOG_T>
__global__ void __launch_bounds__(kTileThreads, 1)
    chunk_sort_kernel(Planes x, int log_c, int invert, int ascending,
                      TilePlan plan, int vec) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_c;
  const int64_t dbase = ascending ? 0 : base;
  if constexpr (LOG_T == 0) {
    tile_pass<NCMP, P>(x, x, Contiguous{base}, Contiguous{base}, log_c, plan,
                       dbase, invert, vec != 0);
  } else {
    extern __shared__ int top_smem[];
    const Contiguous map{base};
    top_pass<NCMP, P, LOG_T, 0, 0, 0>(
        x, x, top_smem, map, map,
        invert ^ static_cast<int>((dbase >> LOG_T) & 1), invert, vec != 0);
  }
}

// chunk_sort_cyclic — replaces radx_tpu/kernels/bitonic.py::
// _chunk_sort_cyclic_kernel (radix phase 1).
// Bound on the card: 32-bit integer operations (105 substages at the keys'
// 2^14 tile, 91 at the 2^13 tile of rider / lex2 / lex3), then the
// instructions of its shared-memory round trips, as chunk_sort; one read
// and one write of every plane.  Radix chunk c (2^log_c keys) owns the
// tiles {g * n_chunks + c} of 1024 keys, so locally ordered inputs spread
// evenly over the chunks.  Design: chunk sort's plan on the register tile
// engine, one block per 2^log_t keys of a chunk (tile b of the grid: chunk
// b >> (log_c - log_t), base lb in it): the first phase holds 2^R <= 16
// contiguous rows of one 1024-key tile per thread, so it loads them as int4
// from their cyclic place; stages 1..R run at load time, stage kk > R in
// ceil(kk / R) phases (28 round trips at 2^14, R = 4; 24 at 2^13, where
// the loop of one substage per round trip made 105 and 91).  Directions
// come from the index within the radix chunk (lb + row), so the tiles of a
// chunk alternate; the tile goes contiguously to `out` at b << log_t (out
// of place: the cyclic input and the contiguous output overlap across
// blocks).  With log_t == log_c the chunk ends ascending, as in the JAX
// kernel; a larger chunk is finished by cross_stage / finish with a span of
// 2^log_c.
//
// LOG_T = 0 reads the plan (any tile) as tile_pass does; LOG_T = the mode's
// chunk tile (radix_top modes) runs chunk_sort's plan laid out at compile
// time (top_pass), the top level's direction bit log_t of lb, the levels
// whose direction is a lane bit in one body (top_levels): at 2^28 keys
// 3.19 ms against the run-time plan's 6.00, as fast as chunk_sort (one
// H100, tools/finish_bench.py, PERF.md).
template <int NCMP, int P, int LOG_T>
__global__ void __launch_bounds__(kTileThreads, 1)
    chunk_sort_cyclic_kernel(Planes in, Planes out, int log_t, int log_c,
                             int64_t n_chunks, TilePlan plan, int vec) {
  const int lt = LOG_T == 0 ? log_t : LOG_T;
  const int64_t tile = blockIdx.x;
  const int64_t lb = (tile << lt) & ((static_cast<int64_t>(1) << log_c) - 1);
  const Cyclic map{lb, tile >> (log_c - lt), n_chunks};
  const Contiguous omap{tile << lt};
  if constexpr (LOG_T == 0) {
    tile_pass<NCMP, P>(in, out, map, omap, log_t, plan, lb, 0, vec != 0);
  } else {
    extern __shared__ int top_smem[];
    top_pass<NCMP, P, LOG_T, 0, 0, 0>(in, out, top_smem, map, omap,
                                      static_cast<int>((lb >> LOG_T) & 1), 0,
                                      vec != 0);
  }
}

// slot_merge — replaces radx_tpu/kernels/bitonic.py::_slot_merge_kernel
// (radix phase C).
// Bound on the card: the instructions of its shared-memory phases, then
// device memory.  Every radix chunk of 2^log_c keys holds ascending slots
// of 2^log_s keys (the packed runs with their fill tails).  Reversing the
// odd slots gives the bitonic invariant of level log_s; the JAX kernel
// reverses with lane gathers and rolls, here the first load reads x[i ^ (S
// - 1)] for odd slots, at no extra pass.  Design: levels log_s + 1 ..
// log_t on the register tile engine, directions from the index within the
// chunk; its first phase holds the rows 2^wlo apart (wlo >= 7 for slots >=
// 1024), so a warp reads 32 consecutive rows per register and the loads
// stay scalar, and its last phase stores int4 vectors.  Round trips at the
// radix sort's tiles: 7 for slots of 4096 in a 2^14 tile (the loop of one
// substage per round trip made 27), 13 for slots of 1024 (50), 3 for slots
// of 4096 in a 2^13 tile (13).  With S >= T the plan is empty and the tile
// is a copy through the map.  The tile goes to `out` (out of place: with S
// > T a tile reads another tile's keys).  Levels above the tile run on
// cross_stage / finish with a span of 2^log_c.
//
// LOG_T = 0 reads the plan (any tile and slot, the copy included) as
// tile_pass does; LOG_T = the mode's tile (radix_top modes) with LOG_S in
// kMinSlotLog .. LOG_T - 1 runs the levels LOG_S + 1 .. LOG_T laid out at
// compile time (top_pass): each level below the tile is >= 11 > R + 4, so
// its direction is bit kk of the group index, one for a warp; the top
// level's is bit log_t of the tile's base within the chunk.  At 2^28 keys
// (slots of 1024, 13 round trips) 2.28 ms against the run-time plan's
// 3.88: decoding many phases cost more than finish's four (one H100,
// tools/finish_bench.py, PERF.md).
template <int NCMP, int P, int LOG_T, int LOG_S>
__global__ void __launch_bounds__(kTileThreads, 1)
    slot_merge_kernel(Planes in, Planes out, int log_t, int log_s,
                      int64_t cmask, TilePlan plan, int vec) {
  if constexpr (LOG_T == 0) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) << log_t;
    const SlotReversed map{base, (static_cast<int64_t>(1) << log_s) - 1,
                           log_s};
    if (plan.n == 0) {  // no level below the tile: a row per thread in turn
      for (int i = threadIdx.x; i < (1 << log_t); i += blockDim.x) {
        const int64_t at = map(i);
#pragma unroll
        for (int j = 0; j < P; ++j) out.p[j][base + i] = in.p[j][at];
      }
      return;
    }
    tile_pass<NCMP, P>(in, out, map, Contiguous{base}, log_t, plan,
                       base & cmask, 0, vec != 0);
  } else {
    static_assert(kMinSlotLog <= LOG_S && LOG_S < LOG_T, "a slot merge");
    extern __shared__ int top_smem[];
    const int64_t base = static_cast<int64_t>(blockIdx.x) << LOG_T;
    const SlotReversed map{base, (static_cast<int64_t>(1) << LOG_S) - 1,
                           LOG_S};
    top_pass<NCMP, P, LOG_T, LOG_S + 1, 0, 0>(
        in, out, top_smem, map, Contiguous{base},
        static_cast<int>(((base & cmask) >> LOG_T) & 1), 0, vec != 0);
  }
}

// finish — replaces radx_tpu/kernels/bitonic.py::_finishw_kernel.
// Bound on the card: the instructions of its shared-memory phases, then
// device memory (one read and one write of every plane per level).  On
// the TPU the last log2(W) cross distances of a level fold into a W-chunk
// finish sized by VMEM; here every distance below the tile T runs in one
// block and the distances >= T are cross passes, so a level costs one
// device-memory pass for its whole tail.  Design: the register tile engine
// (tile_engine.cuh), ceil(log2(T) / R) phases (4 at T = 2^14, R = 4: 3
// shared-memory round trips where the substage loop made 14); the first
// phase's register bits are the tile's top bits, so its loads coalesce,
// and the last phase stores int4 vectors.  The direction comes from bit kk of each key's
// index within the span (dmask), so a tile may hold several merge groups
// of a low level (kk < log_t: min(log_t, kk) distances).
//
// LOG_T = 0 reads the plan (any tile, any level) as tile_pass does.  Every
// finish pass of a sort's merge levels is a level at or above the mode's
// finish tile; LOG_T = that tile runs it on its plan laid out at compile
// time (top_pass, one direction a tile): at 2^28 keys a copy of the same
// bytes takes 0.71 ms, the pass cut to one round trip 0.78, the run-time
// plan 0.97, the compile-time one 0.85 (tools/finish_bench.py, PERF.md).
template <int NCMP, int P, int LOG_T>
__global__ void __launch_bounds__(kTileThreads, 1)
    finish_kernel(Planes x, int log_t, int invert, int64_t dmask,
                  TilePlan plan, int vec) {
  if constexpr (LOG_T == 0) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) << log_t;
    tile_pass<NCMP, P>(x, x, Contiguous{base}, Contiguous{base}, log_t, plan,
                       base & dmask, invert, vec != 0);
  } else {
    extern __shared__ int top_smem[];
    const int64_t base = static_cast<int64_t>(blockIdx.x) << LOG_T;
    const int kk = decode_phase(plan.code[0]).kk_a;
    const int flip = invert ^ static_cast<int>(((base & dmask) >> kk) & 1);
    const Contiguous map{base};
    top_pass<NCMP, P, LOG_T, LOG_T, 0, 0>(x, x, top_smem, map, map, flip,
                                          invert, vec != 0);
  }
}

// cross_stage<F> — replaces radx_tpu/kernels/bitonic.py::_cross_stage_kernel
// (F = 1) and _cross_stage2/3/4_kernel (F = 2, 3, 4).
// Bound on the card: device-memory bandwidth; each pass reads and writes
// every plane once and does F compare-exchanges per row, so only fewer
// passes make a level cheaper.  Two designs, one kernel name:
//
// F >= 1, F <= R = max_fusion(P) (the register pass): thread t owns the 2^F
// rows i0 + u*J (u < 2^F, J = 2^j_low the lowest distance) of every plane
// in registers and runs the F substages (2^(F-1) J .. J) there.  Adjacent
// threads take adjacent i0, so every load and store coalesces (J >= the
// finish tile >= 32).  The level bit kk lies above the group's index bits,
// so one direction serves the whole group.
//
// F = 0 (the strided tile pass, the pass's f > R distances in the plan):
// 2^R rows a thread cap the register pass at R distances, so a wider pass
// runs on the register tile engine over a strided tile.  A block takes 2^f
// segments of L = 2^log_l contiguous rows, segment u at base + u * 2^j_low
// (the distances 2^(j_low+f-1) .. 2^j_low are the tile's bits log_l+f-1 ..
// log_l); the block's base runs over the address bits between the segment
// and j_low and above j_low + f.  The plan (bitonic.py::tile_plan with
// lowest bit log_l) runs the f distances in ceil(f / R) phases, highest
// first, one shared-memory round trip between two phases: f = 8 at R = 4
// is two phases and one round trip.  The direction is bit kk of the
// (span-masked) base, as in finish.  The last phase stores through the
// same map, in place.  At f <= R the register pass is faster (3-8% a pass
// out of cache, 30% in L2; PERF.md), so it keeps those passes.
//
// F > R: the strided tile pass of F distances on the plan laid out at
// compile time (top_pass), keys only (cross_top).  Every sort path's wide
// pass runs over the mode's cross tile (j_low is at least the finish tile,
// at least the cross tile), so its plan depends only on (P, F): segments
// of 2^(log2 of the cross tile - F) rows, bits log_l+F-1 .. log_l, one
// direction a tile (5-10% faster than F = 0 at 2^28 keys, PERF.md).  F = 0
// keeps any other geometry and the other modes on the plan read at run
// time.
template <int F, int NCMP, int P>
__global__ void __launch_bounds__(kTileThreads, 1)
    cross_stage_kernel(Planes x, int64_t n, int64_t rows, int j_low, int kk,
                       int f, int log_l, int invert, int64_t dmask,
                       TilePlan plan, int vec) {
  if constexpr (F == 0 || F > max_fusion(P)) {
    constexpr int kLogL = F == 0 ? 0 : cross_log_t(P) - F;
    const int seg = F == 0 ? log_l : kLogL;
    const int pass = F == 0 ? f : F;
    const int64_t b = blockIdx.x;
    const int low = j_low - seg;  // base bits between segment and j_low
    const int64_t base =
        ((b >> low) << (j_low + pass)) |
        ((b & ((static_cast<int64_t>(1) << low) - 1)) << seg);
    const Strided map{base, seg, j_low};
    if constexpr (F == 0) {
      tile_pass<NCMP, P>(x, x, map, map, log_l + f, plan, base & dmask,
                         invert, vec != 0);
    } else {
      extern __shared__ int top_smem[];
      const int flip = invert ^ static_cast<int>(((base & dmask) >> kk) & 1);
      top_pass<NCMP, P, cross_log_t(P), cross_log_t(P), kLogL, 0>(
          x, x, top_smem, map, map, flip, invert, vec != 0);
    }
  } else {
    const int64_t t =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n >> F) return;
    const int64_t jmask = (static_cast<int64_t>(1) << j_low) - 1;
    const int64_t stride = jmask + 1;
    const int64_t i0 = ((t & ~jmask) << F) | (t & jmask);
    if (i0 + (static_cast<int64_t>(1 << F) - 1) * stride >= rows) return;
    const bool up = (((i0 & dmask) >> kk) & 1) == invert;
    constexpr int kW = 1 << F;
    int v[P][kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) {
#pragma unroll
      for (int j = 0; j < P; ++j) v[j][u] = x.p[j][i0 + u * stride];
    }
#pragma unroll
    for (int sb = F - 1; sb >= 0; --sb) {
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        if (!(u & (1 << sb))) exchange<NCMP, P, kW>(v, u, u | (1 << sb), up);
      }
    }
#pragma unroll
    for (int u = 0; u < kW; ++u) {
#pragma unroll
      for (int j = 0; j < P; ++j) x.p[j][i0 + u * stride] = v[j][u];
    }
  }
}

// The register pass over the groups whose rows all lie below `rows`: n, or
// the valley merge's overhang (F = 1, n = 2^(j_low+1), 2^j_low < rows): the
// pairs (i, i + 2^j_low) for i < rows - 2^j_low, one thread each.
template <int F, int NCMP, int P>
cudaError_t launch_cross(const Planes& x, int64_t n, int64_t rows, int j_low,
                         int kk, int invert, int64_t dmask,
                         cudaStream_t stream) {
  if constexpr (F > max_fusion(P)) {
    return cudaErrorInvalidValue;
  } else {
    const int64_t groups =
        rows == n ? n >> F : rows - (static_cast<int64_t>(1) << j_low);
    const int64_t blocks = (groups + kTileThreads - 1) / kTileThreads;
    cross_stage_kernel<F, NCMP, P>
        <<<static_cast<unsigned>(blocks), kTileThreads, 0, stream>>>(
            x, n, rows, j_low, kk, F, 0, invert, dmask, TilePlan{}, 0);
    return cudaGetLastError();
  }
}


// In every tile-engine entry point, `top` runs the plan on the kernel that
// lays it out at compile time (kernels/bitonic.py::compile_time_plan picks
// it); the plan must be that layout at the mode's tile, in a mode that has
// the kernel, else the launch is refused.

template <int NCMP, int P>
cudaError_t chunk_sort(const Planes& x, int64_t n, int log_c, int invert,
                       int ascending, const int* codes, int64_t phases,
                       int top, cudaStream_t stream) {
  constexpr int kLogT = top_log_t(P);
  TilePlan plan;
  if (!make_plan<max_fusion(P)>(codes, phases, log_c, &plan) ||
      (top && (log_c != kLogT || !is_top_plan<P>(plan, kLogT, 0, 0)))) {
    return cudaErrorInvalidValue;
  }
  if (top) {
    return launch_tile<P>(chunk_sort_kernel<NCMP, P, kLogT>, x, x, n, log_c,
                          plan, stream, x, log_c, invert, ascending);
  }
  return launch_tile<P>(chunk_sort_kernel<NCMP, P, 0>, x, x, n, log_c, plan,
                        stream, x, log_c, invert, ascending);
}

template <int NCMP, int P>
cudaError_t finish(const Planes& x, int64_t n, int log_t, int invert,
                   int64_t dmask, const int* codes, int64_t phases, int top,
                   cudaStream_t stream) {
  TilePlan plan;
  if (!make_plan<max_fusion(P)>(codes, phases, log_t, &plan) ||
      (top && (log_t != top_log_t(P) ||
               decode_phase(plan.code[0]).kk_a < log_t ||
               !is_top_plan<P>(plan, log_t, decode_phase(plan.code[0]).kk_a,
                               0)))) {
    return cudaErrorInvalidValue;
  }
  if (top) {
    return launch_tile<P>(finish_kernel<NCMP, P, top_log_t(P)>, x, x, n,
                          log_t, plan, stream, x, log_t, invert, dmask);
  }
  return launch_tile<P>(finish_kernel<NCMP, P, 0>, x, x, n, log_t, plan,
                        stream, x, log_t, invert, dmask);
}

template <int NCMP, int P>
cudaError_t chunk_sort_cyclic(const Planes& in, const Planes& out, int64_t n,
                              int log_t, int log_c, const int* codes,
                              int64_t phases, int top, cudaStream_t stream) {
  constexpr int kLogT = top_log_t(P);
  TilePlan plan;
  if (log_t > log_c || log_c < kCyclicLog || log_c > 62 ||
      (n >> log_c) << log_c != n ||
      !make_plan<max_fusion(P)>(codes, phases, log_t, &plan) ||
      (top && (!radix_top(P) || log_t != kLogT ||
               !is_top_plan<P>(plan, kLogT, 0, 0)))) {
    return cudaErrorInvalidValue;
  }
  if constexpr (radix_top(P)) {
    if (top) {
      return launch_tile<P>(chunk_sort_cyclic_kernel<NCMP, P, kLogT>, in, out,
                            n, log_t, plan, stream, in, out, log_t, log_c,
                            n >> log_c);
    }
  }
  return launch_tile<P>(chunk_sort_cyclic_kernel<NCMP, P, 0>, in, out, n,
                        log_t, plan, stream, in, out, log_t, log_c,
                        n >> log_c);
}

// The slot merge of slots of 2^LOG_S rows on its compile-time plan over
// the mode's tile; only a radix_top mode and kMinSlotLog <= LOG_S < the
// tile have a kernel.
template <int LOG_S, int NCMP, int P>
cudaError_t launch_slot_top(const Planes& in, const Planes& out, int64_t n,
                            int64_t cmask, const TilePlan& plan,
                            cudaStream_t stream) {
  constexpr int kLogT = top_log_t(P);
  if constexpr (!radix_top(P) || LOG_S >= kLogT) {
    return cudaErrorInvalidValue;
  } else {
    return launch_tile<P>(slot_merge_kernel<NCMP, P, kLogT, LOG_S>, in, out,
                          n, kLogT, plan, stream, in, out, kLogT, LOG_S,
                          cmask);
  }
}

// The plan is empty exactly when the slot is at least the tile.
template <int NCMP, int P>
cudaError_t slot_merge(const Planes& in, const Planes& out, int64_t n,
                       int log_t, int log_s, int log_c, const int* codes,
                       int64_t phases, int top, cudaStream_t stream) {
  TilePlan plan;
  const bool copy = log_s >= log_t;
  if (log_t > log_c || log_s < 0 || log_s >= log_c || log_c > 62 ||
      (n >> log_c) << log_c != n || (copy && phases != 0) ||
      !make_plan<max_fusion(P)>(codes, phases, log_t, &plan, copy ? 0 : 1) ||
      (top && (!radix_top(P) || log_t != top_log_t(P) ||
               log_s < kMinSlotLog || copy ||
               !is_top_plan<P>(plan, log_t, log_s + 1, 0)))) {
    return cudaErrorInvalidValue;
  }
  const int64_t cmask = (static_cast<int64_t>(1) << log_c) - 1;
  if (!top) {
    return launch_tile<P>(slot_merge_kernel<NCMP, P, 0, 0>, in, out, n, log_t,
                          plan, stream, in, out, log_t, log_s, cmask);
  }
  static_assert(top_log_t(1) - 1 <= kMinSlotLog + 3, "a case a slot");
  switch (log_s - kMinSlotLog) {
    case 0:
      return launch_slot_top<kMinSlotLog, NCMP, P>(in, out, n, cmask, plan,
                                                   stream);
    case 1:
      return launch_slot_top<kMinSlotLog + 1, NCMP, P>(in, out, n, cmask,
                                                       plan, stream);
    case 2:
      return launch_slot_top<kMinSlotLog + 2, NCMP, P>(in, out, n, cmask,
                                                       plan, stream);
    case 3:
      return launch_slot_top<kMinSlotLog + 3, NCMP, P>(in, out, n, cmask,
                                                       plan, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The strided tile pass of F distances on its compile-time plan; only F in
// R < F <= cross_fusion(P) of a mode with cross_top has a kernel.
template <int F, int NCMP, int P>
cudaError_t launch_cross_top(const Planes& x, int64_t n, int j_low, int kk,
                             int invert, int64_t dmask, const TilePlan& plan,
                             cudaStream_t stream) {
  if constexpr (!cross_top(P) || F <= max_fusion(P) || F > cross_fusion(P)) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int kLogT = cross_log_t(P);
    return launch_tile<P>(cross_stage_kernel<F, NCMP, P>, x, x, n, kLogT,
                          plan, stream, x, n, n, j_low, kk, F, kLogT - F,
                          invert, dmask);
  }
}

// A pass of f distances from 2^j_low: the register pass for f <= R, else
// the strided tile pass over tiles of 2^f segments of 2^log_l rows, whose
// plan runs exactly the tile's bits log_l+f-1 .. log_l (`top`: on its
// compile-time plan, over the mode's cross tile).
template <int NCMP, int P>
cudaError_t cross(const Planes& x, int64_t n, int64_t rows, int j_low, int f,
                  int kk, int log_l, int invert, int64_t dmask,
                  const int* codes, int64_t phases, int top,
                  cudaStream_t stream) {
  if (f < 1 || j_low + f > kk || kk > 62 ||
      (n >> (j_low + f)) << (j_low + f) != n || n < 1 || rows > n ||
      (rows != n && (f != 1 || n != static_cast<int64_t>(2) << j_low ||
                     rows <= n / 2))) {
    return cudaErrorInvalidValue;
  }
  if (f <= max_fusion(P)) {
    if (top) return cudaErrorInvalidValue;
    switch (f) {
      case 1:
        return launch_cross<1, NCMP, P>(x, n, rows, j_low, kk, invert, dmask,
                                        stream);
      case 2:
        return launch_cross<2, NCMP, P>(x, n, rows, j_low, kk, invert, dmask,
                                        stream);
      case 3:
        return launch_cross<3, NCMP, P>(x, n, rows, j_low, kk, invert, dmask,
                                        stream);
      default:
        return launch_cross<4, NCMP, P>(x, n, rows, j_low, kk, invert, dmask,
                                        stream);
    }
  }
  TilePlan plan;
  const int log_t = log_l + f;
  if (log_l < 0 || log_l > j_low || log_t > 15 ||
      !make_plan<max_fusion(P)>(codes, phases, log_t, &plan) ||
      decode_phase(plan.code[0]).kk_a != kk ||
      decode_phase(plan.code[0]).hi != log_t - 1 ||
      decode_phase(plan.code[plan.n - 1]).lo != log_l ||
      (top && (log_t != cross_log_t(P) ||
               !is_top_plan<P>(plan, log_t, kk, log_l)))) {
    return cudaErrorInvalidValue;
  }
  if (!top) {
    return launch_tile<P>(cross_stage_kernel<0, NCMP, P>, x, x, n, log_t,
                          plan, stream, x, n, n, j_low, kk, f, log_l, invert,
                          dmask);
  }
  switch (f) {
    case 3:
      return launch_cross_top<3, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 4:
      return launch_cross_top<4, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 5:
      return launch_cross_top<5, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 6:
      return launch_cross_top<6, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 7:
      return launch_cross_top<7, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 8:
      return launch_cross_top<8, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 9:
      return launch_cross_top<9, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                          plan, stream);
    case 10:
      return launch_cross_top<10, NCMP, P>(x, n, j_low, kk, invert, dmask,
                                           plan, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launches as functors over the template instance (NCMP, P).
struct ChunkSortLaunch {
  Planes x;
  int64_t n;
  int log_c, invert, ascending;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return chunk_sort<NCMP, P>(x, n, log_c, invert, ascending, plan, phases,
                               top, stream);
  }
};

struct FinishLaunch {
  Planes x;
  int64_t n;
  int log_t, invert;
  int64_t dmask;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return finish<NCMP, P>(x, n, log_t, invert, dmask, plan, phases, top,
                           stream);
  }
};

struct CrossLaunch {
  Planes x;
  int64_t n, rows;
  int j_low, f, kk, log_l, invert;
  int64_t dmask;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return cross<NCMP, P>(x, n, rows, j_low, f, kk, log_l, invert, dmask,
                          plan, phases, top, stream);
  }
};

struct CyclicLaunch {
  Planes in, out;
  int64_t n;
  int log_t, log_c;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return chunk_sort_cyclic<NCMP, P>(in, out, n, log_t, log_c, plan, phases,
                                      top, stream);
  }
};

struct SlotMergeLaunch {
  Planes in, out;
  int64_t n;
  int log_t, log_s, log_c;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    return slot_merge<NCMP, P>(in, out, n, log_t, log_s, log_c, plan, phases,
                               top, stream);
  }
};

// The direction mask of a span of 2^log_span keys.
int64_t span_mask(int64_t log_span) {
  return log_span >= 63 ? -1 : (static_cast<int64_t>(1) << log_span) - 1;
}

}  // namespace

extern "C" {

// In every entry point `planes` points to np device pointers (plane 0 the
// keys), and ncmp is 1 (np = 1 or 2) or 2 (np = 2..8).

// `plan` points to `phases` packed phases of the tile pass
// (kernels/bitonic.py::tile_plan for R = max_fusion(np)).  In every entry
// point that takes it, `top` runs the plan on its compile-time layout
// (kernels/bitonic.py::compile_time_plan): the mode's chunk tile (chunk
// sort, cyclic chunk sort), a level at or above the mode's finish tile, a
// strided pass over the mode's cross tile, the levels above a slot of
// 2^10 .. half the mode's tile; any other plan is then refused.
int radx_chunk_sort(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                    int64_t log_c, int64_t invert, int64_t ascending,
                    const int* plan, int64_t phases, int64_t top,
                    void* stream) {
  ChunkSortLaunch launch;
  if (!make_planes(planes, np, &launch.x)) return cudaErrorInvalidValue;
  launch.n = n;
  launch.log_c = static_cast<int>(log_c);
  launch.invert = static_cast<int>(invert);
  launch.ascending = static_cast<int>(ascending);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// log_span: directions from the index within blocks of 2^log_span keys; the
// level is in the plan.
int radx_finish(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                int64_t log_t, int64_t invert, int64_t log_span,
                const int* plan, int64_t phases, int64_t top, void* stream) {
  FinishLaunch launch;
  if (!make_planes(planes, np, &launch.x)) return cudaErrorInvalidValue;
  launch.n = n;
  launch.log_t = static_cast<int>(log_t);
  launch.invert = static_cast<int>(invert);
  launch.dmask = span_mask(log_span);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// Distances 2^(j_low+f-1) .. 2^j_low of level kk.  Above R =
// max_fusion(np) distances, over tiles of 2^f segments of 2^log_l rows by
// the plan tile_plan(log_l + f, kk, kk, R, log_l); at most R, in registers
// (log_l and the plan unused: null and 0; top 0).  rows: the planes hold the
// first `rows` rows of the n: n itself, or the valley merge's overhang (f =
// 1, n = 2^(j_low+1), rows > n / 2: only the pairs with both rows present
// are exchanged).
int radx_cross_stage(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                     int64_t rows, int64_t j_low, int64_t f, int64_t kk,
                     int64_t log_l, int64_t invert, int64_t log_span,
                     const int* plan, int64_t phases, int64_t top,
                     void* stream) {
  CrossLaunch launch;
  if (!make_planes(planes, np, &launch.x)) return cudaErrorInvalidValue;
  launch.n = n;
  launch.rows = rows;
  launch.j_low = static_cast<int>(j_low);
  launch.f = static_cast<int>(f);
  launch.kk = static_cast<int>(kk);
  launch.log_l = static_cast<int>(log_l);
  launch.invert = static_cast<int>(invert);
  launch.dmask = span_mask(log_span);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// `in` and `out` point to np planes each (distinct buffers); n keys per
// plane, radix chunks of 2^log_c keys, shared-memory tiles of 2^log_t; the
// plan of stages 1..log_t (kernels/bitonic.py::tile_plan).
int radx_chunk_sort_cyclic(void* const* in, void* const* out, int64_t np,
                           int64_t ncmp, int64_t n, int64_t log_t,
                           int64_t log_c, const int* plan, int64_t phases,
                           int64_t top, void* stream) {
  CyclicLaunch launch;
  if (!make_planes(in, np, &launch.in) || !make_planes(out, np, &launch.out)) {
    return cudaErrorInvalidValue;
  }
  launch.n = n;
  launch.log_t = static_cast<int>(log_t);
  launch.log_c = static_cast<int>(log_c);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// Slots of 2^log_s keys inside radix chunks of 2^log_c keys; the plan of
// levels log_s + 1 .. log_t, empty when log_s >= log_t.
int radx_slot_merge(void* const* in, void* const* out, int64_t np,
                    int64_t ncmp, int64_t n, int64_t log_t, int64_t log_s,
                    int64_t log_c, const int* plan, int64_t phases,
                    int64_t top, void* stream) {
  SlotMergeLaunch launch;
  if (!make_planes(in, np, &launch.in) || !make_planes(out, np, &launch.out)) {
    return cudaErrorInvalidValue;
  }
  launch.n = n;
  launch.log_t = static_cast<int>(log_t);
  launch.log_s = static_cast<int>(log_s);
  launch.log_c = static_cast<int>(log_c);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

const char* radx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
