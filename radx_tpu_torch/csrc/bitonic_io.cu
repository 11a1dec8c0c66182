// A sort's first and last launches on Hopper (sm_90a): the bitonic chunk
// sort and the radix sort's cyclic chunk sort that read the caller's
// columns, and the finish pass that writes the keys back unbiased.  They
// run the register tile engine of csrc/tile_engine.cuh with the loads and
// stores of a sort's edges (Sources, CyclicSources, KeyOut); the network,
// its tiles and its plans are those of csrc/bitonic.cu's chunk_sort,
// chunk_sort_cyclic and finish, bit for bit.
//
// Before, every sort built its planes with PyTorch before the first kernel
// (the padded plane filled, the keys' sign bias XORed into a temporary and
// copied in, the index plane written, the rider plane filled and copied)
// and read the keys back with one more pass after the last one (the bias
// XORed out).  Here those passes are gone: the chunk sort already reads and
// writes every plane once, and so does the last finish.
//
//   chunk_sort (source form) <- radx_tpu/kernels/bitonic.py::
//                  _chunk_sort_kernel (:198), and the XLA preparation of
//                  radx_tpu/ops/sort.py:100-102 (bias, pads, index).  The
//                  first phase reads each plane's rows from its source
//                  (Sources): a uint32 column XORed with 0x80000000, the
//                  join's two key columns back to back, a 32-bit rider
//                  column, or an index made from the row; rows past the
//                  sources get the pads the callers wrote before.  The
//                  planes are written out of place, into buffers the
//                  caller allocates without a fill.  Where the array is one
//                  chunk, this is also the sort's last launch and its store
//                  unbiases plane 0 (KeyOut).
//   chunk_sort_cyclic (source form) <- radx_tpu/kernels/bitonic.py::
//                  _chunk_sort_cyclic_kernel (:217), and the same
//                  preparation of the radix sort's planes.  Radix phase 1
//                  with its first phase reading tile row i of radix chunk c
//                  from the source row that the block-cyclic map gives
//                  (CyclicSources: the cyclic map composed with the
//                  sources), the planes written out of place as the
//                  in-place kernel writes its output.  The radix sort's
//                  last launch, radix_concat's unbiasing form, is in
//                  csrc/radix.cu.
//   finish (unbiasing form) <- radx_tpu/kernels/bitonic.py::_finishw_kernel
//                  (:427), and radx_tpu/ops/sort.py:118 (the bias XORed
//                  out).  The sort's last level: its last phase writes plane
//                  0 XORed with 0x80000000, in place or into the caller's
//                  output of its real rows (the pads past them not stored);
//                  the other planes go back in place.
//
// Bound on the card: as chunk_sort, chunk_sort_cyclic and finish (integer
// operations and the shared-memory phases' instructions); the source load
// and the unbiasing store add no pass and no byte.  Modes: keys, (key,
// rider) and lex2, the modes of the sorts whose planes they make
// (kernels/bitonic.py SOURCE_MODES); each on the mode's own tile (the plan
// laid out at compile time, top_pass) and on any other tile (the plan read
// at run time, tile_pass).  The kernel functions are overloads of
// chunk_sort_kernel, chunk_sort_cyclic_kernel and finish_kernel, so a trace
// counts them in their in-place kernels' families.

#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"
#include "tile_engine.cuh"

namespace {

// chunk_sort's source form: stages 1..log_c of every chunk of x's planes,
// read from `src` (its base: the piece's first source row), plane 0 stored
// through `out` (out.key: plane 0 itself with xr = 0, or the unbiasing
// store of a sort's only launch).  Directions as chunk_sort's (the index
// within the planes, `invert`).  The launch bound asks for three blocks an
// SM, as many as the tile's shared memory allows (64 KB at the modes' own
// tiles): the source load's two paths a plane took the two-plane kernels
// to 86 registers a thread, two blocks an SM, and 18% more time than the
// in-place chunk_sort (one H100, PERF.md); at most 80 keep three.
template <int NCMP, int P, int LOG_T>
__global__ void __launch_bounds__(kTileThreads, 3)
    chunk_sort_kernel(Planes x, Sources<P> src, KeyOut out, int log_c,
                      int invert, TilePlan plan, int vec) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_c;
  Sources<P> map = src;
  map.base = src.base + base;
  KeyOut omap = out;
  omap.base = base;
  if constexpr (LOG_T == 0) {
    tile_pass<NCMP, P>(x, x, map, omap, log_c, plan, base, invert, vec != 0);
  } else {
    extern __shared__ int top_smem[];
    top_pass<NCMP, P, LOG_T, 0, 0, 0>(
        x, x, top_smem, map, omap,
        invert ^ static_cast<int>((base >> LOG_T) & 1), invert, vec != 0);
  }
}

// chunk_sort_cyclic's source form: radix phase 1 (stages 1..log_t of every
// radix chunk, whose 1024-row tiles are taken block-cyclically), tile row i
// of radix chunk c read from source row src.base + Cyclic{lb, c,
// n_chunks}(i), the tile written contiguously to x at b << log_t, as
// csrc/bitonic.cu's chunk_sort_cyclic_kernel writes `out`.  The sort goes
// on after it, so every plane is stored as it is.  The launch bound is the
// chunk sort's source form's: three blocks an SM.
template <int NCMP, int P, int LOG_T>
__global__ void __launch_bounds__(kTileThreads, 3)
    chunk_sort_cyclic_kernel(Planes x, CyclicSources<P> src, int log_t,
                             int log_c, int64_t n_chunks, TilePlan plan,
                             int vec) {
  const int lt = LOG_T == 0 ? log_t : LOG_T;
  const int64_t tile = blockIdx.x;
  const int64_t lb = (tile << lt) & ((static_cast<int64_t>(1) << log_c) - 1);
  CyclicSources<P> map = src;
  map.cyclic = Cyclic{lb, tile >> (log_c - lt), n_chunks};
  const Contiguous omap{tile << lt};
  if constexpr (LOG_T == 0) {
    tile_pass<NCMP, P>(x, x, map, omap, log_t, plan, lb, 0, vec != 0);
  } else {
    extern __shared__ int top_smem[];
    top_pass<NCMP, P, LOG_T, 0, 0, 0>(x, x, top_smem, map, omap,
                                      static_cast<int>((lb >> LOG_T) & 1), 0,
                                      vec != 0);
  }
}

// finish's unbiasing form: level kk (the plan's) below the tile, in place,
// plane 0 stored through `out` (xr = 0x80000000).
template <int NCMP, int P, int LOG_T>
__global__ void __launch_bounds__(kTileThreads, 1)
    finish_kernel(Planes x, KeyOut out, int log_t, int invert, int64_t dmask,
                  TilePlan plan, int vec) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) << (LOG_T == 0 ? log_t : LOG_T);
  const Contiguous map{base};
  KeyOut omap = out;
  omap.base = base;
  if constexpr (LOG_T == 0) {
    tile_pass<NCMP, P>(x, x, map, omap, log_t, plan, base & dmask, invert,
                       vec != 0);
  } else {
    extern __shared__ int top_smem[];
    const int kk = decode_phase(plan.code[0]).kk_a;
    const int flip = invert ^ static_cast<int>(((base & dmask) >> kk) & 1);
    top_pass<NCMP, P, LOG_T, LOG_T, 0, 0>(x, x, top_smem, map, omap, flip,
                                          invert, vec != 0);
  }
}

constexpr int kSourceFields = 10;

// A plane's source from its packed fields (kernels/bitonic.py
// _source_fields): index, col0, col1, n, split, xr, add0, add1, pad,
// pad_row.  A column must have its pointers where it has rows.
bool make_source(const int64_t* f, PlaneSource* s) {
  const int64_t n = f[3], split = f[4];
  s->index = static_cast<int>(f[0] != 0);
  s->col0 = reinterpret_cast<const int*>(f[1]);
  s->col1 = reinterpret_cast<const int*>(f[2]);
  s->n = n;
  s->split = split;
  s->xr = static_cast<int>(f[5]);
  s->add0 = static_cast<int>(f[6]);
  s->add1 = static_cast<int>(f[7]);
  s->pad = static_cast<int>(f[8]);
  s->pad_row = static_cast<int>(f[9] != 0);
  if (n < 0 || split < 0 || split > n ||
      n > (static_cast<int64_t>(1) << 31)) {
    return false;
  }
  return s->index || ((split == 0 || s->col0 != nullptr) &&
                      (split == n || s->col1 != nullptr));
}

// A chunk sort's plan starts with register window 0, so the source load
// takes a thread's rows as one run (rows_from_sources).
bool first_phase_runs(const TilePlan& plan) {
  return decode_phase(plan.code[0]).wlo == 0;
}

// The P planes' sources, kSourceFields packed fields each.
template <int P>
bool make_sources(const int64_t* fields, PlaneSource (&s)[P]) {
  for (int j = 0; j < P; ++j) {
    if (!make_source(fields + kSourceFields * j, &s[j])) return false;
  }
  return true;
}

struct ChunkSourceLaunch {
  Planes x;
  const int64_t* fields;
  int64_t row0, n;
  KeyOut out;
  int log_c, invert;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    constexpr int kLogT = top_log_t(P);
    Sources<P> src;
    if (!make_sources<P>(fields, src.s)) return cudaErrorInvalidValue;
    src.base = row0;
    TilePlan tp;
    if (!make_plan<max_fusion(P)>(plan, phases, log_c, &tp) ||
        !first_phase_runs(tp) ||
        (top && (log_c != kLogT || !is_top_plan<P>(tp, kLogT, 0, 0)))) {
      return cudaErrorInvalidValue;
    }
    if (top) {
      return launch_tile<P>(chunk_sort_kernel<NCMP, P, kLogT>, x, x, n,
                            log_c, tp, stream, x, src, out, log_c, invert);
    }
    return launch_tile<P>(chunk_sort_kernel<NCMP, P, 0>, x, x, n, log_c, tp,
                          stream, x, src, out, log_c, invert);
  }
};

struct CyclicSourceLaunch {
  Planes x;
  const int64_t* fields;
  int64_t row0, n;
  int log_t, log_c;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    constexpr int kLogT = top_log_t(P);
    static_assert(radix_top(P), "every source mode has K4's top plan");
    CyclicSources<P> src;
    if (!make_sources<P>(fields, src.s)) return cudaErrorInvalidValue;
    src.base = row0;
    src.cyclic = Cyclic{0, 0, 1};  // each block sets its own
    TilePlan tp;
    if (log_t > log_c || log_c < kCyclicLog || log_c > 62 ||
        (n >> log_c) << log_c != n ||
        !make_plan<max_fusion(P)>(plan, phases, log_t, &tp) ||
        !first_phase_runs(tp) ||
        (top && (log_t != kLogT || !is_top_plan<P>(tp, kLogT, 0, 0)))) {
      return cudaErrorInvalidValue;
    }
    if (top) {
      return launch_tile<P>(chunk_sort_cyclic_kernel<NCMP, P, kLogT>, x, x,
                            n, log_t, tp, stream, x, src, log_t, log_c,
                            n >> log_c);
    }
    return launch_tile<P>(chunk_sort_cyclic_kernel<NCMP, P, 0>, x, x, n,
                          log_t, tp, stream, x, src, log_t, log_c,
                          n >> log_c);
  }
};

struct FinishOutLaunch {
  Planes x;
  int64_t n;
  KeyOut out;
  int log_t, invert;
  int64_t dmask;
  const int* plan;
  int64_t phases;
  int top;
  cudaStream_t stream;
  template <int NCMP, int P>
  cudaError_t operator()() const {
    TilePlan tp;
    if (!make_plan<max_fusion(P)>(plan, phases, log_t, &tp) ||
        (top && (log_t != top_log_t(P) ||
                 decode_phase(tp.code[0]).kk_a < log_t ||
                 !is_top_plan<P>(tp, log_t, decode_phase(tp.code[0]).kk_a,
                                 0)))) {
      return cudaErrorInvalidValue;
    }
    if (top) {
      return launch_tile<P>(finish_kernel<NCMP, P, top_log_t(P)>, x, x, n,
                            log_t, tp, stream, x, out, log_t, invert, dmask);
    }
    return launch_tile<P>(finish_kernel<NCMP, P, 0>, x, x, n, log_t, tp,
                          stream, x, out, log_t, invert, dmask);
  }
};

// plane 0's store: `key` (np planes' row 0 on) for its first `key_rows`
// rows, XORed with key_xor.
bool make_key_out(void* key, int64_t key_rows, int64_t key_xor, KeyOut* o) {
  o->base = 0;
  o->key = static_cast<int*>(key);
  o->rows = key_rows;
  o->xr = static_cast<int>(key_xor);
  return key_rows >= 0 && (key != nullptr || key_rows == 0);
}

}  // namespace

extern "C" {

// chunk_sort reading sources: `planes` the np output planes of n rows
// (chunks of 2^log_c, sorted as chunk_sort sorts them), `sources` np x 10
// packed fields (make_source), row0 the sources' row of the planes' row 0;
// plane 0 stored to `key` (its first key_rows rows, XORed with key_xor).
// `plan`, `phases` and `top` as radx_chunk_sort's.
int radx_chunk_sort_src(void* const* planes, int64_t np, int64_t ncmp,
                        int64_t n, int64_t log_c, int64_t invert,
                        const int64_t* sources, int64_t row0, void* key,
                        int64_t key_rows, int64_t key_xor, const int* plan,
                        int64_t phases, int64_t top, void* stream) {
  ChunkSourceLaunch launch;
  if (!make_planes(planes, np, &launch.x) || sources == nullptr ||
      row0 < 0 || !make_key_out(key, key_rows, key_xor, &launch.out)) {
    return cudaErrorInvalidValue;
  }
  launch.fields = sources;
  launch.row0 = row0;
  launch.n = n;
  launch.log_c = static_cast<int>(log_c);
  launch.invert = static_cast<int>(invert);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch_edges(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// chunk_sort_cyclic reading sources: `planes` the np output planes of n
// rows (radix chunks of 2^log_c rows, tiles of 2^log_t, sorted as
// radx_chunk_sort_cyclic sorts them), `sources` and row0 as
// radx_chunk_sort_src's.  `plan`, `phases` and `top` as
// radx_chunk_sort_cyclic's.
int radx_chunk_sort_cyclic_src(void* const* planes, int64_t np, int64_t ncmp,
                               int64_t n, int64_t log_t, int64_t log_c,
                               const int64_t* sources, int64_t row0,
                               const int* plan, int64_t phases, int64_t top,
                               void* stream) {
  CyclicSourceLaunch launch;
  if (!make_planes(planes, np, &launch.x) || sources == nullptr || row0 < 0) {
    return cudaErrorInvalidValue;
  }
  launch.fields = sources;
  launch.row0 = row0;
  launch.n = n;
  launch.log_t = static_cast<int>(log_t);
  launch.log_c = static_cast<int>(log_c);
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch_edges(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

// finish storing plane 0 unbiased: as radx_finish, plane 0 to `key` (its
// first key_rows rows, XORed with key_xor).
int radx_finish_out(void* const* planes, int64_t np, int64_t ncmp, int64_t n,
                    int64_t log_t, int64_t invert, int64_t log_span,
                    void* key, int64_t key_rows, int64_t key_xor,
                    const int* plan, int64_t phases, int64_t top,
                    void* stream) {
  FinishOutLaunch launch;
  if (!make_planes(planes, np, &launch.x) ||
      !make_key_out(key, key_rows, key_xor, &launch.out)) {
    return cudaErrorInvalidValue;
  }
  launch.n = n;
  launch.log_t = static_cast<int>(log_t);
  launch.invert = static_cast<int>(invert);
  launch.dmask = log_span >= 63 ? -1
                                : (static_cast<int64_t>(1) << log_span) - 1;
  launch.plan = plan;
  launch.phases = phases;
  launch.top = static_cast<int>(top != 0);
  launch.stream = static_cast<cudaStream_t>(stream);
  return dispatch_edges(static_cast<int>(ncmp), static_cast<int>(np), launch);
}

}  // extern "C"
