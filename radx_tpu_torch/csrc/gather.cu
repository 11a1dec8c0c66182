// Gather of int32 value planes by an int32 index plane for Hopper (sm_90a).
//
// No Pallas kernel has this job.  On the TPU a gather is slow, so the JAX
// package pushes every value plane through the sort network beside the
// compare planes (radx_tpu/ops/join.py:70, the join's tagged union over
// (key, tie, build value, probe value); radx_tpu/ops/sort.py:136, the
// stable sorts over (key, index, payloads...)).  On the card the network's
// cost grows with its plane count (a lex4 sort takes 2.3x a lex2 sort of
// the same rows), so the port sorts only the two compare planes and this
// kernel then fetches the value planes by the tie or index plane, which is
// unique for every real row.
//
// Two modes over an index plane `idx` of n rows:
//   * index:  out_g[i] = src_g[idx[i]] for G = 1..4 source planes in one
//             launch (the stable sorts' payloads by their original index);
//   * tagged: two outputs from the join's tie plane: a tie t < 2^30 is
//             build row t (bval = build[t], pval = 0), 2^30 <= t <
//             0x7FFFFFFF is probe row t - 2^30 (bval = 0, pval =
//             probe[t - 2^30]), and the pad tie 0x7FFFFFFF gives 0 and 0:
//             the values a four-plane sort leaves in those rows.
// An index outside its source's rows reads nothing and gives 0 (so a pad
// never reads a source).
//
// Bound on the card: device-memory bandwidth, and in practice the random
// reads: each row reads 4 bytes of index and writes 4 bytes a plane, both
// coalesced, and reads 4 bytes a plane at a random place, which costs the
// DRAM one 32-byte sector.  The design keeps many of those reads in flight:
//   * a block takes a tile of kTile = 4096 rows; in round v thread t loads
//     the 16-byte index vector v * kThreads + t of the tile (coalesced), so
//     a thread holds kVecs x 4 = 16 indices;
//   * it issues all 16 x G random reads (read-only path, no dependence
//     between them) before the first store, then writes each plane's rows
//     as 16-byte vectors at the positions of their indices (coalesced);
//   * the ragged last tile, or planes not 16-byte aligned, take a scalar
//     loop (one row a thread per step).
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte index vectors a thread
constexpr int kTile = kThreads * kVecs * 4;
constexpr int kMaxPlanes = 4;
constexpr int kProbeTie = 1 << 30;
constexpr int kPadTie = 0x7FFFFFFF;

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
// tagged mode (one read: the side that the tie names).
template <int G, bool kTagged>
__device__ __forceinline__ void row(const Args& a, int t, int (&v)[G]) {
  if constexpr (kTagged) {
    const bool probe = t >= kProbeTie;
    const int got = t == kPadTie ? 0
                    : probe      ? take(a.src[1], a.rows[1], t - kProbeTie)
                                 : take(a.src[0], a.rows[0], t);
    v[0] = probe ? 0 : got;
    v[1] = probe ? got : 0;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = take(a.src[g], a.rows[g], t);
  }
}

template <int G, bool kTagged>
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
      for (int q = 0; q < 4; ++q) row<G, kTagged>(a, t[v][q], val[v][q]);
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
    row<G, kTagged>(a, __ldg(a.idx + r), v);
#pragma unroll
    for (int g = 0; g < G; ++g) a.out[g][r] = v[g];
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int G, bool kTagged>
int run(const Args& a, cudaStream_t s) {
  const int64_t blocks = (a.n + kTile - 1) / kTile;
  gather_planes_kernel<G, kTagged>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx: n int32 rows on the card; srcs / outs: host arrays of num_src (1..4;
// 2 when tagged) device pointers, outs of n rows each; rows: a host array
// of the sources' row counts.
int radx_gather_planes(void* idx, int64_t n, void* const* srcs,
                       const int64_t* rows, void* const* outs,
                       int64_t num_src, int64_t tagged, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) * kTile || num_src < 1 ||
      num_src > kMaxPlanes || (tagged && num_src != 2)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.idx = static_cast<const int*>(idx);
  a.n = n;
  a.vec = aligned(idx);
  for (int g = 0; g < num_src; ++g) {
    a.src[g] = static_cast<const int*>(srcs[g]);
    a.rows[g] = rows[g];
    a.out[g] = static_cast<int*>(outs[g]);
    a.vec = a.vec && aligned(outs[g]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tagged) return run<2, true>(a, s);
  switch (num_src) {
    case 1: return run<1, false>(a, s);
    case 2: return run<2, false>(a, s);
    case 3: return run<3, false>(a, s);
    default: return run<4, false>(a, s);
  }
}

}  // extern "C"
