// Host runtime: seeded multithreaded key generators and a sort validator.
//
// The port's own copy of cpp/runtime.cc (the JAX package's runtime), built
// with g++ into radx_tpu_torch/_build/ at first use by
// radx_tpu_torch/runtime/native.py.  It generates the workloads of RadX's
// C++ test harness (a shuffled 0..N-1 permutation, uniform and skewed keys)
// and validates a sorted array in O(N), at memory speed, so that 2^26 to
// 2^30-key host arrays are not bound by NumPy.  Every generator is
// deterministic in its seed on a given machine (the uniform and skewed ones
// seed each thread's chunk by its start, so the thread count matters).
//
// A plain C ABI, bound with ctypes.

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

unsigned hw_threads() {
  unsigned t = std::thread::hardware_concurrency();
  return t ? t : 4;
}

template <typename F>
void parallel_for(size_t n, F&& fn) {
  const unsigned nt = hw_threads();
  std::vector<std::thread> ts;
  ts.reserve(nt);
  const size_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    const size_t lo = t * chunk;
    const size_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi, t); });
  }
  for (auto& th : ts) th.join();
}

// splitmix64: tiny, high-quality, seedable per-chunk generator.
inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// Fill out[0..n) with uniform random uint32 (deterministic in seed).
void radx_rt_gen_uniform(uint32_t* out, size_t n, uint64_t seed) {
  parallel_for(n, [&](size_t lo, size_t hi, unsigned t) {
    uint64_t s = seed + 0x1000003ull * (lo + 1);
    for (size_t i = lo; i < hi; ++i) out[i] = (uint32_t)splitmix64(s);
  });
}

// Shuffled permutation of 0..n-1 — the reference harness's fixture
// (sort.cpp:348-350): sorted output must equal iota, checkable in O(N).
void radx_rt_gen_permutation(uint32_t* out, size_t n, uint64_t seed) {
  parallel_for(n, [&](size_t lo, size_t hi, unsigned) {
    for (size_t i = lo; i < hi; ++i) out[i] = (uint32_t)i;
  });
  std::mt19937_64 rng(seed);
  for (size_t i = n; i > 1; --i) {
    size_t j = rng() % i;
    std::swap(out[i - 1], out[j]);
  }
}

// Zipf-ish skewed keys: digit skew for the distributed-splitter tests.
void radx_rt_gen_skewed(uint32_t* out, size_t n, uint64_t seed,
                        uint32_t hot_lo, uint32_t hot_hi, double hot_frac) {
  parallel_for(n, [&](size_t lo, size_t hi, unsigned) {
    uint64_t s = seed + 0x2000003ull * (lo + 1);
    const uint64_t span = (uint64_t)hot_hi - hot_lo + 1;
    const uint64_t thresh = (uint64_t)(hot_frac * 4294967296.0);
    for (size_t i = lo; i < hi; ++i) {
      uint64_t r = splitmix64(s);
      uint32_t lo32 = (uint32_t)r;
      out[i] = (uint32_t)(r >> 32) < thresh ? hot_lo + (uint32_t)(lo32 % span)
                                            : lo32;
    }
  });
}

// Validate that `sorted` is (a) ascending — exact — and (b) a permutation
// of `orig` — 16-bit marginal counts plus sum / xor / sum-of-squares
// checksums (collision-resistant but not a proof; the bit-exact gate in the
// tests is elementwise comparison against the oracle sort in oracle.cc).
// Returns 0 on success; 1 = not ascending; 2 = multiset mismatch.
int radx_rt_validate_sort(const uint32_t* orig, const uint32_t* sorted,
                          size_t n) {
  std::atomic<int> bad{0};
  parallel_for(n ? n - 1 : 0, [&](size_t lo, size_t hi, unsigned) {
    for (size_t i = lo; i < hi; ++i)
      if (sorted[i] > sorted[i + 1]) {
        bad.store(1);
        return;
      }
  });
  if (bad.load()) return 1;

  const unsigned nt = hw_threads();
  std::vector<int64_t> acc(2 * 65536, 0);
  std::vector<std::vector<int64_t>> per(nt);
  std::vector<std::array<uint64_t, 3>> sums(nt, {0, 0, 0});
  parallel_for(n, [&](size_t lo, size_t hi, unsigned t) {
    auto& mine = per[t];
    mine.assign(2 * 65536, 0);
    auto& s = sums[t];
    for (size_t i = lo; i < hi; ++i) {
      const uint64_t a = orig[i], b = sorted[i];
      mine[a & 0xFFFF]++;
      mine[65536 + (a >> 16)]++;
      mine[b & 0xFFFF]--;
      mine[65536 + (b >> 16)]--;
      s[0] += a - b;
      s[1] ^= a ^ b;
      s[2] += a * a - b * b;
    }
  });
  uint64_t c0 = 0, c1 = 0, c2 = 0;
  for (unsigned t = 0; t < nt; ++t) {
    c0 += sums[t][0];
    c1 ^= sums[t][1];
    c2 += sums[t][2];
  }
  if (c0 || c1 || c2) return 2;
  for (auto& mine : per)
    for (size_t k = 0; k < mine.size(); ++k) acc[k] += mine[k];
  for (int64_t v : acc)
    if (v) return 2;
  return 0;
}

}  // extern "C"
