// Host oracle: tiled LSD radix sort of uint32 keys (+ payload) on the CPU.
//
// The port's own copy of cpp/oracle.cc (the JAX package's oracle), so that
// radx_tpu_torch needs nothing outside its package: radx_tpu_torch/oracle/
// native.py builds it with g++ into radx_tpu_torch/_build/ at first use.
// Native counterpart of radx_tpu_torch/oracle/cpu.py: RadX's three-phase
// pass (counting -> partition -> scattering) with the same tile blocking,
// so the NumPy and C++ oracles agree bit for bit, and both are independent
// of torch: the card's sort is held against them (BASELINE config 1).
//
// A plain C ABI, bound with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Config {
  uint32_t bits_per_pass;
  uint32_t tile_elems;
};

// One LSD pass: per-tile histogram, two-level exclusive scan, stable
// rank-and-scatter.  Ping-pong between src and dst.
void radix_pass(const uint32_t* keys_in, uint32_t* keys_out,
                const uint32_t* pay_in, uint32_t* pay_out, size_t n,
                uint32_t shift, const Config& cfg,
                std::vector<int64_t>& counts, std::vector<int64_t>& cursor) {
  const uint32_t radix = 1u << cfg.bits_per_pass;
  const uint32_t mask = radix - 1;
  const size_t tile = cfg.tile_elems;
  const size_t ntiles = (n + tile - 1) / tile;

  counts.assign(ntiles * radix, 0);
  // Phase 1: counting.comp — per-tile digit histogram.
  for (size_t t = 0; t < ntiles; ++t) {
    const size_t lo = t * tile, hi = lo + tile < n ? lo + tile : n;
    int64_t* c = counts.data() + t * radix;
    for (size_t i = lo; i < hi; ++i) c[(keys_in[i] >> shift) & mask]++;
  }

  // Phase 2: partition.comp — exclusive scan over tiles within each digit,
  // then exclusive scan of digit totals, summed into a global base.
  // cursor[t*radix + k] becomes the running write position for (tile, digit).
  cursor.assign(ntiles * radix, 0);
  int64_t digit_base = 0;
  for (uint32_t k = 0; k < radix; ++k) {
    int64_t running = digit_base;
    for (size_t t = 0; t < ntiles; ++t) {
      cursor[t * radix + k] = running;
      running += counts[t * radix + k];
    }
    digit_base = running;
  }

  // Phase 3: scattering.comp — stable scatter; the cursor increments play the
  // role of intra-tile ranks (LSB-lane ordered, scattering.comp:94-102).
  for (size_t t = 0; t < ntiles; ++t) {
    const size_t lo = t * tile, hi = lo + tile < n ? lo + tile : n;
    int64_t* cur = cursor.data() + t * radix;
    for (size_t i = lo; i < hi; ++i) {
      const uint32_t d = (keys_in[i] >> shift) & mask;
      const int64_t pos = cur[d]++;
      keys_out[pos] = keys_in[i];
      if (pay_in) pay_out[pos] = pay_in[i];
    }
  }
}

void sort_impl(const uint32_t* keys, const uint32_t* payload, uint32_t* out_k,
               uint32_t* out_p, size_t n, uint32_t bits_per_pass,
               uint32_t tile_elems) {
  Config cfg{bits_per_pass, tile_elems};
  const uint32_t passes = (32 + bits_per_pass - 1) / bits_per_pass;
  std::vector<uint32_t> swap_k(n), swap_p(payload ? n : 0);
  std::vector<int64_t> counts, cursor;

  const uint32_t* src_k = keys;
  const uint32_t* src_p = payload;
  // Ping-pong so the final pass lands in out_k/out_p.
  for (uint32_t p = 0; p < passes; ++p) {
    const bool last_even = ((passes - p) % 2) == 1;  // odd passes remaining
    uint32_t* dst_k = last_even ? out_k : swap_k.data();
    uint32_t* dst_p = payload ? (last_even ? out_p : swap_p.data()) : nullptr;
    radix_pass(src_k, dst_k, src_p, dst_p, n, p * bits_per_pass, cfg, counts,
               cursor);
    src_k = dst_k;
    src_p = dst_p;
  }
}

}  // namespace

extern "C" {

// Sort n uint32 keys ascending (stable). out must not alias keys.
void radx_oracle_sort_u32(const uint32_t* keys, uint32_t* out, size_t n,
                          uint32_t bits_per_pass, uint32_t tile_elems) {
  sort_impl(keys, nullptr, out, nullptr, n, bits_per_pass, tile_elems);
}

// Stable key+payload sort.
void radx_oracle_sort_pairs(const uint32_t* keys, const uint32_t* payload,
                            uint32_t* out_keys, uint32_t* out_payload,
                            size_t n, uint32_t bits_per_pass,
                            uint32_t tile_elems) {
  sort_impl(keys, payload, out_keys, out_payload, n, bits_per_pass,
            tile_elems);
}

// Single pass (for phase-level parity tests): writes keys_out and the
// per-tile histogram (ntiles x radix, int64 row-major) into counts_out.
void radx_oracle_radix_pass(const uint32_t* keys, uint32_t* keys_out,
                            size_t n, uint32_t shift, uint32_t bits_per_pass,
                            uint32_t tile_elems, int64_t* counts_out) {
  Config cfg{bits_per_pass, tile_elems};
  std::vector<int64_t> counts, cursor;
  radix_pass(keys, keys_out, nullptr, nullptr, n, shift, cfg, counts, cursor);
  std::memcpy(counts_out, counts.data(), counts.size() * sizeof(int64_t));
}

}  // extern "C"
