// The plane struct and the compare-mode dispatch shared by the kernels that
// move P int32 planes (csrc/bitonic.cu, csrc/radix.cu).
//
// A sort's planes arrive as a by-value struct of up to 8 device pointers,
// plane 0 the sign-biased keys.  Every kernel over planes is templated on
// (NCMP, P):
//
//   (1, 1)      keys only;
//   (1, 2)      keys and one rider ("/rider");
//   (2, 2..8)   lexicographic ("/lex<P>"): planes 0 and 1 compare as signed
//               int32, planes 2..P-1 ride along.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;

struct Planes {
  int* p[kMaxPlanes];
};

// Run `launch` with the template instance of (ncmp, np): (1, 1), (1, 2) or
// (2, 2..8).
template <typename Launch>
cudaError_t dispatch(int ncmp, int np, const Launch& launch) {
  if (ncmp == 1) {
    switch (np) {
      case 1: return launch.template operator()<1, 1>();
      case 2: return launch.template operator()<1, 2>();
      default: return cudaErrorInvalidValue;
    }
  }
  if (ncmp != 2) return cudaErrorInvalidValue;
  switch (np) {
    case 2: return launch.template operator()<2, 2>();
    case 3: return launch.template operator()<2, 3>();
    case 4: return launch.template operator()<2, 4>();
    case 5: return launch.template operator()<2, 5>();
    case 6: return launch.template operator()<2, 6>();
    case 7: return launch.template operator()<2, 7>();
    case 8: return launch.template operator()<2, 8>();
    default: return cudaErrorInvalidValue;
  }
}

// The same for the modes of a sort's first and last launches, whose
// planes the sort makes from the caller's columns and whose keys it writes
// back unbiased (csrc/bitonic_io.cu, radix_concat's unbiasing form): keys,
// (key, rider), lex2.
template <typename Launch>
cudaError_t dispatch_edges(int ncmp, int np, const Launch& launch) {
  if (ncmp == 1 && np == 1) return launch.template operator()<1, 1>();
  if (ncmp == 1 && np == 2) return launch.template operator()<1, 2>();
  if (ncmp == 2 && np == 2) return launch.template operator()<2, 2>();
  return cudaErrorInvalidValue;
}

bool make_planes(void* const* ptrs, int64_t np, Planes* out) {
  if (np < 1 || np > kMaxPlanes) return false;
  for (int j = 0; j < kMaxPlanes; ++j) {
    out->p[j] = j < np ? static_cast<int*>(ptrs[j]) : nullptr;
  }
  return true;
}

}  // namespace
