// The owner hash of a coordinate (parallel/partition.py, the reference's
// pastar/CoordHash.cpp:26-166), for the sharded step's kernels
// (sig_expand.cu's sharded instantiation, K4).  uint32 arithmetic, as the
// reference's: kind 0 FZORDER, 1 PZORDER, 2 FSUM, 3 PSUM (the order of
// partition.py::HASH_TYPES); zbits = partition.py::z_bits, the bit
// positions a Z-order hash writes (owner_params gives all four arguments).
#pragma once

#include <stdint.h>

namespace owner {

struct Hash {
  int kind, size, shift, zbits;
};

// The owner shard of coordinate c (N values).
__device__ __forceinline__ int of(const Hash& h, const int32_t* c, int N) {
  uint32_t v = 0;
  if (h.kind >= 2) {  // FSUM, PSUM
    const int nd = h.kind == 2 ? N : 2;
    for (int d = 0; d < nd; ++d) v += (uint32_t)c[d];
    v >>= h.shift;
  } else {  // FZORDER, PZORDER
    const int nd = h.kind == 0 ? N : 2;
    const int read0 = h.shift / nd;
    for (int w = 0; w < h.zbits; ++w) {
      const int br = read0 + w / nd;
      if (br < 32) v |= (((uint32_t)c[w % nd] >> br) & 1u) << w;
    }
    v >>= h.shift % nd;
  }
  return (int)(v % (uint32_t)h.size);
}

}  // namespace owner
