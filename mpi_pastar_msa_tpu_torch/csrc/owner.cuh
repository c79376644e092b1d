// The owner hash of a coordinate (parallel/partition.py, the reference's
// pastar/CoordHash.cpp:26-166), for the sharded step's kernels
// (sig_expand.cu's sharded instantiation, K4; keyrow_expand.cu's, K9) and
// the one-launch walk (path_walk.cu).  uint32 arithmetic, as the
// reference's: kind 0 FZORDER, 1 PZORDER, 2 FSUM, 3 PSUM (the order of
// partition.py::HASH_TYPES); zbits = partition.py::z_bits, the bit
// positions a Z-order hash writes (owner_params gives all four arguments).
#pragma once

#include <stdint.h>

namespace owner {

struct Hash {
  int kind, size, shift, zbits;
};

// The owner shard of a coordinate of N <= kN values, value d get(d).
// Each value is read at an index known once the loops are unrolled, so a
// coordinate held in a local array, or decoded from key words held in
// registers, stays in registers.
template <int kN, class Get>
__device__ __forceinline__ int of_at(const Hash& h, Get get, int N) {
  uint32_t v = 0;
  if (h.kind >= 2) {  // FSUM, PSUM
    const int nd = h.kind == 2 ? N : 2;
#pragma unroll
    for (int d = 0; d < kN; ++d)
      if (d < nd) v += (uint32_t)get(d);
    v >>= h.shift;
  } else {  // FZORDER, PZORDER: bit w of the code is value w mod nd's bit
            // shift / nd + w / nd
    const int nd = h.kind == 0 ? N : 2;
    const int read0 = h.shift / nd;
#pragma unroll
    for (int d = 0; d < kN; ++d)
      if (d < nd)
        for (int w = d; w < h.zbits; w += nd) {
          const int br = read0 + w / nd;
          if (br < 32) v |= (((uint32_t)get(d) >> br) & 1u) << w;
        }
    v >>= h.shift % nd;
  }
  return (int)(v % (uint32_t)h.size);
}

// The owner shard of coordinate c (N <= kN values).
template <int kN>
__device__ __forceinline__ int of(const Hash& h, const int32_t (&c)[kN], int N) {
  return of_at<kN>(h, [&](int d) { return c[d]; }, N);
}

}  // namespace owner
