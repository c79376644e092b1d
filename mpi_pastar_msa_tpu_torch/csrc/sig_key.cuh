// The sig layout's key encoding (search/engine.py::_sig_encode and
// _sig_decode), shared by sig_expand.cu (K4) and path_walk.cu (K7).
//
// A coordinate packs into one key of sig_bits <= bbits + 25 bits: field d
// holds coordinate d shifted by s_shift[d] (the sum of the bit widths of
// the fields before it).  clo is its low bbits, chi the next 32 bits; its
// home bucket is ((clo * kSigOdd) & Bmask) ^ (mix32(chi) & Bmask) and the
// word stored in bucket row home + r is (chi << 6) | r.  Given (slot,
// word) the key is recovered exactly: kSigOdd is odd, so it has an inverse
// mod 2^32, and masking to the bucket bits keeps the inverse property.
#pragma once

#include <stdint.h>

#include "step_state.cuh"

namespace sigkey {

constexpr uint32_t kSigOdd = 0x9E3779B1u;     // engine.py::_SIG_ODD
constexpr uint32_t kSigOddInv = 0x0E8B2F51u;  // its inverse mod 2^32

// (home bucket, sig base word) of a packed key (_sig_encode).
__device__ __forceinline__ void encode(unsigned long long ckey, int bbits, uint32_t& home,
                                       uint32_t& sigb) {
  const uint32_t Bmask = (1u << bbits) - 1u;
  const uint32_t clo = (uint32_t)ckey & Bmask, chi = (uint32_t)(ckey >> bbits);
  home = ((clo * kSigOdd) & Bmask) ^ (step::mix32(chi) & Bmask);
  sigb = chi << 6;
}

// The packed key stored at `slot` under the word `sig` (_sig_decode).
__device__ __forceinline__ unsigned long long decode(uint32_t slot, uint32_t sig, int bbits) {
  const uint32_t Bmask = (1u << bbits) - 1u;
  const uint32_t r = sig & 63u, khi = sig >> 6;
  const uint32_t home = ((slot >> 3) - r) & Bmask;
  const uint32_t klo = ((home ^ (step::mix32(khi) & Bmask)) * kSigOddInv) & Bmask;
  return (unsigned long long)klo | ((unsigned long long)khi << bbits);
}

}  // namespace sigkey
