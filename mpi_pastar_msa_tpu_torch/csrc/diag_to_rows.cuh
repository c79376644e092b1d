// The tiled transpose of a wavefront kernel's diagonal-major scratch into
// its (i, j)-major table, shared by K1 (pair_wavefront.cu) and K8
// (gotoh_wavefront.cu).
//
// A block that walks a pair's anti-diagonals stores each diagonal d
// coalesced as row d of a (d, i)-major scratch, g[d * W + i]; stored
// (i, j)-major, the same cells would lie L1 words apart, a 32-byte sector
// each.  This pass then writes o[i, j] = g[(i + j) * W + i] inside the
// pair's box i <= n1, j <= n2 and `big` outside it, one 32 x 32 output tile
// a block: the tile's 63 diagonals are staged in shared memory, read along
// i and written along j, so that both are coalesced.  Only cells of the
// box are read, so the scratch needs no initialisation.

#pragma once

#include <stdint.h>

// One tile (i0, j0) of the (L1, L1) table o; every thread of a block of 32 x
// blockDim.y threads calls it (it holds a barrier).
__device__ __forceinline__ void diag_tile_to_rows(const int32_t* __restrict__ g,
                                                  int32_t* __restrict__ o, int L1, int W,
                                                  int n1, int n2, int i0, int j0, int big) {
  __shared__ int32_t tile[63][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (i0 <= n1 && j0 <= n2) {
    const int i = i0 + tx;
    for (int k = ty; k < 63; k += blockDim.y) {
      const int d = i0 + j0 + k;
      if (i <= n1 && i <= d && d - i <= n2) tile[k][tx] = g[(size_t)d * W + i];
    }
  }
  __syncthreads();
  const int j = j0 + tx;
  for (int r = ty; r < 32; r += blockDim.y) {
    const int i = i0 + r;
    if (i < L1 && j < L1) o[(size_t)i * L1 + j] = (i <= n1 && j <= n2) ? tile[r + tx][r] : big;
  }
}
