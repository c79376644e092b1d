// The expansion arithmetic of one selected row, shared by the two expand
// kernels (sig_expand.cu, K4, and keyrow_expand.cu, K9): the row's T8 rows
// and cube corners staged in a warp's shared memory, the parent's h, and
// each child's edge cost and h (search/engine.py::_expand, per pair; K4
// sums them per mask in child_cost_h, K9 from per-row term tables):
//   cost = sum_p w_p (GG + (E - GG)(bx + by) + bx by (mm_p + GG - 2E))
//          + (O - E) sum_p w_p (bx (1 - by) par_y + (1 - bx) by par_x)
//   h    = sum_p wh_p T8[p][2 bx + by] + sum_t cube_t[corner(t, m)]
// summed in 64 bits as the plain version does (.long()): the plain
// version's c0 + c1[m] + sum_p both w (mm + GG - 2E) written per pair, the
// same integers.  The parent's h is the k = 0 cells and corner 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace expand {

// The constants a block stages from search/step.py::_kernel_params: xs,
// ys, w, w_h (P each), the triangles (3T) and the final coordinate (N), at
// the front of the vector, in this order.
struct Consts {
  const int32_t* xs;
  const int32_t* ys;
  const int32_t* w;
  const int32_t* wh;
  const int32_t* tri;
  const int32_t* final_c;
  int N, P, T, S;
};

__host__ __device__ __forceinline__ int const_words(int N, int P, int T) {
  return 4 * P + 3 * T + N;
}

// A warp's staging: 5 words a pair (4 pair-table cells and the residue
// cost), 8 a cube, and the row's coordinate (N).
__host__ __device__ __forceinline__ int warp_words(int N, int P, int T) {
  return 5 * P + 8 * T + N;
}

__device__ __forceinline__ Consts consts_at(const int32_t* sm, int N, int P, int T, int S) {
  Consts k;
  k.xs = sm;
  k.ys = k.xs + P;
  k.w = k.ys + P;
  k.wh = k.w + P;
  k.tri = k.wh + P;
  k.final_c = k.tri + 3 * T;
  k.N = N;
  k.P = P;
  k.T = T;
  k.S = S;
  return k;
}

// The T8 rows and the 8 corners of each cube around the row's coordinate
// (s_coord), lanes in parallel: a T8 row is two int4 loads; callers
// __syncwarp() before and after.
__device__ __forceinline__ void stage_row(const Consts& k, const int32_t* __restrict__ tables4,
                                          const int32_t* __restrict__ cubes,
                                          const int32_t* s_coord, int32_t* s_t8, int32_t* s_cube,
                                          int lane) {
  const int S = k.S;
  const size_t SS = (size_t)S * S;
  for (int p = lane; p < k.P; p += 32) {
    const int cx = min(max(s_coord[k.xs[p]], 0), S - 2);
    const int cy = min(max(s_coord[k.ys[p]], 0), S - 2);
    const int4* row = reinterpret_cast<const int4*>(
        tables4 + ((size_t)p * SS + (size_t)cx * S + cy) * 8);
    const int4 a = row[0], c = row[1];
    s_t8[5 * p] = a.x;
    s_t8[5 * p + 1] = a.y;
    s_t8[5 * p + 2] = a.z;
    s_t8[5 * p + 3] = a.w;
    s_t8[5 * p + 4] = c.x;
  }
  for (int q = lane; q < 8 * k.T; q += 32) {
    const int t = q >> 3;
    const int cx = min(max(s_coord[k.tri[3 * t]], 0), S - 2) + ((q >> 2) & 1);
    const int cy = min(max(s_coord[k.tri[3 * t + 1]], 0), S - 2) + ((q >> 1) & 1);
    const int cz = min(max(s_coord[k.tri[3 * t + 2]], 0), S - 2) + (q & 1);
    s_cube[q] = cubes[(size_t)t * SS * S + ((size_t)cx * S + cy) * S + cz];
  }
}

// h of the staged row itself: the k = 0 cells and corner 0.
__device__ __forceinline__ long long parent_h(const Consts& k, const int32_t* s_t8,
                                              const int32_t* s_cube) {
  long long h = 0;
  for (int p = 0; p < k.P; ++p) h += (long long)s_t8[5 * p] * k.wh[p];
  for (int t = 0; t < k.T; ++t) h += s_cube[8 * t];
  return h;
}

// One pair's terms of a child's cost and h: for a row whose parent mask is
// par, pair p and the move bits (bx, by) of a child fix one term of its
// cost and one of its h ({cost term, h term}; entry 4p + 2bx + by of K9's
// per-row term tables), where
//   cost term = w_p (GG + (E - GG)(bx + by) + bx by (mm_p + GG - 2E))
//               + (O - E) w_p (bx (1 - by) par_y + (1 - bx) by par_x)
//   h term    = wh_p T8[p][2 bx + by]
// (t8: the cell T8[p][2 bx + by], mm: the residue cost T8[p][4]).
__device__ __forceinline__ longlong2 pair_terms(const Consts& k, int p, int bxby, int par, int E,
                                                int GG, int gap_oe, int t8, int mm) {
  const int bx = bxby >> 1, by = bxby & 1;
  const long long w = k.w[p];
  long long cost = w * (GG + (long long)(E - GG) * (bx + by) +
                        (long long)(bx & by) * ((long long)mm + GG - 2 * E));
  if (gap_oe != 0)
    cost += (long long)gap_oe * w *
            (bx * (1 - by) * ((par >> k.ys[p]) & 1) + (1 - bx) * by * ((par >> k.xs[p]) & 1));
  return make_longlong2(cost, (long long)t8 * k.wh[p]);
}

// The cubes' part of the h of the child by move mask m: one corner a cube.
__device__ __forceinline__ long long cube_h(const Consts& k, int m, const int32_t* s_cube) {
  long long h = 0;
  for (int t = 0; t < k.T; ++t) {
    const int corner = 4 * ((m >> k.tri[3 * t]) & 1) + 2 * ((m >> k.tri[3 * t + 1]) & 1) +
                       ((m >> k.tri[3 * t + 2]) & 1);
    h += s_cube[8 * t + corner];
  }
  return h;
}

// The edge cost of move mask m from a row whose parent mask is par, and
// the child's h: the pairs' terms and the cube corners, summed per mask
// (K4).
__device__ __forceinline__ void child_cost_h(const Consts& k, int m, int par, int E, int GG,
                                             int gap_oe, const int32_t* s_t8,
                                             const int32_t* s_cube, long long& cost,
                                             long long& h) {
  cost = 0;
  h = 0;
  for (int p = 0; p < k.P; ++p) {
    const int c = (((m >> k.xs[p]) & 1) << 1) | ((m >> k.ys[p]) & 1);
    const longlong2 v = pair_terms(k, p, c, par, E, GG, gap_oe, s_t8[5 * p + c], s_t8[5 * p + 4]);
    cost += v.x;
    h += v.y;
  }
  h += cube_h(k, m, s_cube);
}

// child_cost_h from a row's term tables (s_term, 4P entries of
// pair_terms) and its cube corners (s_cube, 8T), with no multiply: the
// same integers summed in another order, which integer addition ignores
// (K9).
__device__ __forceinline__ void child_cost_h_terms(const Consts& k, int m,
                                                   const longlong2* s_term,
                                                   const int32_t* s_cube, long long& cost,
                                                   long long& h) {
  cost = 0;
  h = 0;
#pragma unroll 4
  for (int p = 0; p < k.P; ++p) {
    const longlong2 v = s_term[4 * p + (((m >> k.xs[p]) & 1) << 1) + ((m >> k.ys[p]) & 1)];
    cost += v.x;
    h += v.y;
  }
  h += cube_h(k, m, s_cube);
}

}  // namespace expand
