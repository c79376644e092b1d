// Gotoh primer matrices (dd, hh, vv) of every sequence pair: the fill of the
// Altschul weights' pairwise distances.
//
// Replaces the XLA scan mpi_pastar_msa_tpu/heuristic/gotoh_wavefront.py
// ::_gotoh_wavefront (vmapped over pairs); same cells as the host fill
// weights._gotoh_pair_matrices.  For pair p the sequences a, b are
// dash-prefixed (a[0] = b[0] = '-'), of original lengths n, m, and
//
//   origin     dd = 0, hh = vv = egap
//   top row    hh[0, j] = hh[0, j-1] + cost(-, b[j])            (j = 1..m)
//   left col   vv[i, 0] = vv[i-1, 0] + cost(a[i], -)            (i = 1..n)
//   interior   dd = min(dd, hh, vv)[i-1, j-1] + cost(a[i], b[j])
//              hh = min(dd + Gi, hh, vv + Gi)[i, j-1] + cost(-, b[j])
//              vv = min(dd + Gj, hh + Gj, vv)[i-1, j] + cost(a[i], -)
//
// Gi is egap on row i == n and gap elsewhere, Gj the same on column j == m;
// every other cell of the pair's (L1, L1) square is BIG = 999999.  int32,
// as the reference; no value comes near 2^31.
//
// What bounds it on an H100: the chain of n+m+1 dependent anti-diagonals
// (551 at kinase), each needing the previous two, with a block barrier
// between consecutive diagonals (pair_wavefront.cu's barrier_chain measures
// that floor); only P blocks run (10 at kinase).  The bytes, 3 P L1^2 int32
// written once, are small, as long as each store moves whole sectors.
//
// Design (after K1's):
//  - one thread block a pair; the pair's residues and the 128 x 128 cost
//    table staged once in shared memory as uint8 (costs are 0..25,
//    core/cost.py), so the diagonal loop makes no global load;
//  - one thread a band of R contiguous rows (R = ceil(L1 / 1024), threads =
//    round_up(ceil(L1 / R), 32), heuristic/gotoh_wavefront.py::
//    k8_launch_shape), each row's dd, hh, vv on diagonal d-1 and its
//    min(dd, hh, vv) on d-2 in registers; a band runs its rows from the
//    last to the first, so each row reads the row above before it moves on;
//  - the only values from another thread are those of the row above the
//    band, the previous band's last row: it publishes (min(dd, hh), vv) of
//    each diagonal in an edge buffer double-buffered by diagonal parity,
//    and the reader keeps their min for the diagonal after; one
//    __syncthreads() a diagonal;
//  - (i, j)-major stores of a diagonal would be L1 words apart, a 32-byte
//    sector a cell and matrix.  So each band stores its cells of diagonal d
//    coalesced into a (d, i)-major scratch, one plane each for dd, hh and
//    vv (row d of pair p at d * W + i, W = R x threads; only the cells of
//    the pair's (n+1) x (m+1) box, so the scratch needs no initialisation),
//    and gotoh_diag_to_rows_kernel then writes the (3, P, L1, L1) output in
//    32 x 32 tiles through shared memory on all SMs, BIG outside each box
//    (diag_to_rows.cuh, shared with K1).  The C entry launches both on the
//    caller's stream.
//
// Built with -DK8_NO_STORE (a measurement build of chip_smoke.py, never the
// one the port loads), the fill stores nothing: its time against the real
// fill's is what the scratch stores cost.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <utility>

#include "diag_to_rows.cuh"

namespace {

constexpr int kBig = 999999;
constexpr int kCostCells = 128 * 128;
constexpr int kDash = '-';
// rows per thread: L1 up to 22,528 (K1 takes L1 up to 21,605);
// k8_launch_shape enforces the same limit
constexpr int kMaxRows = 22;

// [2][threads] int2 edge buffer, then the uint8 cost table, a and b
// residues; k8_launch_shape computes the same sum
size_t shared_bytes(int L1, int threads) {
  return (size_t)16 * threads + kCostCells + (size_t)2 * L1;
}

template <int R>
__global__ void __launch_bounds__(1024) gotoh_wavefront_kernel(
    const int32_t* __restrict__ seq_a, const int32_t* __restrict__ seq_b,
    const int32_t* __restrict__ n1s, const int32_t* __restrict__ n2s,
    const int32_t* __restrict__ cost, int32_t* __restrict__ scratch, int P, int L1, int gap,
    int egap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x, p = blockIdx.x;
  int2* edge = reinterpret_cast<int2*>(smem);  // [2][T]
  uint8_t* cost_s = smem + (size_t)16 * T;
  uint8_t* a_s = cost_s + kCostCells;
  uint8_t* b_s = a_s + L1;

  const int n = n1s[p], m = n2s[p];
  const int32_t* a = seq_a + (size_t)p * L1;
  const int32_t* b = seq_b + (size_t)p * L1;
  // scratch rows of W = R T words, diagonals 0 .. 2 (L1 - 1), a plane each
  // for dd, hh and vv
  const size_t W = (size_t)R * T, diags = 2 * (size_t)L1 - 1;
  const size_t plane = (size_t)P * diags * W;
  int32_t* dd_g = scratch + (size_t)p * diags * W;
  int32_t* hh_g = dd_g + plane;
  int32_t* vv_g = hh_g + plane;

  // residues are 7-bit ASCII; the mask only keeps a stray byte in the table
  const int4* cost4 = reinterpret_cast<const int4*>(cost);
#pragma unroll 4
  for (int k = tid; k < kCostCells / 4; k += T) {
    const int4 c = cost4[k];
    reinterpret_cast<uint32_t*>(cost_s)[k] =
        (uint32_t)c.x | (uint32_t)c.y << 8 | (uint32_t)c.z << 16 | (uint32_t)c.w << 24;
  }
  for (int k = tid; k < L1; k += T) {
    a_s[k] = (uint8_t)(a[k] & 127);
    b_s[k] = (uint8_t)(b[k] & 127);
  }
  for (int k = tid; k < 2 * T; k += T) edge[k] = make_int2(kBig, kBig);
  __syncthreads();

  const int base = tid * R;
  const bool active = base <= n;  // the band holds a row of the box
  // per row: dd, hh, vv on the last diagonal, min(dd, hh, vv) on the one
  // before, a[i] * 128 and cost(a[i], -)
  int dd1[R], hh1[R], vv1[R], m2[R], arow[R], gv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r;
    arow[r] = (i < L1 ? a_s[i] : 0) * 128;
    gv[r] = cost_s[arow[r] + kDash];
    dd1[r] = hh1[r] = vv1[r] = m2[r] = kBig;
  }
  int up_m2 = kBig;  // min(dd, hh, vv) of row base - 1 two diagonals back

  for (int d = 0; d <= n + m; ++d) {
    if (active) {
      // row base - 1 on diagonal d - 1, published by the previous band
      int up_dh = kBig, up_v = kBig;
      if (tid > 0) {
        const int2 e = edge[((d - 1) & 1) * T + tid - 1];
        up_dh = e.x;
        up_v = e.y;
      }
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const int i = base + r, j = d - i;
        // the row above on diagonal d - 1: (i-1, j); on d - 2: (i-1, j-1)
        const int udh = r ? min(dd1[r - 1], hh1[r - 1]) : up_dh;
        const int uv = r ? vv1[r - 1] : up_v;
        const int um2 = r ? m2[r - 1] : up_m2;
        int nd = kBig, nh = kBig, nv = kBig;
        if (i <= n && j >= 0 && j <= m) {
          if (i == 0) {
            if (j == 0) {
              nd = 0;
              nh = nv = egap;
            } else {
              nh = hh1[r] + cost_s[kDash * 128 + b_s[j]];
            }
          } else if (j == 0) {
            nv = uv + gv[r];
          } else {
            const int Gi = i == n ? egap : gap, Gj = j == m ? egap : gap;
            const int bj = b_s[j];
            nd = um2 + cost_s[arow[r] + bj];
            nh = min(min(dd1[r], vv1[r]) + Gi, hh1[r]) + cost_s[kDash * 128 + bj];
            nv = min(udh + Gj, uv) + gv[r];
          }
#ifndef K8_NO_STORE
          const size_t at = (size_t)d * W + i;
          dd_g[at] = nd;
          hh_g[at] = nh;
          vv_g[at] = nv;
#endif
        }
        m2[r] = min(min(dd1[r], hh1[r]), vv1[r]);
        dd1[r] = nd;
        hh1[r] = nh;
        vv1[r] = nv;
      }
      up_m2 = min(up_dh, up_v);
      edge[(d & 1) * T + tid] = make_int2(min(dd1[R - 1], hh1[R - 1]), vv1[R - 1]);
    }
    __syncthreads();
  }
}

// out[c, p, i, j] = scratch[c, p, i + j, i] inside pair p's box, BIG outside;
// one block per 32 x 32 output tile of one of the 3 P planes (blockIdx.x =
// plane * tiles + the tile's column, blockIdx.y its row)
__global__ void __launch_bounds__(256) gotoh_diag_to_rows_kernel(
    const int32_t* __restrict__ scratch, const int32_t* __restrict__ n1s,
    const int32_t* __restrict__ n2s, int32_t* __restrict__ out, int P, int L1, int W,
    int tiles) {
  const int plane = blockIdx.x / tiles, p = plane % P;
  const size_t diags = 2 * (size_t)L1 - 1;
  diag_tile_to_rows(scratch + (size_t)plane * diags * W, out + (size_t)plane * L1 * L1, L1, W,
                    n1s[p], n2s[p], blockIdx.y * 32, (blockIdx.x % tiles) * 32, kBig);
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, int, int, int, int);

template <int... Rs>
KernelFn kernel_for(int rows, std::integer_sequence<int, Rs...>) {
  const KernelFn fns[] = {gotoh_wavefront_kernel<Rs + 1>...};
  return fns[rows - 1];
}

}  // namespace

extern "C" int gotoh_wavefront(const void* seq_a, const void* seq_b, const void* n1s,
                               const void* n2s, const void* cost, void* scratch, void* out,
                               int P, int L1, int gap, int egap, int threads, int rows,
                               int shmem, void* stream) {
  const int tiles = (L1 + 31) / 32;
  if (L1 < 1 || P < 0 || rows < 1 || rows > kMaxRows || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || (long long)rows * threads < L1 ||
      (size_t)shmem != shared_bytes(L1, threads) || (long long)3 * P * tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kernel_for(rows, std::make_integer_sequence<int, kMaxRows>{});
  if (shmem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (e != cudaSuccess) return (int)e;
  }
  if (P > 0) {
    kernel<<<P, threads, shmem, (cudaStream_t)stream>>>(
        (const int32_t*)seq_a, (const int32_t*)seq_b, (const int32_t*)n1s,
        (const int32_t*)n2s, (const int32_t*)cost, (int32_t*)scratch, P, L1, gap, egap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gotoh_diag_to_rows_kernel<<<dim3(3 * P * tiles, tiles), dim3(32, 8), 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)scratch, (const int32_t*)n1s, (const int32_t*)n2s, (int32_t*)out, P,
        L1, threads * rows, tiles);
  }
  return (int)cudaGetLastError();
}
