// Pairwise suffix-alignment DP for every sequence pair: the HPair tables.
//
// Replaces the Pallas kernel mpi_pastar_msa_tpu/heuristic/wavefront_pallas.py
// ::_kernel (launched by _pallas_tables, pl.pallas_call at :129); same math
// as the XLA scan wavefront.py::_wavefront_tables.  out[p, i, j] is the least
// cost to align a[i:] with b[j:] for pair p = (x, y), a = seq x, b = seq y:
//
//   c0 = v[i+1, j]   + (E if dir[i+1, j] == GAPX else O)
//   c1 = v[i, j+1]   + (E if dir[i, j+1] == GAPY else O)
//   c2 = v[i+1, j+1] + cost(a[i], b[j])
//   v  = c0 < c1 ? c0 : c1, then c2 wins only on strict c2 < v
//
// The bottom row and right column are gap runs O + (n-1-k) E, the corner
// (n1, n2) is 0, and every cell outside a pair's (n1+1) x (n2+1) box is BIG.
// This kernel takes gap open equal to extension (G = O = E, as in
// core/cost.py; the C entry refuses anything else).  A gap then costs G
// whatever move came before it, so v = min(c0, c1, c2) with every gap at G:
// no cell needs its direction, and the tie order cannot change a value.
//
// What bounds it on an H100: the chain of n1+n2 dependent anti-diagonals
// (549 at kinase, 2212 at synth4_long), each needing the previous two, with
// at least one block barrier between consecutive diagonals; barrier_chain
// below measures that floor.  Only P blocks run (10 at kinase), so the card
// is nearly empty and each diagonal's latency adds up; the bytes
// (P (Lmax+1)^2 4 B written once) are small.
//
// Design: one thread block per pair, one __syncthreads() per diagonal, and
// as little work as possible between two barriers.
//  - Staged once: the pair's residues and the 128 x 128 cost table go to
//    shared memory as uint8 (costs are 0..25, core/cost.py), so the diagonal
//    loop makes no global load.  A cell's substitution cost depends on (i, j)
//    alone and is fetched one diagonal ahead.
//  - One thread per row band: thread t owns R contiguous rows t R ..
//    t R + R - 1 (R = ceil(L1 / 1024), threads = round_up(ceil(L1 / R), 32),
//    from heuristic/wavefront.py::k1_launch_shape) and keeps in registers
//    each row's value on diagonal d+1 and the part of its next value that
//    needs no other thread (borders and cells outside the box are selects).
//  - One shared word per band and diagonal: only row t R + R, the first row
//    of the next band, comes from another thread.  Each thread publishes its
//    first row's value in a row buffer double-buffered by diagonal parity.
//  - (i, j)-major stores of a diagonal would be strided by L1.  So each band
//    stores its values of a diagonal coalesced and (d, i)-major into a
//    scratch table, and diag_to_rows_kernel then writes the (i, j)-major
//    table in 32 x 32 tiles through shared memory on all SMs, every output
//    cell once (diag_to_rows.cuh, shared with K8).  The C entry launches
//    both on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "diag_to_rows.cuh"

namespace {

constexpr int kBig = 1 << 28;
constexpr int kCostCells = 128 * 128;
// rows per thread at the largest L1 whose shared bytes fit one block
// (232,448 B: L1 = 21605, R = 22); k1_launch_shape enforces the same limit
constexpr int kMaxRows = 22;

// [2][L1 + 1] int32 row buffer, then the uint8 cost table, a and b residues;
// k1_launch_shape computes the same sum
size_t shared_bytes(int L1) {
  return (size_t)8 * (L1 + 1) + kCostCells + (size_t)2 * L1;
}

// Everything the value of cell (i, j = t - i) on diagonal t needs but the
// value of row i+1 on diagonal t+1: own is the cell's right neighbour
// (i, j+1), down is (i+1, j+1), s is cost(a[i], b[j]).  pre is the cell's
// value at a border or outside the box, else the least of its own-row gap
// and diagonal candidates; inner says whether the gap from row i+1 competes.
__device__ __forceinline__ void prepare(int i, int t, int own, int down, int s, int n1,
                                        int n2, int G, int& pre, bool& inner) {
  const int j = t - i;
  const bool ib = i <= n1 && j >= 0 && j <= n2;
  const bool border = i == n1 || j == n2;
  inner = ib && !border;
  pre = !ib ? kBig : (border ? G * (i == n1 ? n2 - j : n1 - i) : min(own + G, down + s));
}

__device__ __forceinline__ int clamp_col(int j, int L1) { return min(max(j, 0), L1 - 1); }

template <int R>
__global__ void __launch_bounds__(1024) pair_wavefront_kernel(
    const int32_t* __restrict__ enc, int enc_stride, const int32_t* __restrict__ xs,
    const int32_t* __restrict__ ys, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ cost, int32_t* __restrict__ diag, int L1, int lmax,
    int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* edge = reinterpret_cast<int32_t*>(smem);  // [2][L1 + 1]
  uint8_t* cost_s = smem + (size_t)8 * (L1 + 1);
  uint8_t* a_s = cost_s + kCostCells;
  uint8_t* b_s = a_s + L1;

  const int p = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int x = xs[p], y = ys[p];
  const int n1 = lens[x], n2 = lens[y];
  const int32_t* a = enc + (size_t)x * enc_stride;
  const int32_t* b = enc + (size_t)y * enc_stride;
  // scratch rows of W = R blockDim.x words, diagonals 0 .. 2 lmax
  const int W = R * T;
  int32_t* g = diag + (size_t)p * (2 * lmax + 1) * W;

  // residues are 7-bit ASCII; the mask only keeps a stray byte in the table
  const int4* cost4 = reinterpret_cast<const int4*>(cost);
#pragma unroll 4
  for (int k = tid; k < kCostCells / 4; k += T) {
    const int4 c = cost4[k];
    reinterpret_cast<uint32_t*>(cost_s)[k] =
        (uint32_t)c.x | (uint32_t)c.y << 8 | (uint32_t)c.z << 16 | (uint32_t)c.w << 24;
  }
  for (int k = tid; k < L1; k += T) {
    a_s[k] = k < lmax ? (uint8_t)(a[k] & 127) : 0;
    b_s[k] = k < lmax ? (uint8_t)(b[k] & 127) : 0;
  }
  __syncthreads();

  const int base = tid * R;
  const int D = n1 + n2;
  const bool active = base <= n1;     // the band holds a row of the box
  const bool has_nb = base + R <= n1;  // so does the next band's first row
  // per row, for the coming diagonal: its value at d+1 (w1), pre and inner
  // (see prepare), the substitution cost fetched ahead (sub), a[i] * 128
  int w1[R], pre[R], sub[R], arow[R];
  bool inner[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + r;
    arow[r] = (i < L1 ? a_s[i] : 0) * 128;
    w1[r] = i == n1 ? 0 : kBig;  // diagonal D: the corner
    const int s = cost_s[arow[r] + b_s[clamp_col(D - 1 - i, L1)]];
    prepare(i, D - 1, w1[r], kBig, s, n1, n2, G, pre[r], inner[r]);
    sub[r] = cost_s[arow[r] + b_s[clamp_col(D - 2 - i, L1)]];
  }
  if (active) {
    edge[(D & 1) * (L1 + 1) + base] = w1[0];
    if (n1 < base + R) g[(size_t)D * W + n1] = 0;
  }
  __syncthreads();

  // each row's word of the next band is written on diagonal d+1 into buffer
  // (d+1) & 1, read on d, and overwritten on d-1, a barrier between each
  for (int d = D - 1; d >= 0; --d) {
    if (active) {
      // the only value from another thread: row base + R at d+1
      const int nb1 = has_nb ? edge[((d + 1) & 1) * (L1 + 1) + base + R] : kBig;
      int nw[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int below = r + 1 < R ? w1[r + 1] : nb1;  // (i+1, j) at d+1
        nw[r] = inner[r] ? min(below + G, pre[r]) : pre[r];
      }
      edge[(d & 1) * (L1 + 1) + base] = nw[0];
      int32_t* gd = g + (size_t)d * W + base;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gd[r] = nw[r];
        // row i+1 at d+1 is (i+1, j'+1) for the next diagonal's cell j'
        const int down = r + 1 < R ? w1[r + 1] : nb1;
        const int s = sub[r];
        sub[r] = cost_s[arow[r] + b_s[clamp_col(d - 2 - (base + r), L1)]];
        prepare(base + r, d - 1, nw[r], down, s, n1, n2, G, pre[r], inner[r]);
        w1[r] = nw[r];
      }
    }
    __syncthreads();
  }
}

// out[p, i, j] = diag[p, i + j, i] inside the pair's box, BIG outside; one
// block per 32 x 32 output tile (diag_to_rows.cuh).
__global__ void diag_to_rows_kernel(const int32_t* __restrict__ diag,
                                    const int32_t* __restrict__ xs,
                                    const int32_t* __restrict__ ys,
                                    const int32_t* __restrict__ lens,
                                    int32_t* __restrict__ out, int L1, int lmax, int W) {
  const int p = blockIdx.z;
  diag_tile_to_rows(diag + (size_t)p * (2 * lmax + 1) * W, out + (size_t)p * L1 * L1, L1, W,
                    lens[xs[p]], lens[ys[p]], blockIdx.y * 32, blockIdx.x * 32, kBig);
}

using KernelFn = void (*)(const int32_t*, int, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, int32_t*, int, int, int);

template <int... Rs>
KernelFn kernel_for(int rows, std::integer_sequence<int, Rs...>) {
  const KernelFn fns[] = {pair_wavefront_kernel<Rs + 1>...};
  return fns[rows - 1];
}

// Measurement probe, not part of any path: one block runs `steps` dependent
// shared-memory updates with one barrier each, the floor of K1's per-diagonal
// step on this card.
__global__ void barrier_chain_kernel(int steps, int32_t* __restrict__ out) {
  __shared__ int32_t row[2][1024];
  const int i = threadIdx.x;
  row[0][i] = i;
  __syncthreads();
  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    const int nxt = cur ^ 1;
    row[nxt][i] = min(row[cur][i], row[cur][(i + 1) % blockDim.x]) + 1;
    __syncthreads();
    cur = nxt;
  }
  out[i] = row[cur][i];
}

}  // namespace

extern "C" int barrier_chain(int steps, int threads, void* out, void* stream) {
  barrier_chain_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(steps, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int pair_wavefront(const void* enc, int enc_stride, const void* xs,
                              const void* ys, const void* lens, const void* cost,
                              void* diag, void* out, int P, int L1, int lmax, int gap_open,
                              int gap_ext, int threads, int rows, int shmem,
                              void* stream) {
  if (L1 < 1 || gap_open != gap_ext || rows < 1 || rows > kMaxRows || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || (long long)rows * threads < L1 ||
      (size_t)shmem != shared_bytes(L1))
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kernel_for(rows, std::make_integer_sequence<int, kMaxRows>{});
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (e != cudaSuccess) return (int)e;
  }
  if (P > 0) {
    kernel<<<P, threads, shmem, (cudaStream_t)stream>>>(
        (const int32_t*)enc, enc_stride, (const int32_t*)xs, (const int32_t*)ys,
        (const int32_t*)lens, (const int32_t*)cost, (int32_t*)diag, L1, lmax, gap_open);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int tiles = (L1 + 31) / 32;
    diag_to_rows_kernel<<<dim3(tiles, tiles, P), dim3(32, 8), 0, (cudaStream_t)stream>>>(
        (const int32_t*)diag, (const int32_t*)xs, (const int32_t*)ys,
        (const int32_t*)lens, (int32_t*)out, L1, lmax, threads * rows);
  }
  return (int)cudaGetLastError();
}
