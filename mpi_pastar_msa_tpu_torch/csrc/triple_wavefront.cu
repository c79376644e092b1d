// Triangle suffix cubes of the triple heuristic: kernel K2.
//
// Replaces the cube fill of mpi_pastar_msa_tpu/heuristic/triples.py
// (_fill_chunk_device, an XLA lax.scan over planes driven by
// triple_tables_device; not a pallas_call).  For each triangle t = (x, y, z)
// of the cover, cube[t, i, j, k] is the least weighted sum-of-pairs cost to
// align x[i:], y[j:] and z[k:]:
//
//   cube[i, j, k] = min over the 7 moves (bx, by, bz) != 0 inside the box of
//                   cube[i+bx, j+by, k+bz] + wxy cxy + wxz cxz + wyz cyz
//
// where a pair's term is its residue cost when both of its sequences
// advance, GG when neither does and E otherwise (gap open equal to
// extension, as in core/cost.py; the C entry refuses anything else).  The
// goal cell (Lx, Ly, Lz) is 0 and every cell outside a cube's
// (Lx+1, Ly+1, Lz+1) box is INF3 = 2^30, the stack (T, S, S, S) int32
// row-major with S = Lmax + 2.
//
// What bounds it on an H100: the chain of Lx+Ly+Lz+1 dependent planes
// d = i+j+k (822 at kinase), each needing planes d+1..d+3.  The bytes (one
// write of the stack, 343.8 MB for kinase's 4 cubes, 0.10 ms at 3.35 TB/s)
// and the operations are small next to Dmax+1 launches; plane_chain below
// measures that floor.
//
// Design (the simple one; a persistent kernel with a grid-wide barrier per
// plane, or tiling of j and k, is later work):
//  - fill_kernel sets the whole stack to INF3;
//  - then one launch per plane d = Dmax .. 0 on the caller's stream, all from
//    this one C call: one thread per (t, j, k), i = d - j - k, threads whose
//    cell lies outside the box return at once;
//  - children are read straight from the stack: they lie in planes d+1..d+3,
//    written by earlier launches on the same stream, so no rolling plane
//    buffers are needed.  The cost matrices (3 x T S^2 int32, 3.7 MB at
//    kinase) are read from global memory and stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf3 = 1 << 30;

__global__ void fill_kernel(int32_t* __restrict__ cubes, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride)
    cubes[k] = kInf3;
}

// a pair's term of a move: its residue cost when both sequences advance,
// GG when neither does, E otherwise
__device__ __forceinline__ int pair_term(int a, int b, int cost, int E, int GG) {
  return a && b ? cost : (a || b ? E : GG);
}

__global__ void plane_kernel(int32_t* __restrict__ cubes, const int32_t* __restrict__ cxy,
                             const int32_t* __restrict__ cxz,
                             const int32_t* __restrict__ cyz,
                             const int32_t* __restrict__ lens,
                             const int32_t* __restrict__ ws, int T, int S, int d, int E,
                             int GG) {
  const long long SS = (long long)S * S;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= T * SS) return;
  const int t = (int)(cell / SS);
  const int r = (int)(cell - t * SS);
  const int j = r / S, k = r - (r / S) * S;
  const int i = d - j - k;
  const int Lx = lens[3 * t], Ly = lens[3 * t + 1], Lz = lens[3 * t + 2];
  if (i < 0 || i > Lx || j > Ly || k > Lz) return;
  int32_t* h = cubes + (size_t)t * SS * S;
  const size_t at = ((size_t)i * S + j) * S + k;
  if (i == Lx && j == Ly && k == Lz) {
    h[at] = 0;
    return;
  }
  const long long wxy = ws[3 * t], wxz = ws[3 * t + 1], wyz = ws[3 * t + 2];
  const size_t m0 = (size_t)t * SS;
  const int cost_xy = cxy[m0 + (size_t)i * S + j];
  const int cost_xz = cxz[m0 + (size_t)i * S + k];
  const int cost_yz = cyz[m0 + (size_t)j * S + k];
  long long best = kInf3;
#pragma unroll
  for (int m = 1; m < 8; ++m) {
    const int bx = m & 1, by = (m >> 1) & 1, bz = m >> 2;
    if (i + bx > Lx || j + by > Ly || k + bz > Lz) continue;
    const int child = h[at + bx * SS + by * S + bz];
    if (child >= kInf3) continue;  // before the add: nothing can overflow
    const long long c = wxy * pair_term(bx, by, cost_xy, E, GG) +
                        wxz * pair_term(bx, bz, cost_xz, E, GG) +
                        wyz * pair_term(by, bz, cost_yz, E, GG);
    if (child + c < best) best = child + c;
  }
  h[at] = (int32_t)best;
}

// Measurement probe, not part of any path: an empty kernel with K2's grid.
__global__ void empty_kernel() {}

}  // namespace

// Measurement probe: `planes` back-to-back launches of an empty kernel with
// `blocks` x `threads`, the dependent-plane floor of K2 on this card.
extern "C" int plane_chain(int planes, int blocks, int threads, void* stream) {
  for (int p = 0; p < planes; ++p) {
    empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" int triple_wavefront(void* cubes, const void* cxy, const void* cxz, const void* cyz,
                                const void* lens, const void* ws, int T, int S, int dmax,
                                int threads, int gap_open, int gap_ext, int gap_gap,
                                void* stream) {
  if (T < 1 || S < 2 || dmax < 0 || dmax > 3 * (S - 2) || gap_open != gap_ext ||
      threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)T * S * S * S;
  const size_t fill_blocks = (n + threads - 1) / threads;
  fill_kernel<<<(unsigned)(fill_blocks < 8192 ? fill_blocks : 8192), threads, 0, s>>>(
      (int32_t*)cubes, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long cells = (long long)T * S * S;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
  for (int d = dmax; d >= 0; --d) {
    plane_kernel<<<blocks, threads, 0, s>>>((int32_t*)cubes, (const int32_t*)cxy,
                                            (const int32_t*)cxz, (const int32_t*)cyz,
                                            (const int32_t*)lens, (const int32_t*)ws, T, S, d,
                                            gap_ext, gap_gap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
