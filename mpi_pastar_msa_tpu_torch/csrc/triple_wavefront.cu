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
// What bounds it on an H100: the chain of dependent wavefront steps.  Cell
// by cell that is Lx+Ly+Lz+1 planes d = i+j+k (813 at kinase), each needing
// planes d+1..d+3.  The bytes (one write of the stack, 343.8 MB for
// kinase's 4 cubes, 0.10 ms at 3.35 TB/s) and the operations are small next
// to one launch per plane; and within a plane no two cells are adjacent in
// the (T, S, S, S) layout, so a thread per cell makes every load and store a
// sector of its own.
//
// Design: tiles of kBi x kBj x kBk = 32 x 16 x 16 cells, compile-time
// constants (heuristic/triples.py::K2_TILE names the same tile, and the C
// entry refuses any other), k fastest as in memory.
//  - Tile (a, b, c) needs only tiles (a+1, b, c) .. (a+1, b+1, c+1), which
//    lie on tile diagonals a+b+c+1 .. a+b+c+3.  So all tiles of one tile
//    diagonal, in every cube, are independent: one launch per tile diagonal
//    (43 at kinase), descending, all from this one C call on the caller's
//    stream, after fill_kernel has set the whole stack to INF3.  Each
//    launch's rectangle of tile rows a and columns b comes from the caller
//    (heuristic/triples.py::k2_launch_shape); a block whose tile lies
//    outside its cube's box returns at once.
//  - One block per tile, one thread per (v, w) column of the tile.  The
//    block loads the tile's halo (the faces u = kBi, v = kBj and w = kBk,
//    edges and corner included) from the stack that earlier launches
//    finished, INF3 past the box (never past the stack), and its kBi x kBj
//    and kBi x kBk blocks of cxy and cxz into shared memory; cyz[v, w] stays
//    in a register.  It walks the tile's kBi+kBj+kBk-2 local planes
//    p = u+v+w descending with one __syncthreads() each: thread (v, w)
//    computes cell u = p - v - w when it lies in the tile, with no branch
//    per move.  Then each thread stores its column, so each row of kBk
//    consecutive k is one coalesced store.
//  - Shared-memory strides are padded so that the 32 threads of a warp, two
//    v rows of 16 w, touch 32 different banks on every access of a local
//    plane.
//  - Cell semantics are the plane-per-launch kernel's: a child >= INF3 is
//    skipped before the add, move costs are summed in 64 bits (the parts
//    that do not change along u once per thread), out-of-box moves are
//    masked, the goal is 0, the stored value is (int32)best.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf3 = 1 << 30;
constexpr int kBi = 32, kBj = 16, kBk = 16;
constexpr int kThreads = kBj * kBk;

// the smallest m >= n with m % 32 == 31
constexpr int pad31(int n) { return n + (31 - n % 32); }

// Shared-memory layout of one tile block, in int32 words.  The tile
// (u, v, w), u, v, w in [0, kBi] x [0, kBj] x [0, kBk], sits at
// u * kSu + v * kSv + w; cxy at u * kSxy + v and cxz at u * kSxz + w.  On
// local plane p a warp's thread (v, w) touches
// p kSu + v (kSv - kSu) + w (1 - kSu) + const: with kSu = 31 mod 32 and kSv
// even that is 2 w + odd * v mod 32, so the two v rows of a warp take the
// even and the odd banks.  The same holds for cxz (kSxz = 31 mod 32) and
// cxy (kSxy odd).  At 32 x 16 x 16 that is 48,252 bytes, under the 48 KiB
// of static shared memory a block may declare.
constexpr int kSv = (kBk + 2) & ~1;
constexpr int kSu = pad31((kBj + 1) * kSv);
constexpr int kSxy = kBj | 1;
constexpr int kSxz = pad31(kBk);

__global__ void fill_kernel(int32_t* __restrict__ cubes, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride)
    cubes[k] = kInf3;
}

// One tile (a, b, c = D - a - b) of cube blockIdx.z per block, a and b
// offset by the launch's first tile row and column.
__global__ void __launch_bounds__(kThreads) tile_kernel(
    int32_t* __restrict__ cubes, const int32_t* __restrict__ cxy,
    const int32_t* __restrict__ cxz, const int32_t* __restrict__ cyz,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ ws, int S, int D,
    int a_lo, int b_lo, int E, int GG) {
  __shared__ int32_t tile[(kBi + 1) * kSu];
  __shared__ int32_t sxy[kBi * kSxy];
  __shared__ int32_t sxz[kBi * kSxz];
  const int t = blockIdx.z;
  const int a = a_lo + (int)blockIdx.y, b = b_lo + (int)blockIdx.x, c = D - a - b;
  const int Lx = lens[3 * t], Ly = lens[3 * t + 1], Lz = lens[3 * t + 2];
  const int i0 = a * kBi, j0 = b * kBj, k0 = c * kBk;
  // a tile exists where its first cell lies in the box
  if (c < 0 || i0 > Lx || j0 > Ly || k0 > Lz) return;
  const size_t SS = (size_t)S * S;
  int32_t* h = cubes + (size_t)t * SS * S;
  const int32_t* mxy = cxy + (size_t)t * SS;
  const int32_t* mxz = cxz + (size_t)t * SS;
  const int tid = threadIdx.x;

  // 1. the halo: face u = kBi (edges and corner included), face v = kBj
  //    (u < kBi), face w = kBk (u < kBi, v < kBj)
  constexpr int kFu = (kBj + 1) * (kBk + 1), kFv = kBi * (kBk + 1), kFw = kBi * kBj;
  for (int n = tid; n < kFu + kFv + kFw; n += kThreads) {
    int u, v, w;
    if (n < kFu) {
      u = kBi, v = n / (kBk + 1), w = n % (kBk + 1);
    } else if (n < kFu + kFv) {
      const int r = n - kFu;
      u = r / (kBk + 1), v = kBj, w = r % (kBk + 1);
    } else {
      const int r = n - kFu - kFv;
      u = r / kBj, v = r % kBj, w = kBk;
    }
    const int i = i0 + u, j = j0 + v, k = k0 + w;
    tile[u * kSu + v * kSv + w] =
        i <= Lx && j <= Ly && k <= Lz ? h[((size_t)i * S + j) * S + k] : kInf3;
  }
  // 2. the residue costs (rows and columns past the box are never used)
  for (int n = tid; n < kBi * kBj; n += kThreads) {
    const int u = n / kBj, v = n % kBj, i = i0 + u, j = j0 + v;
    sxy[u * kSxy + v] = i <= Lx && j <= Ly ? mxy[(size_t)i * S + j] : 0;
  }
  for (int n = tid; n < kBi * kBk; n += kThreads) {
    const int u = n / kBk, w = n % kBk, i = i0 + u, k = k0 + w;
    sxz[u * kSxz + w] = i <= Lx && k <= Lz ? mxz[(size_t)i * S + k] : 0;
  }
  const int v = tid / kBk, w = tid % kBk, j = j0 + v, k = k0 + w;
  const bool jk_in = j <= Ly && k <= Lz, my = j < Ly, mz = k < Lz;
  const long long cost_yz = jk_in ? cyz[(size_t)t * SS + (size_t)j * S + k] : 0;
  const long long wxy = ws[3 * t], wxz = ws[3 * t + 1], wyz = ws[3 * t + 2];
  // each move's cost, less the terms that change along u
  const long long c100 = wxy * E + wxz * E + wyz * GG;
  const long long c010 = wxy * E + wxz * GG + wyz * E;
  const long long c110 = wxz * E + wyz * E;  // + wxy cxy
  const long long c001 = wxy * GG + wxz * E + wyz * E;
  const long long c101 = wxy * E + wyz * E;  // + wxz cxz
  const long long c011 = wxy * E + wxz * E + wyz * cost_yz;
  const long long c111 = wyz * cost_yz;  // + wxy cxy + wxz cxz
  __syncthreads();

  // 3. the local planes, children from planes p+1..p+3 or the halo
  for (int p = kBi + kBj + kBk - 3; p >= 0; --p) {
    const int u = p - v - w;
    if (u >= 0 && u < kBi) {
      const int i = i0 + u;
      const int at = u * kSu + v * kSv + w;
      const bool mx = i < Lx;
      const long long pxy = wxy * sxy[u * kSxy + v], pxz = wxz * sxz[u * kSxz + w];
      long long best = kInf3;
      auto relax = [&](bool ok, int child, long long cm) {
        // a child >= INF3 is skipped before the add: nothing can overflow
        if (ok && child < kInf3 && child + cm < best) best = child + cm;
      };
      relax(mx, tile[at + kSu], c100);
      relax(my, tile[at + kSv], c010);
      relax(mx && my, tile[at + kSu + kSv], pxy + c110);
      relax(mz, tile[at + 1], c001);
      relax(mx && mz, tile[at + kSu + 1], pxz + c101);
      relax(my && mz, tile[at + kSv + 1], c011);
      relax(mx && my && mz, tile[at + kSu + kSv + 1], pxy + pxz + c111);
      const bool goal = i == Lx && j == Ly && k == Lz;
      tile[at] = i <= Lx && jk_in ? (goal ? 0 : (int32_t)best) : kInf3;
    }
    __syncthreads();
  }

  // 4. each thread's column; a warp stores two rows of kBk consecutive k
  //    (cells past the box stay INF3)
  if (jk_in) {
    for (int u = 0; u < kBi && i0 + u <= Lx; ++u)
      h[((size_t)(i0 + u) * S + j) * S + k] = tile[u * kSu + v * kSv + w];
  }
}

// Measurement probe, not part of any path: an empty kernel with K2's grid.
__global__ void empty_kernel() {}

}  // namespace

// Measurement probe: `planes` back-to-back launches of an empty kernel with
// `blocks` x `threads`, the dependent-launch floor of K2 on this card.
extern "C" int plane_chain(int planes, int blocks, int threads, void* stream) {
  for (int p = 0; p < planes; ++p) {
    empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Fill the stack: INF3 everywhere, then tile diagonals diagonals-1 .. 0.
// (bi, bj, bk) must be the compiled tile.  grid is a host array of
// diagonals x 4 ints, row D = (first tile row a, first tile column b, tile
// rows, tile columns) of tile diagonal D's launch over all T cubes.
extern "C" int triple_wavefront(void* cubes, const void* cxy, const void* cxz, const void* cyz,
                                const void* lens, const void* ws, int T, int S, int bi, int bj,
                                int bk, int diagonals, const int* grid, int gap_open,
                                int gap_ext, int gap_gap, void* stream) {
  if (T < 1 || T > 65535 || S < 2 || bi != kBi || bj != kBj || bk != kBk || diagonals < 1 ||
      grid == nullptr || gap_open != gap_ext)
    return (int)cudaErrorInvalidValue;
  for (int D = 0; D < diagonals; ++D) {
    const int* g = grid + 4 * D;
    if (g[0] < 0 || g[1] < 0 || g[2] < 1 || g[2] > 65535 || g[3] < 1)
      return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)T * S * S * S;
  const size_t fill_blocks = (n + 255) / 256;
  fill_kernel<<<(unsigned)(fill_blocks < 8192 ? fill_blocks : 8192), 256, 0, s>>>(
      (int32_t*)cubes, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int D = diagonals - 1; D >= 0; --D) {
    const int* g = grid + 4 * D;
    tile_kernel<<<dim3(g[3], g[2], T), kThreads, 0, s>>>(
        (int32_t*)cubes, (const int32_t*)cxy, (const int32_t*)cxz, (const int32_t*)cyz,
        (const int32_t*)lens, (const int32_t*)ws, S, D, g[0], g[1], gap_ext, gap_gap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
