// This shard's triangle cubes' h over the gathered batch of every shard:
// kernel K12, and the coordinates it gathers (sig_coords, keyrow_coords).
//
// Replaces, in mpi_pastar_msa_tpu/parallel/sharded.py, :250
// _make_tri_partial (with :302 _sharded_h3 around it, whose all_gather and
// reduce-scatter the mesh runs, parallel/mesh.py) and the coordinates of
// :1620 _select_sig that the sharded step gathers (XLA inside the sharded
// run loop), and on the packed layout the coordinates of :1668
// _select_packed that _make_sharded_run_packed gathers (:641-644).  The
// port's plain versions are parallel/sharded.py::tri_partial_plain,
// sig_coords_plain and keyrow_coords_plain.  With
// sharded cubes a shard holds T_loc = ceil(T / ndev) of the T triangles
// (the last shards fewer, or none); h = sum_t h_t, so each shard adds its
// own cubes' corners for every gathered row and a reduce-scatter hands
// each shard the totals of its own rows.
//
//   sig_coords: row i < n_sel of K3's compact list (slot, packed word)
//     decoded from (slot, t_sig[slot]) (sig_key.cuh), rows n_sel .. B zero:
//     (B, N) int32, the rows in list order, as sig_expand.cu walks them.
//   keyrow_coords: the same from the W key words of t_key[slot] (two
//     16-bit coordinates a word, search/engine.py::_unpack_keys), packed
//     layout, as keyrow_expand.cu walks them.
//   tri_partial: for gathered row b and local triangle t = (x, y, z), the
//     cell c = clip(coords[b][x, y, z], 0, S - 2) and its 8 corners
//     cube_t[c + (bx, by, bz)]; out[b][m - 1] = sum_t corner(t, m) for move
//     mask m = 1 .. M (corner 4 bx + 2 by + bz of the mask's bits at x, y,
//     z), out[b][M] = sum_t corner 0 (the row's own h3).  No cube: zeros.
//
// What bounds it on an H100: bytes.  A row reads its N coordinates and 8
// corners a local cube (in sectors of 32 B scattered over the cube stack)
// and writes M + 1 words: at kinase on 4 shards (B = 512 a shard, M = 31,
// one cube a shard) 2,048 rows, 2,048 x (20 + 8 x 32 + 128) B = 0.83 MB,
// 0.25 us at 3.35 TB/s.  Design: a warp a row; lanes 0 .. 8 T_loc - 1
// fetch the corners into the warp's shared memory, then a lane a mask.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sig_key.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxTl = 32;  // local cubes a shard (8 corners each in shared memory)
constexpr int kMaxN = 24;

__global__ void __launch_bounds__(32 * kWarps) tri_partial_kernel(
    const int32_t* __restrict__ coords, const int32_t* __restrict__ cubes,
    const int32_t* __restrict__ tri, int N, int M, int S, int Tl, int rows,
    int32_t* __restrict__ out, const int32_t* __restrict__ run) {
  __shared__ int32_t s_c[kWarps][8 * kMaxTl];
  if (run != nullptr && *run == 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t SS = (size_t)S * S;
  for (int b = blockIdx.x * kWarps + warp; b < rows; b += gridDim.x * kWarps) {
    const int32_t* c = coords + (size_t)b * N;
    for (int q = lane; q < 8 * Tl; q += 32) {
      const int t = q >> 3;
      const int cx = min(max(c[tri[3 * t]], 0), S - 2) + ((q >> 2) & 1);
      const int cy = min(max(c[tri[3 * t + 1]], 0), S - 2) + ((q >> 1) & 1);
      const int cz = min(max(c[tri[3 * t + 2]], 0), S - 2) + (q & 1);
      s_c[warp][q] = cubes[(size_t)t * SS * S + ((size_t)cx * S + cy) * S + cz];
    }
    __syncwarp();
    for (int m = lane + 1; m <= M + 1; m += 32) {
      const int mm = m <= M ? m : 0;  // column M: the row itself, corner 0
      int32_t h = 0;
      for (int t = 0; t < Tl; ++t) {
        const int corner = 4 * ((mm >> tri[3 * t]) & 1) + 2 * ((mm >> tri[3 * t + 1]) & 1) +
                           ((mm >> tri[3 * t + 2]) & 1);
        h += s_c[warp][8 * t + corner];
      }
      out[(size_t)b * (M + 1) + (m - 1)] = h;
    }
    __syncwarp();  // the next row rewrites this warp's corners
  }
}

__global__ void sig_coords_kernel(const int32_t* __restrict__ t_sig,
                                  const int32_t* __restrict__ sel, const long long* nsel,
                                  const int32_t* __restrict__ bitw, int N, int bbits, int B,
                                  int32_t* __restrict__ coords, const int32_t* __restrict__ run) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || (run != nullptr && *run == 0)) return;
  int32_t* c = coords + (size_t)i * N;
  if (i >= *nsel) {
    for (int d = 0; d < N; ++d) c[d] = 0;
    return;
  }
  const uint32_t slot = (uint32_t)sel[2 * i];
  const unsigned long long key = sigkey::decode(slot, (uint32_t)t_sig[slot], bbits);
  int sh = 0;
  for (int d = 0; d < N; ++d) {
    c[d] = (int32_t)((key >> sh) & ((1ull << bitw[d]) - 1));
    sh += bitw[d];
  }
}

__global__ void keyrow_coords_kernel(const int32_t* __restrict__ t_key, int KWs,
                                     const int32_t* __restrict__ sel, const long long* nsel,
                                     int N, int B, int32_t* __restrict__ coords,
                                     const int32_t* __restrict__ run) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || (run != nullptr && *run == 0)) return;
  int32_t* c = coords + (size_t)i * N;
  if (i >= *nsel) {
    for (int d = 0; d < N; ++d) c[d] = 0;
    return;
  }
  const int32_t* row = t_key + (size_t)(uint32_t)sel[2 * i] * KWs;
  for (int d = 0; d < N; ++d) c[d] = (int32_t)(((uint32_t)row[d >> 1] >> (16 * (d & 1))) & 0xFFFFu);
}

}  // namespace

// coords: (rows, N) int32; cubes: (Tl, S, S, S) int32 with the unreachable
// cells zeroed (null when Tl = 0); tri: (Tl, 3) int32 sequence indices of
// the local triangles; out: (rows, M + 1) int32, M = 2^N - 1.  run: the
// step loop's int32 flag, or null; each kernel here returns at once when it
// reads 0.
extern "C" int tri_partial(const void* coords, const void* cubes, const void* tri, int N, int S,
                           int Tl, int rows, void* out, const void* run, void* stream) {
  if (coords == nullptr || out == nullptr || N < 3 || N > kMaxN || S < 2 || Tl < 0 ||
      Tl > kMaxTl || rows < 0 || (Tl > 0 && (cubes == nullptr || tri == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 4096) blocks = 4096;
  tri_partial_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coords, (const int32_t*)cubes, (const int32_t*)tri, N, (1 << N) - 1, S,
      Tl, rows, (int32_t*)out, (const int32_t*)run);
  return (int)cudaGetLastError();
}

// t_sig: the sig table; sel: K3's compact list (>= B, 2) int32, its length
// at nsel (step_state.cuh kNSel, int64); bitw: (N,) int32 key bit widths;
// coords: (B, N) int32.
extern "C" int sig_coords(const void* t_sig, const void* sel, const void* nsel, const void* bitw,
                          int N, int bbits, int B, void* coords, const void* run, void* stream) {
  if (t_sig == nullptr || sel == nullptr || nsel == nullptr || bitw == nullptr ||
      coords == nullptr || N < 2 || N > kMaxN || bbits < 1 || bbits > 28 || B < 1)
    return (int)cudaErrorInvalidValue;
  sig_coords_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)t_sig, (const int32_t*)sel, (const long long*)nsel,
      (const int32_t*)bitw, N, bbits, B, (int32_t*)coords, (const int32_t*)run);
  return (int)cudaGetLastError();
}

// t_key: (>= C, KWs) int32 key rows (packed: KWs = W + 1); sel: K3's
// compact list (>= B, 2) int32, its length at nsel (int64); coords: (B, N)
// int32.
extern "C" int keyrow_coords(const void* t_key, int KWs, const void* sel, const void* nsel, int N,
                             int B, void* coords, const void* run, void* stream) {
  if (t_key == nullptr || sel == nullptr || nsel == nullptr || coords == nullptr || N < 2 ||
      N > 16 || KWs < (N + 1) / 2 || B < 1)
    return (int)cudaErrorInvalidValue;
  keyrow_coords_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)t_key, KWs, (const int32_t*)sel, (const long long*)nsel, N, B,
      (int32_t*)coords, (const int32_t*)run);
  return (int)cudaGetLastError();
}
