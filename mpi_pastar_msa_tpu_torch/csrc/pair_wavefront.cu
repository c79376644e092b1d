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
//
// What bounds it on an H100: the chain of n1+n2 dependent anti-diagonals
// (2 Lmax, 552 at Lmax=276), each needing the previous two, with one block
// barrier between them.  The bytes are small: the output is
// P (Lmax+1)^2 4 B (3.1 MB at kinase, P=10), written once.
//
// Design: one thread block per pair; threads stride over i along the current
// diagonal.  The rolling diagonals d+2, d+1 (values) and d+1 (gap direction)
// live in shared memory as three value rows and two direction rows used in
// rotation, so one __syncthreads() per diagonal separates every read of a
// row from its next overwrite.  The block reads the encoded residues and the
// 128x128 cost table itself (the host builds no diagonal-major cost tensor)
// and writes the (i, j)-major output directly.  The writes along a diagonal
// are strided by Lmax, hence uncoalesced: accepted for this first version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 28;
constexpr int kNoGap = 0, kGapX = 1, kGapY = 2;

__global__ void pair_wavefront_kernel(const int32_t* __restrict__ enc, int enc_stride,
                                      const int32_t* __restrict__ xs,
                                      const int32_t* __restrict__ ys,
                                      const int32_t* __restrict__ lens,
                                      const int32_t* __restrict__ cost,
                                      int32_t* __restrict__ out, int L1, int lmax,
                                      int gap_open, int gap_ext) {
  extern __shared__ int32_t smem[];
  // rows have L1 + 1 entries so that i + 1 never leaves the row
  const int R = L1 + 1;
  int32_t* vrow[3] = {smem, smem + R, smem + 2 * R};
  int32_t* arow[2] = {smem + 3 * R, smem + 4 * R};

  const int p = blockIdx.x;
  const int x = xs[p], y = ys[p];
  const int n1 = lens[x], n2 = lens[y];
  const int32_t* a = enc + (size_t)x * enc_stride;
  const int32_t* b = enc + (size_t)y * enc_stride;
  int32_t* o = out + (size_t)p * L1 * L1;
  const int E = gap_ext, O = gap_open;
  const int clip = lmax > 0 ? lmax - 1 : 0;

  // cells outside the pair's box hold BIG
  for (int k = threadIdx.x; k < L1 * L1; k += blockDim.x) {
    int i = k / L1, j = k - i * L1;
    if (i > n1 || j > n2) o[k] = kBig;
  }
  // diagonal D = n1 + n2 holds only the corner; D + 1 is empty
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    vrow[0][i] = kBig;                    // d + 2
    vrow[1][i] = (i == n1) ? 0 : kBig;    // d + 1
    vrow[2][i] = kBig;
    arow[0][i] = kNoGap;
    arow[1][i] = kNoGap;
  }
  if (threadIdx.x == 0) o[(size_t)n1 * L1 + n2] = 0;
  __syncthreads();

  int v2 = 0, v1 = 1, vn = 2, a1 = 0, an = 1;
  for (int d = n1 + n2 - 1; d >= 0; --d) {
    const int32_t* V2 = vrow[v2];
    const int32_t* V1 = vrow[v1];
    const int32_t* A1 = arow[a1];
    int32_t* VN = vrow[vn];
    int32_t* AN = arow[an];
    for (int i = threadIdx.x; i <= n1; i += blockDim.x) {
      const int j = d - i;
      int mv = kBig, gv = kNoGap;
      if (j >= 0 && j <= n2) {
        if (i == n1 || j == n2) {
          if (i == n1 && j == n2) {
            mv = 0;
            gv = kNoGap;
          } else if (i == n1) {
            mv = O + (n2 - 1 - j) * E;
            gv = kGapY;
          } else {
            mv = O + (n1 - 1 - i) * E;
            gv = kGapX;
          }
        } else {
          const int c0 = V1[i + 1] + (A1[i + 1] == kGapX ? E : O);
          const int c1 = V1[i] + (A1[i] == kGapY ? E : O);
          const int ai = a[min(i, clip)];
          const int bj = b[min(max(j, 0), clip)];
          const int c2 = V2[i + 1] + __ldg(cost + ai * 128 + bj);
          if (c0 < c1) {
            mv = c0;
            gv = kGapX;
          } else {
            mv = c1;
            gv = kGapY;
          }
          if (c2 < mv) {
            mv = c2;
            gv = kNoGap;
          }
        }
        o[(size_t)i * L1 + j] = mv;
      }
      VN[i] = mv;
      AN[i] = gv;
    }
    __syncthreads();
    const int t = v2;
    v2 = v1;
    v1 = vn;
    vn = t;
    a1 ^= 1;
    an ^= 1;
  }
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
                              void* out, int P, int L1, int lmax, int gap_open,
                              int gap_ext, void* stream) {
  const int threads = 256;
  const size_t shmem = (size_t)5 * (L1 + 1) * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pair_wavefront_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  if (P > 0) {
    pair_wavefront_kernel<<<P, threads, shmem, (cudaStream_t)stream>>>(
        (const int32_t*)enc, enc_stride, (const int32_t*)xs, (const int32_t*)ys,
        (const int32_t*)lens, (const int32_t*)cost, (int32_t*)out, L1, lmax, gap_open,
        gap_ext);
  }
  return (int)cudaGetLastError();
}
