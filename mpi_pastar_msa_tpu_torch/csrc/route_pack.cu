// The route of a shard's candidates to their owners: kernel K11.
//
// Replaces, in mpi_pastar_msa_tpu/parallel/sharded.py, :87 _route_cap and
// :169 _route_ragged (XLA inside the sharded run loop) less their
// collective, which the mesh runs (parallel/mesh.py).  The port's plain
// versions are parallel/sharded.py::route_count_plain and
// route_pack_plain.  The rows are the step's candidate lanes, `cand`
// (lanes, 4) int32 (dest, fsort, home, sig) as sig_expand.cu's sharded
// instantiation writes them (dest = ndev for a lane that stays), followed
// by the carry ring (Ccar, 4) of the rows spilled before; row r's position
// is r in [lanes; carry].  A row is remote when dest < ndev.  Per
// destination d its remote rows are ordered by (fsort, position): the
// first allow[d] ride the wire, to rows base[d] .. base[d] + allow[d] of
// `wire` (home, sig, fsort: sig_probe.cu's pending row) in that order; the rest spill, in (d, fsort,
// position) order, into the new carry ring, whose tail is filled with the
// empty row (ndev, INFP, 0, -1).  carry_ovf = max(spilled - Ccar, 0) and
// the min fsort of the new ring's rows (INFP when it is empty) close the
// step's route.  JAX sorts with jax.lax.sort(num_keys=2), which is not
// stable, so which of two rows with equal (dest, fsort) rides the wire is
// unspecified there; the position fixes it here, and the plain version
// gives the same wire and ring bit for bit.
//
// The allowance: dense (the JAX _route_cap), allow[d] = cap and base[d] =
// d cap; ragged (_route_ragged), from the all-gathered send counts S
// (ndev x ndev, S[i][d] = rows shard i sends d): allow[d] = clip(ndev cap -
// sum_{i < me} S[i][d], 0, S[me][d]) (a receiver takes at most ndev cap
// rows, its senders in rank order) and base[d] = sum_{d' < d} allow[d'].
//
// Two passes, one launch each (the ragged allowance needs every shard's
// counts between them):
//   1. route_count: the remote rows of each destination (out[d], d <
//      ndev), the remote rows among the lanes (out[ndev], the step's
//      migrants), and each remote row's sort key (fsort << 32 | position)
//      appended to its destination's segment of `keys` (atomics: the
//      order of a segment is not fixed; pass 2 sorts it).
//   2. route_pack: a block a destination sorts its segment (bitonic, in
//      shared memory when it fits, else in place in `keys`) and writes its
//      wire rows and its spilled rows; every block fills the ring's tail;
//      out[ndev + 1] = carry_ovf, out[ndev + 2] = the ring's min fsort
//      (an atomicMin of each block's, set to INFP by pass 1).
//
// What bounds it on an H100: launches and the sort's barriers, not bytes.
// At kinase on 4 shards a step reads at most 2 x 15,872 rows of 16 B and
// writes as many (about 1 MB, 0.3 us at 3.35 TB/s); the bitonic sort of a
// destination's n rows is log2(n)(log2(n) + 1)/2 block barriers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kShKeys = 8192;  // keys a block sorts in shared memory (64 KB)
constexpr int32_t kInfp = 0x7FFFFFFF;

__device__ __forceinline__ int4 row_at(const int4* cand, const int4* carry, long long n_lanes,
                                       long long pos) {
  return pos < n_lanes ? cand[pos] : carry[pos - n_lanes];
}

__global__ void __launch_bounds__(kThreads) route_count_kernel(
    const int4* __restrict__ cand, const int4* __restrict__ carry, const long long* nsel, int M,
    int ccar, int ndev, long long seg, int32_t* __restrict__ out,
    unsigned long long* __restrict__ keys) {
  const long long n_lanes = *nsel * M;
  const long long n = n_lanes + ccar;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[ndev + 2] = kInfp;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int4 v = row_at(cand, carry, n_lanes, r);
    if (v.x < 0 || v.x >= ndev) continue;
    const int at = atomicAdd(&out[v.x], 1);
    keys[(long long)v.x * seg + at] = ((unsigned long long)(uint32_t)v.y << 32) | (uint64_t)r;
    if (r < n_lanes) atomicAdd(&out[ndev], 1);
  }
}

// Sort s[0 .. np2) ascending (np2 a power of two), the whole block.
__device__ void bitonic(unsigned long long* s, int np2) {
  for (int k = 2; k <= np2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < np2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s[i], b = s[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads) route_pack_kernel(
    const int4* __restrict__ cand, const int4* __restrict__ carry, const long long* nsel, int M,
    int ccar, int ndev, int me, int cap, const int32_t* __restrict__ S, long long seg,
    int32_t* __restrict__ out, unsigned long long* __restrict__ keys, int32_t* __restrict__ wire,
    int4* __restrict__ carry_out) {
  extern __shared__ unsigned long long sh[];
  __shared__ int s_min[32];
  const long long n_lanes = *nsel * M;
  // the allowance and the spill offsets of every destination (each block)
  long long spilled = 0, spill_before = 0, base = 0, base_d = 0;
  int allow_d = 0;
  const int d = blockIdx.x;
  for (int q = 0; q < ndev; ++q) {
    const int cnt = out[q];
    int allow = cap;
    if (S != nullptr) {
      long long before = 0;
      for (int i = 0; i < me; ++i) before += S[i * ndev + q];
      const long long a = (long long)ndev * cap - before;
      allow = (int)(a < 0 ? 0 : (a > cnt ? cnt : a));
    }
    const long long over = cnt > allow ? cnt - allow : 0;
    if (q == d) {
      spill_before = spilled;
      base_d = S != nullptr ? base : (long long)q * cap;
      allow_d = allow;
    }
    spilled += over;
    base += allow;
  }
  // the ring's tail: the empty row
  for (long long s = spilled + (long long)blockIdx.x * blockDim.x + threadIdx.x; s < ccar;
       s += (long long)gridDim.x * blockDim.x)
    carry_out[s] = make_int4(ndev, kInfp, 0, -1);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out[ndev + 1] = (int32_t)(spilled > ccar ? spilled - ccar : 0);
  if (d >= ndev) return;
  const int n = out[d];
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  unsigned long long* k = keys + (long long)d * seg;
  unsigned long long* s = np2 <= kShKeys ? sh : k;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) s[i] = i < n ? k[i] : ~0ull;
  __syncthreads();
  bitonic(s, np2);
  int fmin = kInfp;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long key = s[i];
    const long long pos = (long long)(key & 0xffffffffull);
    const int4 v = row_at(cand, carry, n_lanes, pos);
    if (i < allow_d) {
      int32_t* w = wire + 3 * (base_d + i);
      w[0] = v.z;  // the pending list's row: home, sig, packed
      w[1] = v.w;
      w[2] = v.y;
    } else {
      const long long slot = spill_before + (i - allow_d);
      if (slot < ccar) {
        carry_out[slot] = make_int4(d, v.y, v.z, v.w);
        fmin = min(fmin, v.y);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) fmin = min(fmin, __shfl_down_sync(0xffffffffu, fmin, o));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = fmin;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = kInfp;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = min(m, s_min[w]);
    if (m < kInfp) atomicMin(&out[ndev + 2], m);
  }
}

int grid_of(long long rows) {
  long long b = (rows + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b > 1024 ? 1024 : b);
}

}  // namespace

// cand: (lanes_cap, 4) int32; carry: (ccar, 4) int32; nsel: the step's
// selected rows (step_state.cuh kNSel, int64), lanes = nsel x M <=
// lanes_cap; out: (ndev + 3,) int32 (counts, migrants, carry_ovf, ring
// min); keys: (ndev, seg) uint64 scratch, seg a power of two >= lanes_cap
// + ccar (a segment sorts in place when it outgrows shared memory).
extern "C" int route_count(const void* cand, const void* carry, const void* nsel, int M,
                           int lanes_cap, int ccar, int ndev, long long seg, void* out,
                           void* keys, void* stream) {
  if (cand == nullptr || carry == nullptr || nsel == nullptr || out == nullptr ||
      keys == nullptr || M < 1 || lanes_cap < 0 || ccar < 1 || ndev < 1 || ndev > 1024 ||
      seg < (long long)lanes_cap + ccar || seg >= (1ll << 31) || (seg & (seg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t) * (ndev + 1), s);
  if (e != cudaSuccess) return (int)e;
  route_count_kernel<<<grid_of((long long)lanes_cap + ccar), kThreads, 0, s>>>(
      (const int4*)cand, (const int4*)carry, (const long long*)nsel, M, ccar, ndev, seg,
      (int32_t*)out, (unsigned long long*)keys);
  return (int)cudaGetLastError();
}

// After route_count on the same buffers.  S: (ndev, ndev) int32 send
// counts of every shard (ragged), or null (dense: allowance cap); wire:
// (>= ndev cap, 3) int32 (dense) or (>= lanes_cap + ccar, 3) (ragged);
// carry_out: (ccar, 4) int32, not the carry read.
extern "C" int route_pack(const void* cand, const void* carry, const void* nsel, int M,
                          int ccar, int ndev, int me, int cap, const void* S, long long seg,
                          void* out, void* keys, void* wire, void* carry_out, void* stream) {
  if (cand == nullptr || carry == nullptr || nsel == nullptr || out == nullptr ||
      keys == nullptr || wire == nullptr || carry_out == nullptr || carry_out == carry ||
      M < 1 || ccar < 1 || ndev < 1 || ndev > 1024 || me < 0 || me >= ndev || cap < 1 ||
      seg < 1 || seg >= (1ll << 31) || (seg & (seg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // every call: the attribute belongs to the current card, and one
  // process may hold shards on several
  const int shared = kShKeys * (int)sizeof(unsigned long long);
  cudaError_t e = cudaFuncSetAttribute(route_pack_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return (int)e;
  const int blocks = ndev > grid_of(ccar) ? ndev : grid_of(ccar);
  route_pack_kernel<<<blocks, kThreads, shared, (cudaStream_t)stream>>>(
      (const int4*)cand, (const int4*)carry, (const long long*)nsel, M, ccar, ndev, me, cap,
      (const int32_t*)S, seg, (int32_t*)out, (unsigned long long*)keys, (int32_t*)wire,
      (int4*)carry_out);
  return (int)cudaGetLastError();
}
