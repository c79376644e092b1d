// The path walk, goal -> origin, over a finished table: kernel K7.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :1936
// _make_backtrace_sig, :1888 _make_backtrace_packed and :2061
// _make_backtrace (XLA scans).  The port's plain version is
// search/engine.py::_walk with _lookup_sig and _lookup_keyrow.  From the
// goal coordinate, at most tmax = sum(final coordinate) iterations, each of
// which looks the coordinate up, giving (parent mask, found):
//   emit = !done && coord != origin && found: the mask is emitted and
//   coord -= bits(mask); done |= coord == origin || !found.
// The lookups take the first hit of a fixed order, as the JAX argmax does:
//   sig:      bucket rows (home + r) & (NB - 1) for r < max_bprobes (64);
//             way w of row r hits where t_sig == sigb | r (sig_key.cuh);
//             first hit in (r, way) order; parent mask t_best & (2^n - 1);
//   packed:   slots probe_slot(h0, r) for r < max_probes (128); a row hits
//             where its W key words equal the key and word 0 != -1; first
//             hit in r order; t_best & (2^n - 1);
//   unpacked: the same probe; t_fpar & (2^n - 1) (int64).
// Output, one int32 buffer that the host reads once: the masks (tmax,), 0
// where nothing was emitted, then the final coordinate (N,), then the
// number of masks emitted.
//
// What bounds it on an H100: the chain of dependent lookups, not bytes.  A
// node's probe positions follow from its coordinate, which is the last
// node's coordinate less the last node's parent mask: one dependent round
// trip to memory a path node (kinase: 276 nodes), against about 4 KB of
// rows read a node (0.00034 ms at 3.35 TB/s for the whole kinase walk).
// chip_smoke.py measures that round trip with pointer_chase (below) and
// gives path nodes x round trip as the walk's latency floor.
//
// Design: one launch a run, one block walking the path serially.  Every
// thread keeps the coordinate in registers and computes the node's
// encoding itself (a few dozen integer operations: no broadcast, no
// barrier for it), then loads its one probe position with the parent word
// beside it, so a node's loads are all in flight at once: on sig 512
// threads, one (r, way) word each; on the key-row layouts 128 threads, one
// probe row each.  The first hit is the smallest flat index (r * 8 + way,
// or r = the thread) among the hits: a warp ballot, each warp's first hit
// and its parent mask into shared memory (two buffers, by the parity of
// the iteration, so one barrier a node suffices), one __syncthreads, and
// every thread takes the min over the warps and moves to the parent.
// Slots are masked to the table (below C): the TRASH tail is never read.

#include "sig_key.cuh"
#include "step_state.cuh"

namespace {

constexpr int kSigThreads = 512;  // 64 bucket rows x 8 ways
constexpr int kRowThreads = 128;  // 128 probe rows
constexpr int kMaxN = 24;         // sig: K4's N <= 24; the key rows take N <= 16
constexpr int kMaxW = 8;          // key words of N <= 16
constexpr long long kNoHit = 0x7FFFFFFFFFFFFFFFll;
constexpr unsigned kFull = 0xffffffffu;

enum { kSig = 0, kPacked = 1, kUnpacked = 2 };

struct Table {
  const int32_t* keys;    // t_sig (sig) or t_key (key rows)
  int KWs;                // key-row stride: packed W + 1, unpacked W
  const int32_t* best;    // t_best (sig, packed)
  const long long* fpar;  // t_fpar (unpacked)
  int N, W, bbits, probes;
  uint32_t Cmask;
};

// This thread's probe position of the node at `coord`: whether it holds the
// node, and the parent mask stored there.
template <int kLayout>
__device__ __forceinline__ bool probe(const Table& t, const int32_t* coord, const int* shift,
                                      int parmask, int& par) {
  if constexpr (kLayout == kSig) {
    unsigned long long ckey = 0;
#pragma unroll
    for (int d = 0; d < kMaxN; ++d)
      if (d < t.N) ckey |= (unsigned long long)(uint32_t)coord[d] << shift[d];
    uint32_t home, sigb;
    sigkey::encode(ckey, t.bbits, home, sigb);
    const int r = threadIdx.x >> 3, way = threadIdx.x & 7;
    if (r >= t.probes) return false;
    const uint32_t slot = (((home + (uint32_t)r) & (t.Cmask >> 3)) << 3) | (uint32_t)way;
    const int32_t s = t.keys[slot];
    par = t.best[slot] & parmask;
    return s == (int32_t)(sigb | (uint32_t)r);
  } else {
    uint32_t kw[kMaxW];
#pragma unroll
    for (int i = 0; i < kMaxW; ++i) kw[i] = i < t.W ? step::key_word(coord, i, t.N) : 0u;
    const int r = threadIdx.x;
    if (r >= t.probes) return false;
    const uint32_t slot = step::probe_slot(step::hash_keys(kw, t.W), r, t.Cmask);
    const int32_t* row = t.keys + (size_t)slot * t.KWs;
    if constexpr (kLayout == kPacked)
      par = t.best[slot] & parmask;
    else
      par = (int)(t.fpar[slot] & (long long)parmask);
    bool eq = row[0] != -1;
#pragma unroll
    for (int i = 0; i < kMaxW; ++i)
      if (i < t.W) eq &= row[i] == (int32_t)kw[i];
    return eq;
  }
}

template <int kLayout, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    path_walk_kernel(Table t, const int32_t* __restrict__ params, int tmax,
                     int32_t* __restrict__ out) {
  __shared__ long long s_hit[2][kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = t.N, parmask = (1 << N) - 1;
  int32_t coord[kMaxN];
  int shift[kMaxN];  // the sig key's field offsets
  int sh = 0;
#pragma unroll
  for (int d = 0; d < kMaxN; ++d) {
    coord[d] = d < N ? params[d] : 0;
    shift[d] = sh;
    if (d < N) sh += params[N + d];
  }
  int it = 0;
  for (; it < tmax; ++it) {
    bool origin = true;
#pragma unroll
    for (int d = 0; d < kMaxN; ++d) origin &= coord[d] == 0;
    if (origin) break;
    int par = 0;
    const bool hit = probe<kLayout>(t, coord, shift, parmask, par);
    // the warp's first hit, then the block's
    const unsigned ballot = __ballot_sync(kFull, hit);
    const int first = ballot ? __ffs(ballot) - 1 : 0;
    const int first_par = __shfl_sync(kFull, par, first);
    const int p = it & 1;
    if (lane == 0)
      s_hit[p][warp] = ballot ? ((long long)(warp * 32 + first) << 32) | (uint32_t)first_par
                              : kNoHit;
    __syncthreads();
    long long best = kNoHit;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) best = min(best, s_hit[p][k]);
    if (best == kNoHit) break;  // not stored: the walk ends here
    const int mask = (int)(uint32_t)best;
    if (tid == 0) out[it] = mask;
#pragma unroll
    for (int d = 0; d < kMaxN; ++d) coord[d] -= (mask >> d) & 1;
  }
  for (int k = it + tid; k < tmax; k += kThreads) out[k] = 0;
  if (tid == 0) {
#pragma unroll
    for (int d = 0; d < kMaxN; ++d)
      if (d < N) out[tmax + d] = coord[d];
    out[tmax + N] = it;  // every iteration before the last emitted
  }
}

__global__ void pointer_chase_kernel(const int32_t* __restrict__ next, int hops,
                                     int32_t* __restrict__ out) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = next[i];
  *out = i;
}

}  // namespace

// layout: 0 sig, 1 packed, 2 unpacked.  keys: t_sig (>= C,) int32, or
// t_key (>= C, KWs) int32 (packed KWs = W + 1, unpacked W = ceil(N / 2));
// best: t_best (>= C,) int32 (sig, packed; null on unpacked); fpar: t_fpar
// (>= C,) int64 (unpacked; else null); C a power of two; bbits = log2(C) -
// 3 (sig); probes: bucket rows (sig, <= 64) or probe rounds (<= 128);
// params: int32 [final coordinate N, key bit widths N] (the widths are read
// on sig only); out: (tmax + N + 1,) int32, as above.
extern "C" int path_walk(int layout, const void* keys, int KWs, const void* best,
                         const void* fpar, int N, int C, int bbits, int probes,
                         const void* params, int tmax, void* out, void* stream) {
  const int W = (N + 1) / 2;
  const bool sig = layout == kSig;
  if (layout < kSig || layout > kUnpacked || keys == nullptr || params == nullptr ||
      out == nullptr || N < 2 || N > (sig ? kMaxN : 2 * kMaxW) || C < 8 || (C & (C - 1)) != 0 ||
      probes < 1 || probes > (sig ? kSigThreads / 8 : kRowThreads) || tmax < 0 ||
      (layout == kUnpacked ? fpar == nullptr : best == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sig ? (1 << (bbits + 3)) != C : KWs != W + (layout == kPacked ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  const Table t{(const int32_t*)keys, KWs, (const int32_t*)best, (const long long*)fpar,
                N, W, bbits, probes, (uint32_t)(C - 1)};
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* p = (const int32_t*)params;
  int32_t* o = (int32_t*)out;
  if (sig)
    path_walk_kernel<kSig, kSigThreads><<<1, kSigThreads, 0, s>>>(t, p, tmax, o);
  else if (layout == kPacked)
    path_walk_kernel<kPacked, kRowThreads><<<1, kRowThreads, 0, s>>>(t, p, tmax, o);
  else
    path_walk_kernel<kUnpacked, kRowThreads><<<1, kRowThreads, 0, s>>>(t, p, tmax, o);
  return (int)cudaGetLastError();
}

// A measurement probe, not part of the engine: one thread follows `hops`
// links of the int32 permutation `next` from index 0 and writes where it
// ended to out[0].  Over a buffer larger than L2, `hops` dependent loads
// from device memory: chip_smoke.py times it for K7's latency floor.
extern "C" int pointer_chase(const void* next, int hops, void* out, void* stream) {
  if (next == nullptr || out == nullptr || hops < 0) return (int)cudaErrorInvalidValue;
  pointer_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next, hops,
                                                          (int32_t*)out);
  return (int)cudaGetLastError();
}
