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
// trip to memory a path node (kinase: 276 nodes), against the 36 B that a
// lookup found in its home row must read, the row's 8 sig words and the
// hit's t_best word (about 10 KB, 0.000003 ms at 3.35 TB/s, for the whole
// kinase walk).
// chip_smoke.py measures that round trip with pointer_chase (below) and
// gives path nodes x round trip as the walk's latency floor.
//
// Design: one launch a run, one warp walking the path serially: no shared
// memory and no block barrier.  Every lane keeps the coordinate in
// registers and encodes the node itself (32 copies of the same integer
// work, in parallel).  A node is looked up in two stages:
//   1. its home row alone (sig: lanes 0-7 one way each of home bucket row
//      0, t_sig and t_best; key rows: every lane the same probe row 0, its
//      W key words and its t_best or t_fpar word, one broadcast): in a
//      finished table nearly every node is stored there, so a node costs
//      one round trip of one or two sectors;
//   2. on a miss there, every row, each lane issuing all its loads before
//      any compare so that they are all in flight at once:
//        sig:      lane l owns bucket rows l and l + 32: two int4 of t_sig
//                  and two of t_best each; the first hit in (r, way) order
//                  is a ballot over rows 0-31, then (if none) over rows
//                  32-63, the way found inside the winning lane;
//        key rows: lane l owns probe rows l, l + 32, l + 64 and l + 96:
//                  their W key words and t_best (t_fpar) words; the first
//                  hit in r order is a ballot over each quarter in turn.
// The parent mask moves from the winning lane by one __shfl_sync.  Slots
// are masked to the table (below C): the TRASH tail is never read.
//
// On the sig layout, where the node has at most 32 moves (N <= 5), lane
// m - 1 also encodes the candidate parent coord - bits(m) and prefetches
// its home bucket row into L2 while stage 1's loads are in flight: the next
// node's stage 1 then reads L2, not device memory.  On the engine's own
// walk right after a kinase search (chip_smoke.py engine_walk, NVIDIA H100
// 80GB HBM3 at 700 W) it took the sig walk from 0.25 to 0.19 ms; the same
// prefetch of the home probe row lost 4% on the packed walk and changed
// nothing on the unpacked one, so the key-row layouts do not prefetch.
//
// The sharded walk (parallel/sharded.py) runs in two forms.  Where the
// shards lie on several devices, rounds: each shard's hop mode
// (path_walk_hops, below: at most K = 8 hops while its own table holds
// the node), summed by the mesh (shard_loop.cu's walk_advance on a card).
// Where every shard's table lies on one card, the rounds save no
// collective (JAX walks in rounds only for its psum), so path_walk_shards
// walks the whole path in one launch: one warp, each node looked up as
// above in its owner's table (owner.cuh; the tables' addresses in the
// launch's parameters, up to 32), the round form's rounds counted on the
// way (a new round at the goal, wherever the owner changes and after K
// nodes of one owner).  It prefetches nothing: on an H100 a prefetch of
// the candidate parents' home rows in their owners' tables lost on every
// layout (0.18 against 0.26-0.29 ms at kinase on 4 shards), the owner's
// hash and the encode sitting between a node's load and its ballot.
// Bound as K7: one dependent round trip a node.

#include "owner.cuh"
#include "sig_key.cuh"
#include "step_state.cuh"

namespace {

constexpr int kThreads = 32;  // one warp
constexpr int kMaxN = 24;     // sig: K4's N <= 24; the key rows take N <= 16
constexpr int kMaxW = 8;      // key words of N <= 16
constexpr int kSigRows = 2;   // bucket rows a lane (64 rows)
constexpr int kKeyRows = 4;   // probe rows a lane (128 rows)
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

// The sig encoding of the node at `coord` (home bucket, sig base word).
__device__ __forceinline__ void sig_encode(const Table& t, const int32_t* coord,
                                           const int* shift, uint32_t& home, uint32_t& sigb) {
  unsigned long long ckey = 0;
#pragma unroll
  for (int d = 0; d < kMaxN; ++d)
    if (d < t.N) ckey |= (unsigned long long)(uint32_t)coord[d] << shift[d];
  sigkey::encode(ckey, t.bbits, home, sigb);
}

// The key words and home hash of the node at `coord`.
__device__ __forceinline__ uint32_t key_hash(const Table& t, const int32_t* coord,
                                             uint32_t* kw) {
#pragma unroll
  for (int i = 0; i < kMaxW; ++i) kw[i] = i < t.W ? step::key_word(coord, i, t.N) : 0u;
  return step::hash_keys(kw, t.W);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Prefetch the home bucket row of the candidate parent coord - bits(m) of
// this lane (m = lane + 1 <= M), sig.
__device__ __forceinline__ void prefetch_parent(const Table& t, const int32_t* coord,
                                                const int* shift) {
  const int m = (int)threadIdx.x + 1;
  if (t.N > 5 || m >= (1 << t.N)) return;
  int32_t c[kMaxN];
  bool ok = true;
#pragma unroll
  for (int d = 0; d < kMaxN; ++d) {
    c[d] = coord[d] - ((m >> d) & 1);
    ok &= c[d] >= 0;
  }
  if (!ok) return;
  uint32_t home, sigb;
  sig_encode(t, c, shift, home, sigb);
  const size_t at = (size_t)(home & (t.Cmask >> 3)) << 3;
  prefetch_l2(t.keys + at);
  prefetch_l2(t.best + at);
}

// The first hit of the node at `coord` over the warp, in JAX's argmax
// order, and its parent mask (every lane gets both): false if the node is
// not stored.  kPrefetch (sig): prefetch_parent while the home row's
// loads are in flight.
template <int kLayout, bool kPrefetch>
__device__ __forceinline__ bool lookup(const Table& t, const int32_t* coord, const int* shift,
                                       int parmask, int& par) {
  const int lane = threadIdx.x;
  if constexpr (kLayout == kSig) {
    uint32_t home, sigb;
    sig_encode(t, coord, shift, home, sigb);
    const uint32_t bmask = t.Cmask >> 3;
    {  // 1. the home row: lane l < 8 its way l (lanes 8-31 repeat them)
      const size_t at = ((size_t)(home & bmask) << 3) | (size_t)(lane & 7);
      const int32_t s0 = t.keys[at], b0 = t.best[at];
      if constexpr (kPrefetch) prefetch_parent(t, coord, shift);
      const unsigned ballot = __ballot_sync(kFull, lane < 8 && s0 == (int32_t)sigb);
      if (ballot) {
        par = __shfl_sync(kFull, b0, __ffs(ballot) - 1) & parmask;
        return true;
      }
    }
    // 2. every row
    int4 s[kSigRows][2], b[kSigRows][2];
#pragma unroll
    for (int k = 0; k < kSigRows; ++k) {  // every load first
      const int r = lane + 32 * k;
      const size_t at = (size_t)((home + (uint32_t)r) & bmask) << 3;
      if (r < t.probes) {
        const int4* sk = reinterpret_cast<const int4*>(t.keys + at);
        const int4* bk = reinterpret_cast<const int4*>(t.best + at);
        s[k][0] = sk[0];
        s[k][1] = sk[1];
        b[k][0] = bk[0];
        b[k][1] = bk[1];
      } else {
        s[k][0] = s[k][1] = make_int4(-1, -1, -1, -1);  // never a sig word
        b[k][0] = b[k][1] = make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kSigRows; ++k) {
      const int32_t want = (int32_t)(sigb | (uint32_t)(lane + 32 * k));
      const int32_t w8[8] = {s[k][0].x, s[k][0].y, s[k][0].z, s[k][0].w,
                             s[k][1].x, s[k][1].y, s[k][1].z, s[k][1].w};
      const int32_t p8[8] = {b[k][0].x, b[k][0].y, b[k][0].z, b[k][0].w,
                             b[k][1].x, b[k][1].y, b[k][1].z, b[k][1].w};
      int mine = 0, way = -1;
#pragma unroll
      for (int w = 7; w >= 0; --w)
        if (w8[w] == want) {
          way = w;  // the first matching way
          mine = p8[w];
        }
      const unsigned ballot = __ballot_sync(kFull, way >= 0);
      if (ballot) {
        par = __shfl_sync(kFull, mine, __ffs(ballot) - 1) & parmask;
        return true;
      }
    }
    return false;
  } else {
    uint32_t kw[kMaxW];
    const uint32_t h0 = key_hash(t, coord, kw);
    {  // 1. the home row, read by every lane (one broadcast)
      const uint32_t at = step::probe_slot(h0, 0, t.Cmask);
      const int32_t* row = t.keys + (size_t)at * t.KWs;
      int32_t key0[kMaxW];
#pragma unroll
      for (int i = 0; i < kMaxW; ++i) key0[i] = i < t.W ? row[i] : -1;
      long long word0;
      if constexpr (kLayout == kPacked)
        word0 = t.best[at];
      else
        word0 = t.fpar[at];
      bool eq = key0[0] != -1;
#pragma unroll
      for (int i = 0; i < kMaxW; ++i)
        if (i < t.W) eq &= key0[i] == (int32_t)kw[i];
      if (eq) {  // the same in every lane
        par = (int)(word0 & (long long)parmask);
        return true;
      }
    }
    // 2. every row
    int32_t key[kKeyRows][kMaxW];
    long long word[kKeyRows];
#pragma unroll
    for (int k = 0; k < kKeyRows; ++k) {  // every load first
      const int r = lane + 32 * k;
      const uint32_t at = step::probe_slot(h0, r, t.Cmask);
      const int32_t* row = t.keys + (size_t)at * t.KWs;
      const bool live = r < t.probes;
#pragma unroll
      for (int i = 0; i < kMaxW; ++i) key[k][i] = live && i < t.W ? row[i] : -1;
      if constexpr (kLayout == kPacked)
        word[k] = live ? t.best[at] : 0;
      else
        word[k] = live ? t.fpar[at] : 0;
      if (!live) key[k][0] = -1;  // an empty row never hits
    }
#pragma unroll
    for (int k = 0; k < kKeyRows; ++k) {
      bool eq = key[k][0] != -1;
#pragma unroll
      for (int i = 0; i < kMaxW; ++i)
        if (i < t.W) eq &= key[k][i] == (int32_t)kw[i];
      const unsigned ballot = __ballot_sync(kFull, eq);
      if (ballot) {
        par = (int)(__shfl_sync(kFull, word[k], __ffs(ballot) - 1) & (long long)parmask);
        return true;
      }
    }
    return false;
  }
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
    path_walk_kernel(Table t, const int32_t* __restrict__ params, int tmax,
                     int32_t* __restrict__ out, const int32_t* __restrict__ run) {
  if (run != nullptr && *run == 0) return;
  const int lane = threadIdx.x;
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
    int mask = 0;
    if (!lookup<kLayout, true>(t, coord, shift, parmask, mask))
      break;  // not stored: the walk ends
    if (lane == 0) out[it] = mask;
#pragma unroll
    for (int d = 0; d < kMaxN; ++d) coord[d] -= (mask >> d) & 1;
  }
  for (int k = it + lane; k < tmax; k += kThreads) out[k] = 0;
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < kMaxN; ++d)
      if (d < N) out[tmax + d] = coord[d];
    out[tmax + N] = it;  // every iteration before the last emitted
  }
}

// ---- the sharded walk on one card in one launch (path_walk_shards)

constexpr int kMaxShards = 32;  // parallel/sharded.py MAX_SHARDS

// Every shard's table on the card, in the launch's parameters (shard i's
// at [i]; the parent words t_best, or t_fpar on the unpacked layout).
struct Shards {
  const int32_t* keys[kMaxShards];
  const int32_t* best[kMaxShards];
  const long long* fpar[kMaxShards];
};

// The whole sharded walk, goal -> origin, in one warp: each node looked up
// in its owner's table (owner::of; a node lives in its owner's table
// only), the rounds of the round form counted as it would run them: a
// round starts at the goal and wherever the owner changes or `hops` nodes
// of one owner were walked; a node its owner does not hold ends the walk
// (mid-round, the round form's next round finds nothing: one more).  out:
// masks (tmax), the coordinate it stopped at (N), the masks' count, the
// rounds.
template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
    path_walk_shards_kernel(Table t, Shards sh, owner::Hash hash, int hops,
                            const int32_t* __restrict__ params, int tmax,
                            int32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const int N = t.N, parmask = (1 << N) - 1;
  int32_t coord[kMaxN];
  int shift[kMaxN];  // the sig key's field offsets
  int sh_bits = 0;
#pragma unroll
  for (int d = 0; d < kMaxN; ++d) {
    coord[d] = d < N ? params[d] : 0;
    shift[d] = sh_bits;
    if (d < N) sh_bits += params[N + d];
  }
  int it = 0, rounds = 0, owner_of_run = -1, run = 0;
  for (; it < tmax; ++it) {
    bool origin = true;
#pragma unroll
    for (int d = 0; d < kMaxN; ++d) origin &= coord[d] == 0;
    if (origin) break;
    const int o = owner::of<kMaxN>(hash, coord, N);
    if (o != owner_of_run || run == hops) {  // the round form's next round
      ++rounds;
      owner_of_run = o;
      run = 0;
    }
    Table own = t;
    own.keys = sh.keys[o];
    own.best = sh.best[o];
    own.fpar = sh.fpar[o];
    int mask = 0;
    if (!lookup<kLayout, false>(own, coord, shift, parmask, mask)) {
      rounds += run > 0;
      break;  // not stored: the walk ends
    }
    ++run;
    if (lane == 0) out[it] = mask;
#pragma unroll
    for (int d = 0; d < kMaxN; ++d) coord[d] -= (mask >> d) & 1;
  }
  for (int k = it + lane; k < tmax; k += kThreads) out[k] = 0;
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < kMaxN; ++d)
      if (d < N) out[tmax + d] = coord[d];
    out[tmax + N] = it;  // every iteration before the last emitted
    out[tmax + N + 1] = rounds;
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
static int walk(int layout, const void* keys, int KWs, const void* best, const void* fpar, int N,
                int C, int bbits, int probes, const void* params, int tmax, void* out,
                const void* run, void* stream) {
  const int W = (N + 1) / 2;
  const bool sig = layout == kSig;
  if (layout < kSig || layout > kUnpacked || keys == nullptr || params == nullptr ||
      out == nullptr || N < 2 || N > (sig ? kMaxN : 2 * kMaxW) || C < 8 || (C & (C - 1)) != 0 ||
      probes < 1 || probes > 32 * (sig ? kSigRows : kKeyRows) || tmax < 0 ||
      (layout == kUnpacked ? fpar == nullptr : best == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sig ? (1 << (bbits + 3)) != C : KWs != W + (layout == kPacked ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  const Table t{(const int32_t*)keys, KWs, (const int32_t*)best, (const long long*)fpar,
                N, W, bbits, probes, (uint32_t)(C - 1)};
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* p = (const int32_t*)params;
  int32_t* o = (int32_t*)out;
  const int32_t* r = (const int32_t*)run;
  if (sig)
    path_walk_kernel<kSig><<<1, kThreads, 0, s>>>(t, p, tmax, o, r);
  else if (layout == kPacked)
    path_walk_kernel<kPacked><<<1, kThreads, 0, s>>>(t, p, tmax, o, r);
  else
    path_walk_kernel<kUnpacked><<<1, kThreads, 0, s>>>(t, p, tmax, o, r);
  return (int)cudaGetLastError();
}

extern "C" int path_walk(int layout, const void* keys, int KWs, const void* best,
                         const void* fpar, int N, int C, int bbits, int probes,
                         const void* params, int tmax, void* out, void* stream) {
  return walk(layout, keys, KWs, best, fpar, N, C, bbits, probes, params, tmax, out, nullptr,
              stream);
}

// The hop-limited mode (the sharded walk, parallel/sharded.py: JAX
// _make_batched_walk :482 with _make_sharded_walk_sig :559,
// _make_sharded_walk_packed :733 and _make_sharded_walk :892): the same
// kernel on one shard's table of any layout, from the coordinate in params
// (not the goal), at most `hops` (K = 8) iterations; path_walk's
// arguments, `hops` in place of tmax.  It stops at the origin or at a node
// this table does not hold (another shard owns it); out holds the run of
// masks (hops,), the coordinate it stopped at and the run's length, as
// path_walk's.  The caller's mesh sums the runs of every shard and moves
// the coordinate on (on one card shard_loop.cu's walk_advance, which also
// moves the coordinate in params).  run: the walk loop's int32 flag, or
// null; the launch returns at once when it reads 0.
extern "C" int path_walk_hops(int layout, const void* keys, int KWs, const void* best,
                              const void* fpar, int N, int C, int bbits, int probes,
                              const void* params, int hops, void* out, const void* run,
                              void* stream) {
  if (hops < 1 || hops > 64) return (int)cudaErrorInvalidValue;
  return walk(layout, keys, KWs, best, fpar, N, C, bbits, probes, params, hops, out, run, stream);
}

// The sharded walk of one card in one launch (parallel/sharded.py
// _walk_loop where every shard's table lies on one card: JAX
// _make_batched_walk :482, its rounds of K hops a shard summed by psum,
// with no collective to save).  layout as path_walk's; tables: a host
// int64 table of ndev rows (keys, t_best, t_fpar) of device addresses,
// the shards' tables of one statics (C, bbits, probes, row stride KWs;
// t_best null on the unpacked layout, t_fpar null on the others), copied
// into the launch's parameters (ndev <= 32); the owner hash (kind, size =
// ndev, shift, zbits: parallel/partition.py::owner_params); hops: the
// round form's hops a round (WALK_HOPS), which only the round count
// reads; params: int32 [final
// coordinate N, key bit widths N]; out: (tmax + N + 2,) int32, the masks,
// the coordinate it stopped at, their count and the rounds.
extern "C" int path_walk_shards(int layout, const void* tables, int ndev, int KWs, int N,
                                int C, int bbits, int probes, int hash_kind, int hash_size,
                                int hash_shift, int zbits, int hops, const void* params,
                                int tmax, void* out, void* stream) {
  const int W = (N + 1) / 2;
  const bool sig = layout == kSig;
  if (layout < kSig || layout > kUnpacked || tables == nullptr || ndev < 1 ||
      ndev > kMaxShards || params == nullptr || out == nullptr || N < 2 ||
      N > (sig ? kMaxN : 2 * kMaxW) || C < 8 || (C & (C - 1)) != 0 || probes < 1 ||
      probes > 32 * (sig ? kSigRows : kKeyRows) || tmax < 0 || hops < 1 ||
      hash_size != ndev || hash_kind < 0 || hash_kind > 3 || hash_shift < 0 ||
      hash_shift > 31 || zbits < 1 || zbits > 32)
    return (int)cudaErrorInvalidValue;
  if (sig ? (1 << (bbits + 3)) != C : KWs != W + (layout == kPacked ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  const long long* tab = (const long long*)tables;
  Shards sh = {};
  for (int i = 0; i < ndev; ++i) {
    sh.keys[i] = (const int32_t*)tab[3 * i];
    sh.best[i] = (const int32_t*)tab[3 * i + 1];
    sh.fpar[i] = (const long long*)tab[3 * i + 2];
    if (sh.keys[i] == nullptr || (layout == kUnpacked ? sh.fpar[i] == nullptr
                                                      : sh.best[i] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const Table t{nullptr, KWs, nullptr, nullptr, N, W, bbits, probes, (uint32_t)(C - 1)};
  const owner::Hash hash{hash_kind, hash_size, hash_shift, zbits};
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* p = (const int32_t*)params;
  int32_t* o = (int32_t*)out;
  if (sig)
    path_walk_shards_kernel<kSig><<<1, kThreads, 0, s>>>(t, sh, hash, hops, p, tmax, o);
  else if (layout == kPacked)
    path_walk_shards_kernel<kPacked><<<1, kThreads, 0, s>>>(t, sh, hash, hops, p, tmax, o);
  else
    path_walk_shards_kernel<kUnpacked><<<1, kThreads, 0, s>>>(t, sh, hash, hops, p, tmax, o);
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
