// The route of a shard's candidates to their owners: kernel K11.
//
// Replaces, in mpi_pastar_msa_tpu/parallel/sharded.py, :87 _route_cap and
// :169 _route_ragged (XLA inside the sharded run loop) less their
// collective, which the mesh runs (parallel/mesh.py).  The port's plain
// version is parallel/sharded.py::route_plain.  The rows are the step's
// candidate lanes, `cand` (lanes, 4) int32 (dest, fsort, home, sig) as
// sig_expand.cu's sharded instantiation writes them (dest = ndev for a lane
// that stays), followed by the carry ring (Ccar, 4) of the rows spilled
// before; row r's position is r in [lanes; carry].  A row is remote when
// dest < ndev.  Per destination d its remote rows are ordered by (fsort,
// position): the first allow[d] ride the wire, to rows base[d] .. base[d] +
// allow[d] of `wire` (home, sig, fsort: sig_probe.cu's pending row) in that
// order; the rest spill, in (d, fsort, position) order, into the new carry
// ring, whose tail is filled with the empty row (ndev, INFP, 0, -1).
// carry_ovf = max(spilled - Ccar, 0) and the min fsort of the new ring's
// rows (INFP when it is empty) close the step's route.  JAX sorts with
// jax.lax.sort(num_keys=2), which is not stable, so which of two rows with
// equal (dest, fsort) rides the wire is unspecified there; the position
// fixes it here, and the plain version gives the same wire and ring bit for
// bit.
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
//      migrants), and each remote row's sort key (fsort << 32 | position,
//      fsort with its sign bit flipped) appended to its destination's
//      segment of `keys`.  The lanes of a
//      warp with the same destination (__match_any_sync) take one atomicAdd
//      for the group and rank themselves by their lane; the migrants are a
//      block's sum and one atomic a block.  The order of a segment is not
//      fixed: pass 2 sorts it.
//   2. route_pack: block d < ndev sorts destination d's segment, then
//      copies its rows by position into the wire and the ring, a row a
//      thread in sorted order (the sort and the copy are apart: a copy of
//      other rows is another Copy); the blocks after them fill the ring's
//      tail; out[ndev + 1] = carry_ovf, out[ndev + 2] = the ring's min
//      fsort (set to INFP by pass 1; each destination's first spilled row,
//      the smallest of its spill, takes an atomicMin).
//
// The sort (a merge sort over the segment padded to np2, a power of two
// of at least kKeys keys): each warp loads its 32 groups of kKeys keys
// (coalesced, lane by lane), and each thread sorts a group in registers (a
// bitonic network of compile-time indices); then rounds merge runs of w =
// kKeys, 2 kKeys, ... np2 / 2 keys pairwise, each thread writing the kKeys
// outputs of its group: a binary search along the merge path finds where
// they start in the two runs, then kKeys steps of a serial merge.  The
// rounds read one buffer and write the other, so one barrier a round
// suffices: a warp's __syncwarp while the runs merged lie within its 32
// groups, a named barrier over the threads that sort above, and one more
// before the copy.  In shared memory a group takes kKeys + 1 slots, so that
// a warp's accesses to its groups hit distinct banks.  Up to kShKeys keys
// sort between two buffers of shared memory (2 x 72 KB); up to 2 kShKeys
// each half sorts so, the first waiting in device memory (its own place in
// `keys`, in L2) while the second sorts, and the last round merges the two
// from shared memory into `keys`, whence the copy reads (a third shared
// buffer in place of the wait, 216 KB a block, made the device-memory
// rounds of larger segments 1.36x slower on the H100); above, the two
// buffers are two segments of device memory.  The block is sized to the
// segment: np2 / kKeys threads, at least a warp and at most kPackThreads
// (a thread loops over groups beyond), and the other threads leave at
// once.  At 1,024 keys: 128 threads, 7 rounds, 3 block barriers, where the
// block bitonic of commit c408a21 took 55 (and 57 with its load and its
// reduction).  Warp 0 computes the block's allowance while the others
// start to sort.  A bitonic sort in registers and warp shuffles (commit
// 7a5d08c) took fewer barriers and was no faster on the H100 at kinase's
// segments (PERF.md, K11's row).
//
// Built with -DK11_BARRIERS (a measurement build of chip_smoke.py and of
// the card tests, never the one the port loads), each sorting block counts
// the block barriers its sort executes, and route_pack_barriers reads the
// counts of the last launch.
//
// Key rows (C entries route_count_rows and route_pack_rows; JAX's routes
// with others = (h, keys...) on packed rows, (g, mask, keys...) on
// unpacked ones, :670-672 and :836-838): the same two passes over rows of
// `width` words (dest, fsort, payload), the payload the receiver's pending
// entry of keyrow_insert.cu (K10), so that the received rows drop into its
// pending list as they are: packed 2 + W + 4 words (fsort the packed word),
// unpacked 2 + W + 5 (fsort the f itself).  Only the row's reads and the
// copy differ: a wire row is the payload, a ring row the whole row, the
// ring's empty row (ndev, fempty, -1 x nkey, 0...) with fempty INFP
// (packed) or INF (unpacked), the ring's min fsort fempty when it is empty.
// A key's fsort has its sign bit flipped, so that the negative f of an
// unpacked row (degenerate weights) sorts below the others, as the plain
// version's signed sort does; a packed word is never negative.
//
// What bounds it on an H100: launches and the chain of dependent accesses
// (a row's read and its atomic; the counts, the keys, the row gathered by
// position, the store), not bytes.  At kinase on 4 shards a step reads
// 31,744 rows' dest words and writes a 254 KB ring (0.43 MB in all,
// 0.13 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;              // route_count's blocks
constexpr int kPackThreads = 512;           // route_pack's blocks
constexpr int kKeys = 8;                    // a thread's group of keys
constexpr int kWarpKeys = 32 * kKeys;       // a warp's groups
constexpr int kShKeys = 8192;               // keys a block sorts in two shared buffers
constexpr int kShSlots = kShKeys + kShKeys / kKeys;  // a shared buffer's slots (72 KB)
constexpr int kMaxDevices = 64;             // cards whose shared-memory attribute is cached
constexpr int kMaxDest = 1024;              // destinations (ndev) a call takes
constexpr int kMaxRow = 16;                 // a key row's words (2 + W + 5, W <= 8)
constexpr int32_t kInfp = 0x7FFFFFFF;
constexpr u64 kPad = ~0ull;                 // the padding key, after every real one

#ifdef K11_BARRIERS
__device__ int g_barriers[kMaxDest];  // each destination's block barriers, last launch
#endif

__device__ __forceinline__ int4 row_at(const int4* cand, const int4* carry, long long n_lanes,
                                       long long pos) {
  return pos < n_lanes ? cand[pos] : carry[pos - n_lanes];
}

// Row `pos` of [cand; carry], rows of `width` words (key rows).
__device__ __forceinline__ const int32_t* row_ptr(const int32_t* cand, const int32_t* carry,
                                                  long long n_lanes, int width, long long pos) {
  return pos < n_lanes ? cand + pos * width : carry + (pos - n_lanes) * width;
}

// (dest, fsort) of row `pos`: sig rows are one int4, key rows `width` words.
template <bool kSig>
__device__ __forceinline__ int2 head_at(const int32_t* cand, const int32_t* carry,
                                        long long n_lanes, int width, long long pos) {
  if constexpr (kSig) {
    const int4 v = row_at(reinterpret_cast<const int4*>(cand),
                          reinterpret_cast<const int4*>(carry), n_lanes, pos);
    return make_int2(v.x, v.y);
  } else {
    const int32_t* p = row_ptr(cand, carry, n_lanes, width, pos);
    return make_int2(p[0], p[1]);
  }
}

template <bool kSig>
__global__ void __launch_bounds__(kThreads) route_count_kernel(
    const int32_t* __restrict__ cand, const int32_t* __restrict__ carry, const long long* nsel,
    int M, int ccar, int ndev, long long seg, int width, int fempty, int32_t* __restrict__ out,
    u64* __restrict__ keys, const int32_t* __restrict__ run) {
  __shared__ int s_migr[kThreads / 32];
  if (run != nullptr && *run == 0) return;
  const long long n_lanes = *nsel * M;
  const long long n = n_lanes + ccar;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[ndev + 2] = fempty;
  int migr = 0;
  // a warp takes 32 consecutive rows a trip, all its lanes the same trips,
  // so its votes name every lane
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); r0 < n;
       r0 += stride) {
    const long long r = r0 + lane;
    int d = -1, f = 0;
    if (r < n) {
      const int2 v = head_at<kSig>(cand, carry, n_lanes, width, r);
      if (v.x >= 0 && v.x < ndev) {
        d = v.x;
        f = v.y;
      }
    }
    const unsigned remote = __ballot_sync(0xffffffffu, d >= 0);
    migr += __popc(__ballot_sync(0xffffffffu, d >= 0 && r < n_lanes));
    if (d >= 0) {
      const unsigned peers = __match_any_sync(remote, d);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&out[d], __popc(peers));
      at = __shfl_sync(remote, at, leader) + __popc(peers & ((1u << lane) - 1u));
      keys[(long long)d * seg + at] = ((u64)((uint32_t)f ^ 0x80000000u) << 32) | (u64)r;
    }
  }
  if (lane == 0) s_migr[threadIdx.x >> 5] = migr;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m += s_migr[w];
    if (m) atomicAdd(&out[ndev], m);
  }
}

// Destination d's allowance, its first wire row and the rows spilled
// before it (the destinations before d), and the rows spilled in all.
struct Allowance {
  long long spill_before, base, spilled;
  int allow;
};

// One warp, every lane the same result: the lanes take the destinations
// 32 at a time, with a warp scan of the spills and the allowances.  d
// outside [0, ndev) gives the total spilled only.
__device__ Allowance allowance(const int32_t* out, const int32_t* S, int ndev, int me, int cap,
                               int d) {
  const int lane = threadIdx.x & 31;
  long long spilled = 0, base = 0, d_spill = 0, d_base = 0, d_allow = 0;
  for (int q0 = 0; q0 < ndev; q0 += 32) {
    const int q = q0 + lane;
    long long cnt = 0, allow = 0;
    if (q < ndev) {
      cnt = out[q];
      allow = cap;
      if (S != nullptr) {
        long long before = 0;
        for (int i = 0; i < me; ++i) before += S[i * ndev + q];
        const long long a = (long long)ndev * cap - before;
        allow = a < 0 ? 0 : (a > cnt ? cnt : a);
      }
    }
    const long long over = cnt > allow ? cnt - allow : 0;
    long long so = over, sa = allow;  // inclusive scans
    for (int o = 1; o < 32; o <<= 1) {
      const long long xo = __shfl_up_sync(0xffffffffu, so, o);
      const long long xa = __shfl_up_sync(0xffffffffu, sa, o);
      if (lane >= o) {
        so += xo;
        sa += xa;
      }
    }
    if (q == d) {
      d_spill = spilled + so - over;
      d_base = base + sa - allow;
      d_allow = allow;
    }
    spilled += __shfl_sync(0xffffffffu, so, 31);
    base += __shfl_sync(0xffffffffu, sa, 31);
  }
  Allowance a{0, 0, spilled, 0};
  if (d >= 0 && d < ndev) {
    const int src = d & 31;
    a.spill_before = __shfl_sync(0xffffffffu, d_spill, src);
    a.base = S != nullptr ? __shfl_sync(0xffffffffu, d_base, src) : (long long)d * cap;
    a.allow = (int)__shfl_sync(0xffffffffu, d_allow, src);
  }
  return a;
}

// The barrier of a sorting block's nt threads (the other warps have left).
__device__ __forceinline__ void sort_sync(int nt) {
  if (nt > 32) {
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
#ifdef K11_BARRIERS
    if (threadIdx.x == 0) ++g_barriers[blockIdx.x];
#endif
  } else {
    __syncwarp();
  }
}

// Sort a group's kKeys keys ascending in registers.
__device__ __forceinline__ void sort_group(u64 (&v)[kKeys]) {
#pragma unroll
  for (int k = 2; k <= kKeys; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int l = i ^ j;
        if (l > i && (v[i] > v[l]) == ((i & k) == 0)) {
          const u64 t = v[i];
          v[i] = v[l];
          v[l] = t;
        }
      }
}

// Slot of key i in a working buffer: in shared memory a group of kKeys
// keys takes kKeys + 1 slots.
template <bool kShared>
__device__ __forceinline__ int slot_of(int i) {
  return kShared ? i + i / kKeys : i;
}

// Outputs o .. o + kKeys of the merge of the sorted runs at keys a and b
// of buffer x, w keys each, into v.  A key of a goes first only when
// smaller, so the padding keys, all equal, merge too.  No branch on the
// keys: a lane's steps differ only in what it loads.
template <bool kShared>
__device__ __forceinline__ void merge_group(const u64* x, int a, int b, int w, int o,
                                            u64 (&v)[kKeys]) {
  // the keys of a among the first o outputs: a lower bound on the merge path
  int lo = o > w ? o - w : 0, len = (o < w ? o : w) - lo;
  while (len > 0) {
    const int half = len >> 1, mid = lo + half;
    const bool less = x[slot_of<kShared>(a + mid)] < x[slot_of<kShared>(b + o - 1 - mid)];
    lo = less ? mid + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  int ia = lo, ib = o - lo;
  u64 ka = x[slot_of<kShared>(a + (ia < w ? ia : w - 1))];
  u64 kb = x[slot_of<kShared>(b + (ib < w ? ib : w - 1))];
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const bool from_a = ib >= w || (ia < w && ka < kb);
    v[r] = from_a ? ka : kb;
    ia += from_a;
    ib += !from_a;
    const u64 next = x[slot_of<kShared>(from_a ? a + (ia < w ? ia : w - 1)
                                               : b + (ib < w ? ib : w - 1))];
    ka = from_a ? next : ka;
    kb = from_a ? kb : next;
  }
}

// Sort the n keys of src ascending into one of the two working buffers x
// and y (np2 keys each, at slot_of; x may be src), and return it.  nt
// threads (a multiple of 32) take part, thread t the groups t, t + nt, ...
template <bool kShared>
__device__ u64* sort_segment(u64* x, u64* y, const u64* src, int n, int np2, int nt) {
  const int groups = np2 / kKeys, lane = threadIdx.x & 31;
  u64 v[kKeys];
  for (int g0 = threadIdx.x - lane; g0 < groups; g0 += nt) {  // a warp's 32 groups a trip
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {  // lane by lane, then a group a thread
      const int i = g0 * kKeys + r * 32 + lane;
      if (i < np2) x[slot_of<kShared>(i)] = i < n ? src[i] : kPad;
    }
    __syncwarp();
    const int g = g0 + lane;
    if (g < groups) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r) v[r] = x[slot_of<kShared>(g * kKeys + r)];
      sort_group(v);
#pragma unroll
      for (int r = 0; r < kKeys; ++r) x[slot_of<kShared>(g * kKeys + r)] = v[r];
    }
  }
  for (int w = kKeys; w < np2; w <<= 1) {
    if (2 * w <= kWarpKeys)
      __syncwarp();
    else
      sort_sync(nt);
    for (int g = threadIdx.x; g < groups; g += nt) {
      const int at = g * kKeys, pair = at & ~(2 * w - 1);
      merge_group<kShared>(x, pair, pair + w, w, at - pair, v);
#pragma unroll
      for (int r = 0; r < kKeys; ++r) y[slot_of<kShared>(at + r)] = v[r];
    }
    u64* t = x;
    x = y;
    y = t;
  }
  sort_sync(nt);
  return x;
}

// The copy of destination d's sorted rows: the first allow to the wire
// (home, sig, fsort), the rest to the ring from its spill offset, the first
// of them taking the ring's min.
struct WireRingCopy {
  typedef int4 Row;
  const int4* cand;
  const int4* carry;
  long long n_lanes;
  int ccar, ndev, d;
  Allowance a;
  int32_t* out;
  int32_t* wire;
  int4* carry_out;

  __device__ int4 row(u64 key) const {
    return row_at(cand, carry, n_lanes, (long long)(key & 0xffffffffull));
  }

  __device__ void put(int i, int4 v) const {
    if (i < a.allow) {
      int32_t* w = wire + 3 * (a.base + i);
      w[0] = v.z;
      w[1] = v.w;
      w[2] = v.y;
      return;
    }
    const long long slot = a.spill_before + (i - a.allow);
    if (slot < ccar) {
      carry_out[slot] = make_int4(d, v.y, v.z, v.w);
      if (i == a.allow) atomicMin(&out[ndev + 2], v.y);
    }
  }
};

// The copy of destination d's sorted key rows: the first allow to the wire
// (the payload: the receiver's pending entry), the rest to the ring from
// its spill offset, the first of them taking the ring's min.  row() gives
// the row's position; put() reads its words, all loads first, then
// stores them.
struct KeyRowCopy {
  typedef long long Row;
  const int32_t* cand;
  const int32_t* carry;
  long long n_lanes;
  int width, ccar, ndev, d;
  Allowance a;
  int32_t* out;
  int32_t* wire;
  int32_t* carry_out;

  __device__ long long row(u64 key) const { return (long long)(key & 0xffffffffull); }

  __device__ void put(int i, long long pos) const {
    const int32_t* src = row_ptr(cand, carry, n_lanes, width, pos);
    int32_t v[kMaxRow];
#pragma unroll
    for (int w = 0; w < kMaxRow; ++w) v[w] = w < width ? src[w] : 0;
    if (i < a.allow) {
      int32_t* dst = wire + (a.base + i) * (width - 2);
#pragma unroll
      for (int w = 2; w < kMaxRow; ++w)
        if (w < width) dst[w - 2] = v[w];
      return;
    }
    const long long slot = a.spill_before + (i - a.allow);
    if (slot < ccar) {
      int32_t* dst = carry_out + slot * width;
      dst[0] = d;
#pragma unroll
      for (int w = 1; w < kMaxRow; ++w)
        if (w < width) dst[w] = v[w];
      if (i == a.allow) atomicMin(&out[ndev + 2], v[1]);
    }
  }
};

// Copy the n sorted keys' rows, a row a thread (consecutive threads on
// consecutive rows), kKeys rows read before any is written.
template <bool kShared, class Copy>
__device__ void copy_sorted(const u64* x, int n, int nt, const Copy& copy) {
  for (int i0 = threadIdx.x; i0 < n; i0 += nt * kKeys) {
    typename Copy::Row v[kKeys];
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int i = i0 + r * nt;
      if (i < n) v[r] = copy.row(x[slot_of<kShared>(i)]);
    }
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int i = i0 + r * nt;
      if (i < n) copy.put(i, v[r]);
    }
  }
}

constexpr int log2_of(int x) { return x > 1 ? 1 + log2_of(x >> 1) : 0; }

// A half's sort ends in the buffer it started in (an even number of rounds).
static_assert(log2_of(kShKeys / kKeys) % 2 == 0, "a half must sort back into its buffer");

// Sort the n keys of k, kShKeys < n <= 2 kShKeys, in place, the halves in
// the two shared buffers: half 0 sorts and waits in its own place in k
// while half 1 sorts; half 0 comes back into the second buffer, and the
// last round merges the two (half 0 the first run) from shared memory into
// k.
__device__ void sort_halves(u64* sh, u64* k, int n, int nt) {
  u64* h0 = sh + kShSlots;
  sort_segment<true>(sh, h0, k, kShKeys, kShKeys, nt);
  for (int i = threadIdx.x; i < kShKeys; i += nt) k[i] = sh[slot_of<true>(i)];
  sort_sync(nt);
  sort_segment<true>(sh, h0, k + kShKeys, n - kShKeys, kShKeys, nt);
  for (int i = threadIdx.x; i < kShKeys; i += nt) h0[slot_of<true>(i)] = k[i];
  sort_sync(nt);
  u64 v[kKeys];
  for (int g = threadIdx.x; g < 2 * kShKeys / kKeys; g += nt) {
    merge_group<true>(sh, kShKeys, 0, kShKeys, g * kKeys, v);
#pragma unroll
    for (int r = 0; r < kKeys; ++r) k[g * kKeys + r] = v[r];
  }
  sort_sync(nt);
}

template <bool kSig>
__global__ void __launch_bounds__(kPackThreads) route_pack_kernel(
    const int32_t* __restrict__ cand, const int32_t* __restrict__ carry, const long long* nsel,
    int M, int ccar, int ndev, int me, int cap, const int32_t* __restrict__ S, long long seg,
    int width, int nkey, int fempty, int32_t* __restrict__ out, u64* __restrict__ keys,
    int32_t* __restrict__ wire, int32_t* __restrict__ carry_out, const int32_t* __restrict__ run) {
  extern __shared__ u64 sh[];
  __shared__ Allowance s_allow;  // the block's, from warp 0
  if (run != nullptr && *run == 0) return;
  const int d = blockIdx.x;
  if (d >= ndev) {  // the ring's tail: the empty row
    if (threadIdx.x < 32) {
      const Allowance a = allowance(out, S, ndev, me, cap, -1);
      if (threadIdx.x == 0) s_allow = a;
    }
    __syncthreads();
    const long long spilled = s_allow.spilled;
    const long long t = (long long)(blockIdx.x - ndev) * blockDim.x + threadIdx.x;
    if (t == 0) out[ndev + 1] = (int32_t)(spilled > ccar ? spilled - ccar : 0);
    for (long long s = spilled + t; s < ccar; s += (long long)(gridDim.x - ndev) * blockDim.x) {
      if constexpr (kSig) {
        reinterpret_cast<int4*>(carry_out)[s] = make_int4(ndev, kInfp, 0, -1);
      } else {
        int32_t* dst = carry_out + s * width;
        dst[0] = ndev;
        dst[1] = fempty;
        for (int w = 2; w < width; ++w) dst[w] = w < 2 + nkey ? -1 : 0;
      }
    }
    return;
  }
  const int n = out[d];
#ifdef K11_BARRIERS
  if (threadIdx.x == 0) g_barriers[d] = 0;
#endif
  if (n == 0) return;
  int np2 = kKeys;
  while (np2 < n) np2 <<= 1;
  const int nt = np2 <= kWarpKeys ? 32 : (np2 / kKeys < kPackThreads ? np2 / kKeys : kPackThreads);
  if ((int)threadIdx.x >= nt) return;
  if (threadIdx.x < 32) {
    const Allowance a = allowance(out, S, ndev, me, cap, d);
    if (threadIdx.x == 0) s_allow = a;
  }
  u64* k = keys + (long long)d * seg;
  const u64* x = k;
  if (np2 <= kShKeys)
    x = sort_segment<true>(sh, sh + kShSlots, k, n, np2, nt);
  else if (np2 == 2 * kShKeys)
    sort_halves(sh, k, n, nt);
  else
    x = sort_segment<false>(k, keys + (long long)(ndev + d) * seg, k, n, np2, nt);
  // the sort's last barrier of the nt threads is passed: s_allow is set
  if constexpr (kSig) {
    const WireRingCopy copy{reinterpret_cast<const int4*>(cand),
                            reinterpret_cast<const int4*>(carry), *nsel * M, ccar, ndev, d,
                            s_allow, out, wire, reinterpret_cast<int4*>(carry_out)};
    if (np2 <= kShKeys)
      copy_sorted<true>(x, n, nt, copy);
    else
      copy_sorted<false>(x, n, nt, copy);
  } else {
    const KeyRowCopy copy{cand, carry, *nsel * M, width, ccar, ndev, d, s_allow, out, wire,
                          carry_out};
    if (np2 <= kShKeys)
      copy_sorted<true>(x, n, nt, copy);
    else
      copy_sorted<false>(x, n, nt, copy);
  }
}

// route_count's first launch: the counts and the migrants zeroed (a
// kernel, not a memset, so that it too does nothing once the run stops)
__global__ void route_zero_kernel(int32_t* __restrict__ out, int n,
                                  const int32_t* __restrict__ run) {
  if (run != nullptr && *run == 0) return;
  for (int k = threadIdx.x; k < n; k += blockDim.x) out[k] = 0;
}

int grid_of(long long rows, int threads) {
  long long b = (rows + threads - 1) / threads;
  if (b < 1) b = 1;
  return (int)(b > 1024 ? 1024 : b);
}

// route_pack's dynamic shared memory, allowed once a card and
// instantiation: the attribute belongs to the current card, and one
// process may hold shards on several
template <bool kSig>
int allow_shared(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(route_pack_kernel<kSig>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)e;
}

template <bool kSig>
int count(const void* cand, const void* carry, const void* nsel, int M, int lanes_cap, int ccar,
          int ndev, long long seg, int width, int fempty, void* out, void* keys, const void* run,
          void* stream) {
  if (cand == nullptr || carry == nullptr || nsel == nullptr || out == nullptr ||
      keys == nullptr || M < 1 || lanes_cap < 0 || ccar < 1 || ndev < 1 || ndev > kMaxDest ||
      seg < (long long)lanes_cap + ccar || seg >= (1ll << 31) || (seg & (seg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  route_zero_kernel<<<1, 256, 0, s>>>((int32_t*)out, ndev + 1, (const int32_t*)run);
  route_count_kernel<kSig><<<grid_of((long long)lanes_cap + ccar, kThreads), kThreads, 0, s>>>(
      (const int32_t*)cand, (const int32_t*)carry, (const long long*)nsel, M, ccar, ndev, seg,
      width, fempty, (int32_t*)out, (u64*)keys, (const int32_t*)run);
  return (int)cudaGetLastError();
}

template <bool kSig>
int pack(const void* cand, const void* carry, const void* nsel, int M, int ccar, int ndev, int me,
         int cap, const void* S, long long seg, int width, int nkey, int fempty, void* out,
         void* keys, void* wire, void* carry_out, const void* run, void* stream) {
  if (cand == nullptr || carry == nullptr || nsel == nullptr || out == nullptr ||
      keys == nullptr || wire == nullptr || carry_out == nullptr || carry_out == carry ||
      M < 1 || ccar < 1 || ndev < 1 || ndev > kMaxDest || me < 0 || me >= ndev || cap < 1 ||
      seg < 1 || seg >= (1ll << 31) || (seg & (seg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int shared = 2 * kShSlots * (int)sizeof(u64);
  const int e = allow_shared<kSig>(shared);
  if (e != 0) return e;
  route_pack_kernel<kSig><<<ndev + grid_of(ccar, kPackThreads), kPackThreads, shared,
                            (cudaStream_t)stream>>>(
      (const int32_t*)cand, (const int32_t*)carry, (const long long*)nsel, M, ccar, ndev, me, cap,
      (const int32_t*)S, seg, width, nkey, fempty, (int32_t*)out, (u64*)keys, (int32_t*)wire,
      (int32_t*)carry_out, (const int32_t*)run);
  return (int)cudaGetLastError();
}

}  // namespace

// cand: (lanes_cap, 4) int32; carry: (ccar, 4) int32; nsel: the step's
// selected rows (step_state.cuh kNSel, int64), lanes = nsel x M <=
// lanes_cap; out: (ndev + 3,) int32 (counts, migrants, carry_ovf, ring
// min); keys: (2, ndev, seg) uint64 scratch, seg a power of two >=
// lanes_cap + ccar (pass 1 fills the first half; a segment of more than
// 2 kShKeys keys sorts between its two halves).  run: the step loop's
// int32 flag, or null; both passes return at once when it reads 0.
extern "C" int route_count(const void* cand, const void* carry, const void* nsel, int M,
                           int lanes_cap, int ccar, int ndev, long long seg, void* out,
                           void* keys, const void* run, void* stream) {
  return count<true>(cand, carry, nsel, M, lanes_cap, ccar, ndev, seg, 4, kInfp, out, keys,
                     run, stream);
}

// After route_count on the same buffers.  S: (ndev, ndev) int32 send
// counts of every shard (ragged), or null (dense: allowance cap); wire:
// (>= ndev cap, 3) int32 (dense) or (>= lanes_cap + ccar, 3) (ragged);
// carry_out: (ccar, 4) int32, not the carry read.  ndev sorting blocks,
// then the ring's tail's blocks.
extern "C" int route_pack(const void* cand, const void* carry, const void* nsel, int M,
                          int ccar, int ndev, int me, int cap, const void* S, long long seg,
                          void* out, void* keys, void* wire, void* carry_out, const void* run,
                          void* stream) {
  return pack<true>(cand, carry, nsel, M, ccar, ndev, me, cap, S, seg, 4, 0, kInfp, out, keys,
                    wire, carry_out, run, stream);
}

// The passes on key rows: route_count's and route_pack's arguments, with
// cand (lanes_cap, width) and carry / carry_out (ccar, width) int32 rows,
// width = 2 + the pending entry's words (3 .. kMaxRow), nkey the key words
// of the empty row and fempty its fsort (out[ndev + 2] of an empty ring);
// wire rows have width - 2 words.
extern "C" int route_count_rows(const void* cand, const void* carry, const void* nsel, int M,
                                int lanes_cap, int ccar, int ndev, long long seg, int width,
                                int nkey, int fempty, void* out, void* keys, const void* run,
                                void* stream) {
  if (width < 3 || width > kMaxRow || nkey < 0 || nkey > width - 2)
    return (int)cudaErrorInvalidValue;
  return count<false>(cand, carry, nsel, M, lanes_cap, ccar, ndev, seg, width, fempty, out, keys,
                      run, stream);
}

extern "C" int route_pack_rows(const void* cand, const void* carry, const void* nsel, int M,
                               int ccar, int ndev, int me, int cap, const void* S, long long seg,
                               int width, int nkey, int fempty, void* out, void* keys, void* wire,
                               void* carry_out, const void* run, void* stream) {
  if (width < 3 || width > kMaxRow || nkey < 0 || nkey > width - 2)
    return (int)cudaErrorInvalidValue;
  return pack<false>(cand, carry, nsel, M, ccar, ndev, me, cap, S, seg, width, nkey, fempty, out,
                     keys, wire, carry_out, run, stream);
}

#ifdef K11_BARRIERS
// The block barriers of each destination's sort in the last route_pack
// (ndev ints into host memory; waits for the card).
extern "C" int route_pack_barriers(int* host, int ndev) {
  if (host == nullptr || ndev < 1 || ndev > kMaxDest) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_barriers, sizeof(int) * ndev);
}
#endif
