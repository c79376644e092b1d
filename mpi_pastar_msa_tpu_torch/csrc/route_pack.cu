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
// The live rows.  A ring's spilled rows are its first rows and the empty
// row fills the rest, so a word beside each ring buffer, its live length
// (a bound: every row from it on is the empty row), lets both passes touch
// only the live rows: the count reads [lanes; carry[:len]], and the pack
// writes the spilled rows, then the empty row over [len_new, len_old) of
// the buffer it writes (whose word says how far its last write reached),
// and stores len_new = min(spilled, Ccar) there.  The buffer stays the
// plain version's whole ring, word for word.  A buffer of unknown contents
// takes the word Ccar.
//
// Two passes, one launch each (the ragged allowance needs every shard's
// counts between them):
//   1. route_count: the remote rows of each destination (counts[d], d <
//      ndev), the remote rows among the lanes (counts[ndev], the step's
//      migrants), and each remote row's sort key (fsort << 32 | position,
//      fsort with its sign bit flipped) appended to its destination's
//      segment of `keys`.  The lanes of a warp with the same destination
//      (__match_any_sync) take one atomicAdd for the group and rank
//      themselves by their lane; the migrants are a block's sum and one
//      atomic a block.  The order of a segment is not fixed: pass 2 sorts
//      it.  `counts` is one of two buffers that alternate from step to
//      step: block 0 zeroes the other, `counts_next`, whose values no
//      reader of this step's needs, so that no launch of its own zeroes
//      them; it also sets out[ndev + 2] to the empty fsort.
//   2. route_pack: block d < ndev sorts destination d's segment, then
//      copies its rows by position into the wire and the ring, a row a
//      thread in sorted order (the sort and the copy are apart: a copy of
//      other rows is another Copy); block ndev copies the counts and
//      migrants into out[0 .. ndev], sets out[ndev + 1] = carry_ovf, fills
//      the ring's tail and stores its live length; out[ndev + 2] = the
//      ring's min fsort (each destination's first spilled row, the
//      smallest of its spill, takes an atomicMin).
//
// The sort (a merge sort over the segment padded to np2, a power of two
// of at least kKeys keys, by the nt = np2 / kKeys threads of the block,
// at least a warp and at most kPackThreads, a group of kKeys keys a
// thread, a thread looping over groups beyond): each warp's 32 groups, a
// run of kWarpKeys keys, are sorted by a bitonic network in the warp's
// registers (stages within a thread in registers, across threads by
// __shfl_xor_sync, no barrier); then rounds merge runs of w = kWarpKeys,
// 2 kWarpKeys, ... np2 / 2 keys pairwise, each thread writing the kKeys
// outputs of its group: a binary search along the merge path finds where
// they start in the two runs, then kKeys steps of a serial merge.  The
// rounds read one buffer and write the other, so one barrier a round
// suffices, a named barrier over the threads that sort, and one more at
// the end.  In shared memory a group takes kKeys + 1 slots, so that a
// warp's accesses to its groups hit distinct banks.  Up to kSmallKeys keys
// (a group a thread) each thread loads its group straight into registers,
// and the block takes the least and the largest fsort (one more barrier):
// when every key then fits 32 bits, ((fsort - least) << log2 seg) |
// position, the network and the rounds run on those keys, one word where
// the 64-bit ones take two (at kinase most segments do: PERF.md).  Up to
// kShKeys keys sort between two buffers of shared memory (2 x 72 KB); up
// to 2 kShKeys each half sorts so, the first waiting in device memory (its
// own place in `keys`, in L2) while the second sorts, and the last round
// merges the two from shared memory into `keys`, whence the copy reads (a
// third shared buffer in place of the wait, 216 KB a block, made the
// device-memory rounds of larger segments 1.36x slower on the H100);
// above, the two buffers are two segments of device memory.  At 1,456 keys
// 256 threads: the load, the warps' networks, 3 merge rounds and 5 block
// barriers in all; the design of commit b8321dc merged from runs of kKeys
// keys, five more rounds within a warp, and its sort took 11.6 us of the
// 20 us call on the H100 (PERF.md, K11's row).  A warp that does not sort
// computes the block's allowance meanwhile (warp 0 first when every warp
// sorts).
//
// The copy runs on every thread of the block after a block barrier: on
// sig rows a row a thread (an int4), kKeys rows loaded before any is
// stored; on key rows 8 or 16 lanes a row, a word a lane, the wire rows
// sent and then the ring rows kept gathered into shared memory the sort
// no longer needs, then stored from there 16 bytes a lane.  At kinase's
// step a row a thread took 4.8 us (256 threads) and a word a lane 3.4
// (PERF.md).
//
// Built with -DK11_BARRIERS (a measurement build of chip_smoke.py and of
// the card tests, never the one the port loads), each sorting block counts
// the block barriers its sort executes, and route_pack_barriers reads the
// counts of the last launch; built with -DK11_PHASES (the smoke's), both
// passes leave %globaltimer readings of their phases, which
// route_pack_phases reads, and with it -DK11_COPY_NO_LOAD or
// -DK11_COPY_NO_STORE leave out the key-row copy's loads or its stores to
// device memory (their rows are wrong: the smoke's measure of what the
// copy waits on).
//
// Key rows (C entries route_count_rows and route_pack_rows; JAX's routes
// with others = (h, keys...) on packed rows, (g, mask, keys...) on
// unpacked ones, :670-672 and :836-838): the same two passes over rows of
// `width` words (dest, fsort, payload), the payload the receiver's pending
// entry of keyrow_insert.cu (K10), so that the received rows drop into its
// pending list as they are: packed 2 + W + 4 words (fsort the packed word),
// unpacked 2 + W + 5 (fsort the f itself), 9 and 10 at kinase's W = 3.
// Only the row's reads and the copy differ: a wire row is the payload, a
// ring row the whole row, the ring's empty row (ndev, fempty, -1 x nkey,
// 0...) with fempty INFP (packed) or INF (unpacked), the ring's min fsort
// fempty when it is empty.  A key's fsort has its sign bit flipped, so
// that the negative f of an unpacked row (degenerate weights) sorts below
// the others, as the plain version's signed sort does; a packed word is
// never negative.
//
// What bounds it on an H100: launches and the chain of dependent accesses
// (a row's read and its atomic; the counts, the keys, the sort's rounds,
// the row gathered by position, the store), not bytes.  At kinase on 4
// shards a step reads 15,748 lanes' dest words and the remote rows and
// writes the rows sent, about 0.15 MB (0.05 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;              // route_count's blocks
constexpr int kPackThreads = 512;           // route_pack's blocks
constexpr int kKeys = 8;                    // a thread's group of keys
constexpr int kWarpKeys = 32 * kKeys;       // a warp's groups: the run its network sorts
constexpr int kShKeys = 8192;               // keys a block sorts in two shared buffers
constexpr int kShSlots = kShKeys + kShKeys / kKeys;  // a shared buffer's slots (72 KB)
constexpr int kMaxDevices = 64;             // cards whose shared-memory attribute is cached
constexpr int kMaxDest = 1024;              // destinations (ndev) a call takes
constexpr int kMaxRow = 16;                 // a key row's words (2 + W + 5, W <= 8)
constexpr int kSmallKeys = kPackThreads * kKeys;  // segments sorted a group a thread
constexpr int kStageWords = 2 * kShSlots;   // the copy's stage: a shared buffer, in words
constexpr int32_t kInfp = 0x7FFFFFFF;
constexpr u64 kPad = ~0ull;                 // the padding key, after every real one

#ifdef K11_BARRIERS
__device__ int g_barriers[kMaxDest];  // each destination's block barriers, last launch
#endif

// Built with -DK11_PHASES, %globaltimer readings (ns) of the calls since
// the last read, read and reset by route_pack_phases: [0] unused (commit
// b8321dc's zero launch's start), [1] count block 0's start, [2] its end, [3]
// the last count block's end, [4] the first pack block's start, [5] the
// last pack block's end; sorting block d < kPhaseDest at kStampSort +
// kSortStamps d: its start, its allowance, its warp 0's keys loaded, every
// warp's network done (the first merge round's barrier passed), its sort
// and its copy done; the ring tail's block at kStampTail: its start, its
// allowance and its fill done.
constexpr int kPhaseDest = 8;
constexpr int kStampSort = 6;
constexpr int kSortStamps = 6;
constexpr int kStampTail = kStampSort + kSortStamps * kPhaseDest;
constexpr int kStamps = kStampTail + 3;
#ifdef K11_PHASES
__device__ u64 g_stamps[kStamps];
__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K11_STAMP(i) (g_stamps[i] = globaltimer())
#define K11_STAMP_MIN(i) atomicMin(&g_stamps[i], globaltimer())
#define K11_STAMP_MAX(i) atomicMax(&g_stamps[i], globaltimer())
#else
#define K11_STAMP(i) ((void)0)
#define K11_STAMP_MIN(i) ((void)0)
#define K11_STAMP_MAX(i) ((void)0)
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

// A ring's live length from its word, within [0, ccar].
__device__ __forceinline__ long long live_of(const int32_t* len, int ccar) {
  const int v = *len;
  return v < 0 ? 0 : (v > ccar ? ccar : v);
}

template <bool kSig>
__global__ void __launch_bounds__(kThreads) route_count_kernel(
    const int32_t* __restrict__ cand, const int32_t* __restrict__ carry,
    const int32_t* __restrict__ carry_len, const long long* nsel, int M, int ccar, int ndev,
    long long seg, int width, int fempty, int32_t* __restrict__ counts,
    int32_t* __restrict__ counts_next, int32_t* __restrict__ out, u64* __restrict__ keys,
    const int32_t* __restrict__ run) {
  __shared__ int s_migr[kThreads / 32];
  if (run != nullptr && *run == 0) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) K11_STAMP(1);
  const long long n_lanes = *nsel * M;
  const long long n = n_lanes + live_of(carry_len, ccar);
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0) {
    for (int q = threadIdx.x; q <= ndev; q += blockDim.x) counts_next[q] = 0;
    if (threadIdx.x == 0) out[ndev + 2] = fempty;
  }
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
      if (lane == leader) at = atomicAdd(&counts[d], __popc(peers));
      at = __shfl_sync(remote, at, leader) + __popc(peers & ((1u << lane) - 1u));
      keys[(long long)d * seg + at] = ((u64)((uint32_t)f ^ 0x80000000u) << 32) | (u64)r;
    }
  }
  if (lane == 0) s_migr[threadIdx.x >> 5] = migr;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m += s_migr[w];
    if (m) atomicAdd(&counts[ndev], m);
    if (blockIdx.x == 0) K11_STAMP(2);
    K11_STAMP_MAX(3);
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
__device__ Allowance allowance(const int32_t* counts, const int32_t* S, int ndev, int me,
                               int cap, int d) {
  const int lane = threadIdx.x & 31;
  long long spilled = 0, base = 0, d_spill = 0, d_base = 0, d_allow = 0;
  for (int q0 = 0; q0 < ndev; q0 += 32) {
    const int q = q0 + lane;
    long long cnt = 0, allow = 0;
    if (q < ndev) {
      cnt = counts[q];
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

// Keys a and b in ascending order.
template <class Key>
__device__ __forceinline__ void order(Key& a, Key& b) {
  const Key lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Sort a warp's kWarpKeys keys ascending, lane l holding keys l kKeys ..
// l kKeys + kKeys - 1 of the run in v, by a bitonic network in which every
// merge sorts ascending: the merge of runs of k / 2 keys first pairs key e
// with e ^ (k - 1), its mirror, then with e ^ j for j = k / 4 .. 1, the
// lower index taking the smaller key.  A partner in the same lane is a
// register; one in lane l ^ m comes by __shfl_xor_sync.
template <class Key>
__device__ __forceinline__ void sort_warp(Key (&v)[kKeys]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= kWarpKeys; k <<= 1) {
    if (k <= kKeys) {  // the mirror within the lane
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int l = i ^ (k - 1);
        if (l > i) order(v[i], v[l]);
      }
    } else {  // the mirror: lane ^ (k / kKeys - 1), key kKeys - 1 - i
      Key p[kKeys];
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        p[i] = __shfl_xor_sync(0xffffffffu, v[kKeys - 1 - i], k / kKeys - 1);
      const bool lower = (lane & (k / (2 * kKeys))) == 0;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) v[i] = lower == (v[i] < p[i]) ? v[i] : p[i];
    }
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) {
      if (j < kKeys) {
#pragma unroll
        for (int i = 0; i < kKeys; ++i)
          if ((i & j) == 0) order(v[i], v[i | j]);
      } else {
        const bool lower = (lane & (j / kKeys)) == 0;
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          const Key p = __shfl_xor_sync(0xffffffffu, v[i], j / kKeys);
          v[i] = lower == (v[i] < p) ? v[i] : p;
        }
      }
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
template <bool kShared, class Key>
__device__ __forceinline__ void merge_group(const Key* x, int a, int b, int w, int o,
                                            Key (&v)[kKeys]) {
  // the keys of a among the first o outputs: a lower bound on the merge path
  int lo = o > w ? o - w : 0, len = (o < w ? o : w) - lo;
  while (len > 0) {
    const int half = len >> 1, mid = lo + half;
    const bool less = x[slot_of<kShared>(a + mid)] < x[slot_of<kShared>(b + o - 1 - mid)];
    lo = less ? mid + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  int ia = lo, ib = o - lo;
  Key ka = x[slot_of<kShared>(a + (ia < w ? ia : w - 1))];
  Key kb = x[slot_of<kShared>(b + (ib < w ? ib : w - 1))];
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const bool from_a = ib >= w || (ia < w && ka < kb);
    v[r] = from_a ? ka : kb;
    ia += from_a;
    ib += !from_a;
    const Key next = x[slot_of<kShared>(from_a ? a + (ia < w ? ia : w - 1)
                                               : b + (ib < w ? ib : w - 1))];
    ka = from_a ? next : ka;
    kb = from_a ? kb : next;
  }
}

// The merge rounds of groups' runs of w keys and up, pairwise, from x into
// y and back (np2 keys each, at slot_of), and the barrier that ends them;
// nt threads take part, thread t the groups t, t + nt, ...  Returns the
// buffer the sorted keys end in.
template <bool kShared, class Key>
__device__ Key* merge_rounds(Key* x, Key* y, int w, int np2, int nt) {
  const int groups = np2 / kKeys;
  Key v[kKeys];
  for (; w < np2; w <<= 1) {
    sort_sync(nt);
    if (kShared && w == kWarpKeys && threadIdx.x == 0 && blockIdx.x < kPhaseDest)
      K11_STAMP(kStampSort + kSortStamps * blockIdx.x + 3);
    for (int g = threadIdx.x; g < groups; g += nt) {
      const int at = g * kKeys, pair = at & ~(2 * w - 1);
      merge_group<kShared>(x, pair, pair + w, w, at - pair, v);
#pragma unroll
      for (int r = 0; r < kKeys; ++r) y[slot_of<kShared>(at + r)] = v[r];
    }
    Key* t = x;
    x = y;
    y = t;
  }
  sort_sync(nt);
  return x;
}

// Sort the n keys of src ascending into one of the two working buffers x
// and y (np2 keys each, at slot_of; x may be src), and return it: each
// warp's 32 groups a run (lane by lane into x, a group a thread, the
// warp's network), then the merge rounds.  nt threads (a multiple of 32)
// take part, thread t the groups t, t + nt, ...
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
    const int g = g0 + lane;  // a segment of fewer groups pads the warp's run
#pragma unroll
    for (int r = 0; r < kKeys; ++r) v[r] = g < groups ? x[slot_of<kShared>(g * kKeys + r)] : kPad;
    sort_warp(v);
    if (g < groups) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r) x[slot_of<kShared>(g * kKeys + r)] = v[r];
    }
  }
  return merge_rounds<kShared>(x, y, kWarpKeys, np2, nt);
}

// Where a destination's sorted keys are: the buffer, in shared memory or
// not, of 32-bit keys or 64-bit, and the bits of a key that are its
// position.
struct Sorted {
  const void* x;
  u64 pmask;
  bool shared, narrow;
};

// The sort of a segment of at most kPackThreads groups (np2 <= kSmallKeys),
// a group a thread, in the two shared buffers sh and sh + kShSlots (u64
// slots): thread t loads group t's keys into registers (padded), and the
// block finds the least and the largest fsort of its n keys (one block
// barrier).  When every key fits 32 bits as ((fsort - least) << pb) |
// position (pb = log2 seg, every position below seg), with 0xFFFFFFFF above
// them all as the padding, the sort runs on those (each network stage and
// merge step on one word, not two); else on the 64-bit keys.
__device__ Sorted sort_small(u64* sh, const u64* k, int n, int np2, int nt, long long seg) {
  __shared__ uint32_t s_least[kPackThreads / 32], s_most[kPackThreads / 32];
  const int g = threadIdx.x, lane = threadIdx.x & 31;
  u64 v[kKeys];
  uint32_t least = 0xFFFFFFFFu, most = 0;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int i = g * kKeys + r;
    v[r] = i < n ? k[i] : kPad;
  }
  if (threadIdx.x == 0 && blockIdx.x < kPhaseDest)
    K11_STAMP(kStampSort + kSortStamps * blockIdx.x + 2);
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    if (g * kKeys + r < n) {
      const uint32_t f = (uint32_t)(v[r] >> 32);
      least = f < least ? f : least;
      most = f > most ? f : most;
    }
  }
  least = __reduce_min_sync(0xffffffffu, least);
  most = __reduce_max_sync(0xffffffffu, most);
  if (lane == 0) {
    s_least[threadIdx.x >> 5] = least;
    s_most[threadIdx.x >> 5] = most;
  }
  sort_sync(nt);
  for (int w = 0; w < nt / 32; ++w) {
    least = s_least[w] < least ? s_least[w] : least;
    most = s_most[w] > most ? s_most[w] : most;
  }
  const int pb = 63 - __clzll(seg);
  const int groups = np2 / kKeys;
  if ((((u64)(most - least)) << pb) + (u64)seg <= 0xFFFFFFFFull) {
    uint32_t* x = reinterpret_cast<uint32_t*>(sh);
    uint32_t* y = reinterpret_cast<uint32_t*>(sh + kShSlots);
    uint32_t u[kKeys];
#pragma unroll
    for (int r = 0; r < kKeys; ++r)
      u[r] = g * kKeys + r < n ? ((uint32_t)((v[r] >> 32) - least) << pb) |
                                     (uint32_t)(v[r] & (u64)(seg - 1))
                               : 0xFFFFFFFFu;
    sort_warp(u);
    if (g < groups) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r) x[slot_of<true>(g * kKeys + r)] = u[r];
    }
    return Sorted{merge_rounds<true>(x, y, kWarpKeys, np2, nt), (u64)(seg - 1), true, true};
  }
  sort_warp(v);
  if (g < groups) {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) sh[slot_of<true>(g * kKeys + r)] = v[r];
  }
  return Sorted{merge_rounds<true>(sh, sh + kShSlots, kWarpKeys, np2, nt), 0xffffffffull, true,
                false};
}

// Sort the n keys of k, kShKeys < n <= 2 kShKeys, in place, the halves in
// the two shared buffers (contiguous: key kShKeys + i of sh is key i of
// the second): half 0 sorts and waits in its own place in k while half 1
// sorts; half 0 comes back into the buffer half 1 did not end in, and the
// last round merges the two (half 0 the first run) from shared memory into
// k.
__device__ void sort_halves(u64* sh, u64* k, int n, int nt) {
  u64* sh1 = sh + kShSlots;
  const u64* h0 = sort_segment<true>(sh, sh1, k, kShKeys, kShKeys, nt);
  for (int i = threadIdx.x; i < kShKeys; i += nt) k[i] = h0[slot_of<true>(i)];
  sort_sync(nt);
  const u64* h1 = sort_segment<true>(sh, sh1, k + kShKeys, n - kShKeys, kShKeys, nt);
  const int a = h1 == sh ? kShKeys : 0;  // where half 0 comes back
  for (int i = threadIdx.x; i < kShKeys; i += nt) sh[slot_of<true>(a + i)] = k[i];
  sort_sync(nt);
  u64 v[kKeys];
  for (int g = threadIdx.x; g < 2 * kShKeys / kKeys; g += nt) {
    merge_group<true>(sh, a, kShKeys - a, kShKeys, g * kKeys, v);
#pragma unroll
    for (int r = 0; r < kKeys; ++r) k[g * kKeys + r] = v[r];
  }
  sort_sync(nt);
}

// Destination d's copy: its n sorted rows, the first allow to the wire
// (the receiver's pending row: on sig rows home, sig, fsort; on key rows
// the payload), the rest to the ring from its spill offset while it has
// room, the first of them taking the ring's min.  run(s, al, stage)
// copies from the sorted keys (s, Sorted) by every thread of the block,
// key rows through `stage` (kStageWords of shared memory).
template <bool kSig>
struct DestCopy {
  const int32_t* cand;
  const int32_t* carry;
  long long n_lanes;
  int n, width, ccar, ndev, d;
  int32_t* out;
  int32_t* wire;
  int32_t* carry_out;

  __device__ void run(const Sorted& s, const Allowance& al, int32_t* stage) const {
    if (!s.shared)
      go<false>(static_cast<const u64*>(s.x), s.pmask, al, stage);
    else if (s.narrow)
      go<true>(static_cast<const uint32_t*>(s.x), s.pmask, al, stage);
    else
      go<true>(static_cast<const u64*>(s.x), s.pmask, al, stage);
  }

  template <bool kShared, class Key>
  __device__ void go(const Key* x, u64 pmask, const Allowance& al, int32_t* stage) const {
    if constexpr (kSig)
      rows<kShared>(x, pmask, al);
    else
      words<kShared>(x, pmask, al, stage);
  }

  // sig rows: a row a thread (an int4), kKeys rows loaded before any is
  // stored
  template <bool kShared, class Key>
  __device__ void rows(const Key* x, u64 pmask, const Allowance& al) const {
    const int nthr = blockDim.x;
    for (int i0 = threadIdx.x; i0 < n; i0 += nthr * kKeys) {
      int4 v[kKeys];
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const int i = i0 + r * nthr;
        if (i < n)
          v[r] = row_at(reinterpret_cast<const int4*>(cand),
                        reinterpret_cast<const int4*>(carry), n_lanes,
                        (long long)(x[slot_of<kShared>(i)] & pmask));
      }
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const int i = i0 + r * nthr;
        if (i >= n) continue;
        if (i < al.allow) {
          int32_t* w = wire + 3 * (al.base + i);
          w[0] = v[r].z;
          w[1] = v[r].w;
          w[2] = v[r].y;
          continue;
        }
        const long long slot = al.spill_before + (i - al.allow);
        if (slot < ccar) {
          reinterpret_cast<int4*>(carry_out)[slot] = make_int4(d, v[r].y, v[r].z, v[r].w);
          if (i == al.allow) atomicMin(&out[ndev + 2], v[r].y);
        }
      }
    }
  }

  // key rows: G lanes a row (G = 8 or 16, at least the row's words), the
  // wire rows sent (their payload, words 2 ..) and then the ring rows kept
  // (the whole row: its dest is d), each part gathered into `stage` (shared
  // memory the sort no longer needs) and stored from there 16 bytes a lane
  template <bool kShared, class Key>
  __device__ void words(const Key* x, u64 pmask, const Allowance& al, int32_t* stage) const {
    const int pw = width - 2;
    const int sent = n < al.allow ? n : al.allow;
    const long long room = ccar - al.spill_before;
    const int kept = room <= 0 ? 0 : (int)(n - sent < room ? n - sent : room);
    if (pw <= 8)
      part<kShared, 8>(x, pmask, 0, sent, 2, pw, wire + al.base * pw, stage);
    else
      part<kShared, 16>(x, pmask, 0, sent, 2, pw, wire + al.base * pw, stage);
    part<kShared, 16>(x, pmask, sent, kept, 0, width, carry_out + al.spill_before * width, stage);
    if (threadIdx.x == 0 && kept > 0)  // the first spilled row: the smallest of the spill
      atomicMin(&out[ndev + 2],
                row_ptr(cand, carry, n_lanes, width,
                        (long long)(x[slot_of<kShared>(sent)] & pmask))[1]);
  }

  // Words w0 .. w0 + span of sorted rows i0 .. i0 + rows into dst, span
  // words a row, kStageWords at most a chunk: G lanes a row gather it into
  // the stage at dst's alignment (a warp takes 32 rows a trip, lane l
  // finding row l's source, which the G lanes of the row take by a
  // shuffle; a trip's words loaded before any is stored), then every
  // thread stores it to dst, 16 bytes a lane between the unaligned words
  // at its ends.  Three trips' loads held at once (24 a lane) made the copy
  // slower, 4.7 us against 3.4 at kinase's step (PERF.md).
  template <bool kShared, int G, class Key>
  __device__ void part(const Key* x, u64 pmask, int i0, int rows, int w0, int span,
                       int32_t* dst, int32_t* stage) const {
    constexpr int kRowsAt = 32 / G;            // rows a warp's load covers
    constexpr int kLoads = 32 / kRowsAt;       // a trip's loads a lane
    const int lane = threadIdx.x & 31, sub = lane & (G - 1);
    const bool on = sub < span;
    const int stride = (blockDim.x >> 5) * 32, chunk = (kStageWords - 4) / span;
    for (int c0 = 0; c0 < rows; c0 += chunk) {
      const int m = rows - c0 < chunk ? rows - c0 : chunk;
      int32_t* out0 = dst + (long long)c0 * span;
      const int lead = (int)((reinterpret_cast<uintptr_t>(out0) >> 2) & 3);
      int32_t* st = stage + lead;  // word j of st and of out0 alike mod 16 bytes
      for (int rt = (threadIdx.x >> 5) * 32; rt < m; rt += stride) {  // the trip's first row
        const int32_t* src = nullptr;
        if (rt + lane < m)
          src = row_ptr(cand, carry, n_lanes, width,
                        (long long)(x[slot_of<kShared>(i0 + c0 + rt + lane)] & pmask)) + w0;
        int32_t v[kLoads];
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int at = q * kRowsAt + lane / G;  // the row this lane loads
          const int32_t* p = reinterpret_cast<const int32_t*>(
              __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(src), at));
#ifdef K11_COPY_NO_LOAD
          if (on && rt + at < m) v[q] = (int32_t)reinterpret_cast<uintptr_t>(p);
#else
          if (on && rt + at < m) v[q] = p[sub];
#endif
        }
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int at = q * kRowsAt + lane / G;
          if (on && rt + at < m) st[(rt + at) * span + sub] = v[q];
        }
      }
      __syncthreads();
      const int total = m * span, head = total < ((4 - lead) & 3) ? total : (4 - lead) & 3;
      const int body = (total - head) >> 2;
#ifdef K11_COPY_NO_STORE
      if (threadIdx.x == 0) asm volatile("" ::"r"(st[0]));
#else
      if ((int)threadIdx.x < head) out0[threadIdx.x] = st[threadIdx.x];
      const int4* s4 = reinterpret_cast<const int4*>(st + head);
      int4* d4 = reinterpret_cast<int4*>(out0 + head);
      for (int j = threadIdx.x; j < body; j += blockDim.x) d4[j] = s4[j];
      for (int t = head + 4 * body + threadIdx.x; t < total; t += blockDim.x) out0[t] = st[t];
#endif
      __syncthreads();  // the stage is free again
    }
  }
};

// The ring's tail, block ndev of route_pack: the counts and migrants into
// out, the carry overflow, and the empty row over [len_new, len_old) of
// the ring written, whose word this block alone reads (before its
// barrier) and then sets to len_new.
template <bool kSig>
__device__ void ring_tail(const int32_t* counts, const int32_t* S, int ccar, int ndev, int me,
                          int cap, int width, int nkey, int fempty, int32_t* out,
                          int32_t* carry_out, int32_t* ring_len) {
  __shared__ long long s_spilled, s_old;
  if (threadIdx.x < 32) {
    const Allowance a = allowance(counts, S, ndev, me, cap, -1);
    if (threadIdx.x == 0) {
      s_spilled = a.spilled;
      s_old = live_of(ring_len, ccar);
    }
  }
  for (int q = threadIdx.x; q <= ndev; q += blockDim.x) out[q] = counts[q];
  __syncthreads();
  if (threadIdx.x == 0) K11_STAMP(kStampTail + 1);
  const long long spilled = s_spilled, old = s_old;
  const long long live = spilled < ccar ? spilled : ccar;
  if (threadIdx.x == 0) {
    out[ndev + 1] = (int32_t)(spilled > ccar ? spilled - ccar : 0);
    *ring_len = (int32_t)live;
  }
  if constexpr (kSig) {
    for (long long s = live + threadIdx.x; s < old; s += blockDim.x)
      reinterpret_cast<int4*>(carry_out)[s] = make_int4(ndev, kInfp, 0, -1);
  } else {
    for (long long k = live * width + threadIdx.x; k < old * width; k += blockDim.x) {
      const int w = (int)(k % width);
      carry_out[k] = w == 0 ? ndev : (w == 1 ? fempty : (w < 2 + nkey ? -1 : 0));
    }
  }
}

template <bool kSig>
__global__ void __launch_bounds__(kPackThreads) route_pack_kernel(
    const int32_t* __restrict__ cand, const int32_t* __restrict__ carry, const long long* nsel,
    int M, int ccar, int ndev, int me, int cap, const int32_t* __restrict__ S, long long seg,
    int width, int nkey, int fempty, const int32_t* __restrict__ counts,
    int32_t* __restrict__ out, u64* __restrict__ keys, int32_t* __restrict__ wire,
    int32_t* __restrict__ carry_out, int32_t* __restrict__ ring_len,
    const int32_t* __restrict__ run) {
  extern __shared__ __align__(16) u64 sh[];
  __shared__ Allowance s_allow;  // the block's, from warp aw
  if (run != nullptr && *run == 0) return;
  const int d = blockIdx.x;
#ifdef K11_PHASES
  if (threadIdx.x == 0) {
    K11_STAMP_MIN(4);
    if (d < kPhaseDest) K11_STAMP(kStampSort + kSortStamps * d);
    if (d == ndev) K11_STAMP(kStampTail);
  }
#endif
  if (d == ndev) {
    ring_tail<kSig>(counts, S, ccar, ndev, me, cap, width, nkey, fempty, out, carry_out,
                    ring_len);
#ifdef K11_PHASES
    __syncthreads();
    if (threadIdx.x == 0) {
      K11_STAMP(kStampTail + 2);
      K11_STAMP_MAX(5);
    }
#endif
    return;
  }
  const int n = counts[d];
  const long long n_lanes = *nsel * M;
#ifdef K11_BARRIERS
  if (threadIdx.x == 0) g_barriers[d] = 0;
#endif
  if (n == 0) {
    if (threadIdx.x == 0) K11_STAMP_MAX(5);
    return;
  }
  int np2 = kKeys;
  while (np2 < n) np2 <<= 1;
  const int nt = np2 <= kWarpKeys ? 32 : (np2 / kKeys < kPackThreads ? np2 / kKeys : kPackThreads);
  // the allowance by a warp that does not sort, while the others do (warp 0
  // first when every warp sorts)
  const int aw = nt < (int)blockDim.x ? (int)(blockDim.x >> 5) - 1 : 0;
  if ((int)(threadIdx.x >> 5) == aw) {
    const Allowance a = allowance(counts, S, ndev, me, cap, d);
    if ((threadIdx.x & 31) == 0) {
      s_allow = a;
      if (d < kPhaseDest) K11_STAMP(kStampSort + kSortStamps * d + 1);
    }
  }
  // the nt threads sort; then every thread of the block copies
  __shared__ Sorted s_sorted;
  if ((int)threadIdx.x < nt) {
    u64* k = keys + (long long)d * seg;
    Sorted s{k, 0xffffffffull, np2 <= kShKeys, false};
    if (np2 <= kSmallKeys)
      s = sort_small(sh, k, n, np2, nt, seg);
    else if (np2 <= kShKeys)
      s.x = sort_segment<true>(sh, sh + kShSlots, k, n, np2, nt);
    else if (np2 == 2 * kShKeys)
      sort_halves(sh, k, n, nt);
    else
      s.x = sort_segment<false>(k, keys + (long long)(ndev + d) * seg, k, n, np2, nt);
    if (threadIdx.x == 0) {
      s_sorted = s;
      if (d < kPhaseDest) K11_STAMP(kStampSort + kSortStamps * d + 4);
    }
  }
  __syncthreads();
  const DestCopy<kSig> copy{cand, carry, n_lanes, n, width, ccar, ndev, d, out, wire, carry_out};
  // the stage: the shared buffer the sorted keys are not in
  const Sorted s = s_sorted;
  copy.run(s, s_allow,
           reinterpret_cast<int32_t*>(s.shared && s.x == sh ? sh + kShSlots : sh));
#ifdef K11_PHASES
  __syncthreads();
  if (threadIdx.x == 0) {
    if (d < kPhaseDest) K11_STAMP(kStampSort + kSortStamps * d + 5);
    K11_STAMP_MAX(5);
  }
#endif
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
int count(const void* cand, const void* carry, const void* carry_len, const void* nsel, int M,
          int lanes_cap, int ccar, int ndev, long long seg, int width, int fempty, void* counts,
          void* counts_next, void* out, void* keys, const void* run, void* stream) {
  if (cand == nullptr || carry == nullptr || carry_len == nullptr || nsel == nullptr ||
      counts == nullptr || counts_next == nullptr || counts == counts_next || out == nullptr ||
      keys == nullptr || M < 1 || lanes_cap < 0 || ccar < 1 || ndev < 1 || ndev > kMaxDest ||
      seg < (long long)lanes_cap + ccar || seg >= (1ll << 31) || (seg & (seg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  route_count_kernel<kSig><<<grid_of((long long)lanes_cap + ccar, kThreads), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)cand, (const int32_t*)carry, (const int32_t*)carry_len,
      (const long long*)nsel, M, ccar, ndev, seg, width, fempty, (int32_t*)counts,
      (int32_t*)counts_next, (int32_t*)out, (u64*)keys, (const int32_t*)run);
  return (int)cudaGetLastError();
}

template <bool kSig>
int pack(const void* cand, const void* carry, const void* nsel, int M, int ccar, int ndev, int me,
         int cap, const void* S, long long seg, int width, int nkey, int fempty,
         const void* counts, void* out, void* keys, void* wire, void* carry_out, void* ring_len,
         const void* run, void* stream) {
  if (cand == nullptr || carry == nullptr || nsel == nullptr || counts == nullptr ||
      out == nullptr || keys == nullptr || wire == nullptr || carry_out == nullptr ||
      carry_out == carry || ring_len == nullptr || M < 1 || ccar < 1 || ndev < 1 ||
      ndev > kMaxDest || me < 0 || me >= ndev || cap < 1 || seg < 1 || seg >= (1ll << 31) ||
      (seg & (seg - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int shared = 2 * kShSlots * (int)sizeof(u64);
  const int e = allow_shared<kSig>(shared);
  if (e != 0) return e;
  route_pack_kernel<kSig><<<ndev + 1, kPackThreads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)cand, (const int32_t*)carry, (const long long*)nsel, M, ccar, ndev, me, cap,
      (const int32_t*)S, seg, width, nkey, fempty, (const int32_t*)counts, (int32_t*)out,
      (u64*)keys, (int32_t*)wire, (int32_t*)carry_out, (int32_t*)ring_len,
      (const int32_t*)run);
  return (int)cudaGetLastError();
}

}  // namespace

// cand: (lanes_cap, 4) int32; carry: (ccar, 4) int32; carry_len: its live
// length, int32 on the card (every row from it on is the empty row; ccar
// for a ring of unknown contents); nsel: the step's selected rows
// (step_state.cuh kNSel, int64), lanes = nsel x M <= lanes_cap; counts:
// (ndev + 1,) int32, this step's counts and migrants, zero before the call;
// counts_next: the other step's, which the call zeroes; out: (ndev + 3,)
// int32 (counts, migrants, carry_ovf, ring min; route_count sets the ring
// min to INFP, route_pack the rest); keys: (2, ndev, seg) uint64 scratch,
// seg a power of two >= lanes_cap + ccar (pass 1 fills the first half; a
// segment of more than 2 kShKeys keys sorts between its two halves).  run:
// the step loop's int32 flag, or null; both passes return at once when it
// reads 0.
extern "C" int route_count(const void* cand, const void* carry, const void* carry_len,
                           const void* nsel, int M, int lanes_cap, int ccar, int ndev,
                           long long seg, void* counts, void* counts_next, void* out, void* keys,
                           const void* run, void* stream) {
  return count<true>(cand, carry, carry_len, nsel, M, lanes_cap, ccar, ndev, seg, 4, kInfp,
                     counts, counts_next, out, keys, run, stream);
}

// After route_count on the same buffers.  S: (ndev, ndev) int32 send
// counts of every shard (ragged), or null (dense: allowance cap); wire:
// (>= ndev cap, 3) int32 (dense) or (>= lanes_cap + ccar, 3) (ragged);
// carry_out: (ccar, 4) int32, not the carry read; ring_len: its word (the
// live length its last write left, or ccar), which the call updates.  ndev
// sorting blocks, then the ring's tail's block.
extern "C" int route_pack(const void* cand, const void* carry, const void* nsel, int M,
                          int ccar, int ndev, int me, int cap, const void* S, long long seg,
                          const void* counts, void* out, void* keys, void* wire, void* carry_out,
                          void* ring_len, const void* run, void* stream) {
  return pack<true>(cand, carry, nsel, M, ccar, ndev, me, cap, S, seg, 4, 0, kInfp, counts, out,
                    keys, wire, carry_out, ring_len, run, stream);
}

// The passes on key rows: route_count's and route_pack's arguments, with
// cand (lanes_cap, width) and carry / carry_out (ccar, width) int32 rows,
// width = 2 + the pending entry's words (3 .. kMaxRow), nkey the key words
// of the empty row and fempty its fsort (out[ndev + 2] of an empty ring);
// wire rows have width - 2 words.
extern "C" int route_count_rows(const void* cand, const void* carry, const void* carry_len,
                                const void* nsel, int M, int lanes_cap, int ccar, int ndev,
                                long long seg, int width, int nkey, int fempty, void* counts,
                                void* counts_next, void* out, void* keys, const void* run,
                                void* stream) {
  if (width < 3 || width > kMaxRow || nkey < 0 || nkey > width - 2)
    return (int)cudaErrorInvalidValue;
  return count<false>(cand, carry, carry_len, nsel, M, lanes_cap, ccar, ndev, seg, width, fempty,
                      counts, counts_next, out, keys, run, stream);
}

extern "C" int route_pack_rows(const void* cand, const void* carry, const void* nsel, int M,
                               int ccar, int ndev, int me, int cap, const void* S, long long seg,
                               int width, int nkey, int fempty, const void* counts, void* out,
                               void* keys, void* wire, void* carry_out, void* ring_len,
                               const void* run, void* stream) {
  if (width < 3 || width > kMaxRow || nkey < 0 || nkey > width - 2)
    return (int)cudaErrorInvalidValue;
  return pack<false>(cand, carry, nsel, M, ccar, ndev, me, cap, S, seg, width, nkey, fempty,
                     counts, out, keys, wire, carry_out, ring_len, run, stream);
}

#ifdef K11_BARRIERS
// The block barriers of each destination's sort in the last route_pack
// (ndev ints into host memory; waits for the card).
extern "C" int route_pack_barriers(int* host, int ndev) {
  if (host == nullptr || ndev < 1 || ndev > kMaxDest) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_barriers, sizeof(int) * ndev);
}
#endif

#ifdef K11_PHASES
// The %globaltimer readings of the calls since the last read (kStamps
// uint64 into host memory; 0 where no block wrote one; waits for the card),
// then reset: the first pack block's start to the largest value, the rest
// to 0.
extern "C" int route_pack_phases(unsigned long long* host, int n) {
  if (host == nullptr || n != kStamps) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(u64) * kStamps);
  if (e != cudaSuccess) return (int)e;
  u64 fresh[kStamps] = {};
  fresh[4] = ~0ull;
  return (int)cudaMemcpyToSymbol(g_stamps, fresh, sizeof(fresh));
}
#endif
