// The claim-protocol insert of a key-row table (the packed and the unpacked
// layouts), and the step's counters: kernel K10.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :964
// _probe_body_packed_factory, :1262 _insert_core_packed and :1489
// _insert_packed (packed), :659 _probe_body_factory, :696 _insert_core and
// :799 _insert (unpacked), less their width ladders and compaction (XLA
// inside the run loops :1819 and :1999).  The port's plain versions are
// search/engine.py::_probe_claim, _insert_core_packed and _insert_core.
// Its lanes are the pending list that keyrow_expand.cu (K9) leaves, with
// their key words, hash h0 and claim tag: on the unpacked layout every
// candidate that survived the prune, on the packed one those that did not
// match in their home row (K9 settles the matches, round 0's first case,
// itself).  Its length is state[kNPend]; state[kNValid] counts every
// surviving lane, which the counters count as lanes.  Round r = 0, 1, ...
// of every unsettled lane:
//   - reads the key row at probe_slot(h0, r) AS IT STOOD BEFORE ANY WRITE
//     OF ROUND r: a row that holds the key settles the lane (match); at an
//     empty row the lane claims the slot (atomicMin of its tag into claim);
//   - (barrier) the lane whose tag is the slot's claim word writes its
//     key row there (packed: and h) and settles (won);
//   - (barrier) every other claimer re-reads the row and settles if the
//     winner wrote its key (match2);
// for at most max_probes = 128 rounds, while a lane is unsettled.  Claim
// words start at INFP and a claimed slot is written in the round that
// claims it, so it is never claimed again: atomicMin over the old word
// gives the plain step's scatter-min of this round's tags.  Because the
// tags are content tags (K9), the winner, and so the table, is the plain
// step's whatever order the lanes run in, and whichever block runs them.
// A lane settles once; then
//   packed:   atomicMin of its packed word into t_best at once (nothing
//             reads t_best during the insert);
//   unpacked: it reads g_before = t_g[slot] and state_before = t_state[slot]
//             at once (no g or state is written until every lane has
//             settled or given up: the plain step reads them all before
//             any write), and improves when g < g_before.  After the rounds
//             (a barrier) each improving lane atomicMins g into t_g, sets
//             t_fpar = INT64_MAX and t_state = 1, and counts a reopen when
//             state_before was 2; (a barrier) each lane whose g is the new
//             t_g atomicMins f * 2^n + m into t_fpar (the plain step's
//             scatter-min among the winners).
// Key rows, claim words, t_g and lane states that another block may have
// written are read through L2 (__ldcg), never a stale L1.
//
// What bounds it on an H100: on a short list, the chain of dependent
// rounds in one block, not bytes: a lane is W + 4 or W + 5 words and each
// round reads one key row (16-24 B) and one claim word per live lane, but
// each round is two dependent round trips to L2 (the winners' claim words,
// then the losers' re-read with the next round's read) and three block
// barriers.  On a long list, the grid syncs of round 0 (1.1 us each on the
// H100, chip_smoke.py) and its lanes' scattered loads.
//
// Design: one cooperative launch a step (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative, which a CUDA graph captures) of fixed
// shape; every block reads the list's length n (state[kNPend]) and all
// take the same path, so the card chooses it and the host reads nothing:
//   - n <= cap (the whole-list block path; cap <= kCap = kThreads x
//     kLanes): the other blocks return at once and block 0 runs every
//     round, round 0 included, a thread holding the lanes tid + k kThreads
//     (k < kLanes: list place, slot and flag) in registers.  A phase first
//     issues every held lane's loads, then decides: round 0's reads of the
//     home rows (with their claims), __syncthreads, the winners' claim
//     words and rows, __syncthreads, the losers' re-reads with the next
//     round's reads (and claims), then the round's unsettled count as a
//     block sum, whose barriers end the round.  On the unpacked layout the
//     decrease-key follows in the block too (a list of n lanes has at most
//     n improving ones): the g min, the (f, parent) reset and state, a
//     barrier, the (f, parent) min.  No grid sync.
//   - n > cap or cap = 0: round 0 on the grid: every block strides over
//     the lanes, a lane's state in two device arrays (lane_slot: its slot
//     once settled, else kOpen; lane_flag: claiming this round, and on the
//     unpacked layout improve and reopen) touched only by the thread that
//     owns the lane; a grid sync after its reads and after its writes.  In
//     round 0's re-read phase, which also makes round 1's reads, each lane
//     still unsettled appends its index to the tail list (one atomicAdd a
//     warp into state[kCnt], which so counts round 0's unsettled lanes as
//     before).  After a third grid sync every block reads that count t:
//     t <= cap (the tail's block path), block 0 alone runs rounds 1, 2,
//     ... over the tail as the whole-list path runs its rounds, the lanes'
//     states loaded from the arrays and stored back for the decrease-key
//     (unpacked), which stays on the grid after one more grid sync: its
//     improving lanes are spread over the grid and many (kinase unpacked:
//     median 10,224 a step); the other blocks return (packed).  t > cap
//     or cap = 0 (the grid path): every round on the grid as round 0, two
//     grid syncs a round; the re-read of round r and the read of round r +
//     1 are one phase, which also sums round r's unsettled count (one
//     atomic a block into state[kCnt + r], read by every thread after the
//     sync, so all leave the loop together).
// One cap serves both block paths (search/step.py::K10_CAP, found on the
// card by chip_smoke.py --k10-sweep).  Every phase issues a lane's loads
// together: a probe position's key words with (unpacked) its g and state;
// the claim word with them; the re-read of round r's position with round
// r + 1's.  So a phase is one round trip to memory a lane, not one a word.
// Grid syncs a step (search/step.py::k10_grid_syncs): none on the
// whole-list path; packed 1 + 2 x rounds on the grid path, 3 with the
// tail's block path; unpacked one more, and two more with the tail's.  No
// lane reads round max_probes.  Last, one thread writes this step's
// counters (step::finish_step): lanes_probe is (rounds - 1) x lanes,
// lanes_unmatched the lanes unsettled after round 1, lanes_tail after
// round 2 (0 when fewer ran), as the plain step counts them; reopens come
// from K3 (packed) or from here (unpacked).  K10 is launched over a
// programmatic edge from the kernel before it (K9) and waits for it first
// thing (step::wait_predecessor).
//
// The sharded step (parallel/sharded.py, C entry keyrow_insert_recv; JAX
// _insert_packed / _insert over [received; self-owned], :675-683 and
// :841-850) runs the same kernel over a pending list whose first n_front
// entries are the rows this shard received (K11's wire rows are pending
// entries), followed by K9's self-owned pending lanes (keyrow_expand.cu's
// sharded instantiation).  A received row claims with its place i <
// n_front in the list, which the sender could not know; every other lane
// with the tag it carries, tag_base + i M + m - 1 >= n_front.  So every
// tag is unique and none depends on the order in which lanes arrive, as
// the plain step's (parallel/sharded.py::insert_pending_plain).  The
// round-0 launch condition counts the pending list too: a shard may
// receive rows and keep no lane of its own.
//
// grid_sync_chain (a measurement probe, not part of the engine) times the
// grid sync itself: an otherwise empty cooperative kernel of the same
// shape that makes k of them.
//
// -DK10_PHASES (a measurement build, not the engine's) leaves eight
// %globaltimer readings of block 0's thread 0 in the tail list, read as
// int64 (0 where the launch did not pass the point): the start, after
// wait_predecessor, after each of round 0's three grid syncs, at the start
// of the block path, after the claim rounds and at the end.

#include <cooperative_groups.h>

#include "step_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 2;  // lanes a thread holds on the block path
constexpr int kCap = kThreads * kLanes;
constexpr int kMaxW = 8;   // key words of N <= 16
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClaim = 1;    // lane_flag: claimed its slot this round
constexpr int kImprove = 2;  // lane_flag (unpacked): settled with g < g_before
constexpr int kReopen = 4;   // lane_flag (unpacked): ... at a closed slot
constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFll;

#ifdef K10_PHASES
constexpr int kMarks = 8;
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K10_MARK(k)                                  \
  do {                                               \
    if (blockIdx.x == 0 && threadIdx.x == 0) mark[k] = globaltimer(); \
  } while (0)
#else
#define K10_MARK(k) \
  do {              \
  } while (0)
#endif

struct Table {
  int32_t* t_key;
  int KWs, W;
  uint32_t Cmask;
  int32_t* claim;
  int32_t* t_best;     // packed
  int32_t* t_g;        // unpacked
  long long* t_fpar;   // unpacked
  int32_t* t_state;    // unpacked
  long long n_front;   // received rows at the front of the list (sharded)
};

// A lane's state (lane_slot, or a register of the block path): its slot
// once settled; kOpen while it probes; kNone for a register that holds no
// lane.
constexpr int32_t kOpen = -1;
constexpr int32_t kNone = -2;

// The claim tag of lane i (`e`: its pending entry): a received row's place
// in the list, else the tag it carries.
__device__ __forceinline__ int32_t tag_of(const Table& t, long long i, const int32_t* e) {
  return i < t.n_front ? (int32_t)i : e[t.W + 1];
}

// A probe position as a phase reads it: its key words and, on the
// unpacked layout, the g and state a lane settling there compares with
// (neither changes while lanes probe).  All its loads are issued together,
// through L2: one round trip, not one a word; kVec = 4 (packed rows of
// KWs = 4 or 8 words, 16-byte aligned: W = 3 or 7) in int4 loads, one L2
// request a row, so that one block's phase asks L2 for fewer sectors.
// key[w] past W is not read.  (The unpacked instantiation with int4 rows
// spilled registers, and is not built.)
struct Slot {
  uint32_t at;
  int32_t key[kMaxW];
  int32_t g, state;
};

template <bool kUnpacked, int kVec>
__device__ __forceinline__ Slot read_slot(const Table& t, uint32_t at) {
  Slot s;
  s.at = at;
  const int32_t* row = t.t_key + (size_t)at * t.KWs;
  if constexpr (kVec == 4) {
#pragma unroll
    for (int q = 0; q < kMaxW / 4; ++q) {
      if (4 * q >= t.W) break;
      const int4 v = __ldcg(reinterpret_cast<const int4*>(row) + q);
      s.key[4 * q] = v.x, s.key[4 * q + 1] = v.y, s.key[4 * q + 2] = v.z, s.key[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) s.key[w] = w < t.W ? __ldcg(row + w) : 0;
  }
  s.g = kUnpacked ? __ldcg(t.t_g + at) : 0;
  s.state = kUnpacked ? __ldcg(t.t_state + at) : 0;
  return s;
}

// The write phase's read of a claimed position: its claim word `c`, with
// the g and state the lane settles with if its tag won.
template <bool kUnpacked>
__device__ __forceinline__ Slot read_claim(const Table& t, uint32_t at, int32_t& c) {
  Slot s;
  s.at = at;
  c = __ldcg(&t.claim[at]);
  s.g = kUnpacked ? __ldcg(t.t_g + at) : 0;
  s.state = kUnpacked ? __ldcg(t.t_state + at) : 0;
  return s;
}

// Does the slot hold the lane's key (`e`: its pending entry)?
__device__ __forceinline__ bool holds(const Table& t, const Slot& s, const int32_t* e) {
  bool eq = true;
#pragma unroll
  for (int w = 0; w < kMaxW; ++w)
    if (w < t.W) eq &= s.key[w] == e[w];
  return eq;
}

// A lane settles at slot `s`: its state (`slot`, `flag`) records where and,
// unpacked, whether it improves there.
template <bool kUnpacked>
__device__ __forceinline__ void settle(const Table& t, const Slot& s, const int32_t* e,
                                       int32_t& slot, int32_t& flag) {
  slot = (int32_t)s.at;
  int f = 0;
  if constexpr (kUnpacked) {
    if (e[t.W + 2] < s.g) f = kImprove | (s.state == 2 ? kReopen : 0);
  } else {
    atomicMin(&t.t_best[s.at], e[t.W + 3]);
  }
  flag = f;
}

// An open lane's read of its next probe position `s`: it settles where
// the row holds its key (match), claims an empty row (flag kClaim), or
// stays open.
template <bool kUnpacked>
__device__ __forceinline__ void decide(const Table& t, long long i, const Slot& s,
                                       const int32_t* e, int32_t& slot, int32_t& flag) {
  int f = 0;
  if (s.key[0] != -1) {
    if (holds(t, s, e)) {
      settle<kUnpacked>(t, s, e, slot, flag);
      return;
    }
  } else {
    atomicMin(&t.claim[s.at], tag_of(t, i, e));
    f = kClaim;
  }
  flag = f;
  slot = kOpen;
}

// The winner of a claimed slot (`s`, read by read_claim) writes its key row
// there (packed: and h; kVec = 4: in int4 stores, a row being KWs words,
// the key words and then h) and settles.
template <bool kUnpacked, int kVec>
__device__ __forceinline__ void write_row(const Table& t, const Slot& s, const int32_t* e,
                                          int32_t& slot, int32_t& flag) {
  int32_t* row = t.t_key + (size_t)s.at * t.KWs;
  if constexpr (kVec == 4) {
    auto word = [&](int w) { return w < t.W ? e[w] : e[t.W + 2]; };  // past W: h
    for (int w = 0; w < t.KWs; w += 4)
      *reinterpret_cast<int4*>(row + w) = make_int4(word(w), word(w + 1), word(w + 2),
                                                    word(w + 3));
  } else {
    for (int w = 0; w < t.W; ++w) row[w] = e[w];
    if constexpr (!kUnpacked) row[t.W] = e[t.W + 2];  // h
  }
  settle<kUnpacked>(t, s, e, slot, flag);
}

// Round r's re-read of a lane left open by the write phase (`claimed`: it
// claimed this round and lost), merged with round r + 1's read: both
// positions are read together; it settles where the winner wrote its key
// (match2), else it is open and decides at r + 1 (no lane reads round
// max_probes).  Returns whether it is open after round r.
template <bool kUnpacked, int kVec>
__device__ __forceinline__ bool reread(const Table& t, long long i, int r, bool claimed,
                                       const int32_t* e, int max_probes, int32_t& slot,
                                       int32_t& flag) {
  const uint32_t h0 = (uint32_t)e[t.W];
  const bool next = r + 1 < max_probes;
  Slot a, b;
  if (claimed) a = read_slot<kUnpacked, kVec>(t, step::probe_slot(h0, r, t.Cmask));
  if (next) b = read_slot<kUnpacked, kVec>(t, step::probe_slot(h0, r + 1, t.Cmask));
  if (claimed && holds(t, a, e)) {
    settle<kUnpacked>(t, a, e, slot, flag);
    return false;
  }
  if (next) decide<kUnpacked>(t, i, b, e, slot, flag);
  return true;
}

// The claim rounds in block 0 alone, over kLanes lanes a thread held in
// registers (`idx`: list places; `slot`, `flag`: their states; kNone where
// a register holds no lane): kWhole, every round from round 0 over the
// whole list; else rounds 1, 2, ... of the tail (round 1's reads made on
// the grid).  A phase first issues every held lane's loads, then decides,
// so a phase is one round trip to memory a thread, not one a lane; a
// __syncthreads after each phase (CTA-scope ordering: every write and
// claim of a phase is seen by the next phase's reads in this block, and no
// other block touches the table meanwhile).  Writes state[kCnt + r];
// returns the rounds run in all (round 0 included) and sets `undone` to
// the lanes left.
template <bool kUnpacked, int kVec, bool kWhole>
__device__ __forceinline__ int block_rounds(const Table& t, const int32_t* __restrict__ pend,
                                            int PW, int max_probes, long long* __restrict__ state,
                                            const int32_t (&idx)[kLanes],
                                            int32_t (&slot)[kLanes], int32_t (&flag)[kLanes],
                                            long long& undone) {
  const int tid = threadIdx.x;
  const int32_t* e[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) e[k] = pend + (size_t)idx[k] * PW;
  int r = 1;
  if constexpr (kWhole) {
    // round 0's reads: every lane's home row requested before any is used
    Slot s[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (slot[k] == kOpen)
        s[k] = read_slot<kUnpacked, kVec>(t, step::probe_slot((uint32_t)e[k][t.W], 0,
                                                              t.Cmask));
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (slot[k] == kOpen) decide<kUnpacked>(t, idx[k], s[k], e[k], slot[k], flag[k]);
    __syncthreads();  // every claim of round 0 before its writes
    r = 0;
  }
  for (;; ++r) {
    // the smallest tag at each claimed slot writes its row
    Slot w[kLanes];
    int32_t c[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (slot[k] == kOpen && flag[k] == kClaim)
        w[k] = read_claim<kUnpacked>(t, step::probe_slot((uint32_t)e[k][t.W], r, t.Cmask),
                                     c[k]);
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (slot[k] == kOpen && flag[k] == kClaim && c[k] == tag_of(t, idx[k], e[k]))
        write_row<kUnpacked, kVec>(t, w[k], e[k], slot[k], flag[k]);
    __syncthreads();  // every write of round r before its re-reads
    // the losers re-read (match2) and every open lane reads round r + 1
    const bool next = r + 1 < max_probes;
    Slot a[kLanes], b[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (slot[k] != kOpen) continue;
      const uint32_t h0 = (uint32_t)e[k][t.W];
      if (flag[k] == kClaim)
        a[k] = read_slot<kUnpacked, kVec>(t, step::probe_slot(h0, r, t.Cmask));
      if (next) b[k] = read_slot<kUnpacked, kVec>(t, step::probe_slot(h0, r + 1, t.Cmask));
    }
    bool open[kLanes];  // unsettled after round r (it may match in r + 1's read)
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      open[k] = false;
      if (slot[k] != kOpen) continue;
      if (flag[k] == kClaim && holds(t, a[k], e[k])) {
        settle<kUnpacked>(t, a[k], e[k], slot[k], flag[k]);
        continue;
      }
      open[k] = true;
      if (next) decide<kUnpacked>(t, idx[k], b[k], e[k], slot[k], flag[k]);
    }
    // round r's unsettled lanes, a barrier-count a register: also the
    // barrier before round r + 1's writes
    long long left = 0;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) left += __syncthreads_count(open[k]);
    if (tid == 0 && left != 0) state[step::kCnt + r] = left;
    undone = left;
    if (left == 0 || r + 1 >= max_probes) return r + 1;
  }
}

// The decrease-key of the whole-list block path (unpacked), in block 0
// from the lanes' registers: each improving lane atomicMins its g into
// t_g, resets t_fpar and opens the slot (a reopen where it was closed);
// after a barrier each lane whose g is the new t_g atomicMins f * 2^n + m
// into t_fpar.
__device__ __forceinline__ void block_decrease_key(const Table& t,
                                                   const int32_t* __restrict__ pend, int PW,
                                                   const int32_t (&idx)[kLanes],
                                                   const int32_t (&slot)[kLanes],
                                                   const int32_t (&flag)[kLanes],
                                                   long long* __restrict__ state, long long* red) {
  long long re = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (slot[k] < 0 || !(flag[k] & kImprove)) continue;
    atomicMin(&t.t_g[slot[k]], pend[(size_t)idx[k] * PW + t.W + 2]);
    t.t_fpar[slot[k]] = kI64Max;
    t.t_state[slot[k]] = 1;
    re += (flag[k] & kReopen) != 0;
  }
  re = step::block_sum(re, red);  // also the barrier before the (f, parent) min
  if (threadIdx.x == 0 && re != 0)
    atomicAdd((unsigned long long*)&state[step::kReopen], (unsigned long long)re);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (slot[k] < 0 || !(flag[k] & kImprove)) continue;
    const int32_t* e = pend + (size_t)idx[k] * PW;
    if (__ldcg(&t.t_g[slot[k]]) != e[t.W + 2]) continue;
    const long long fpar =
        (long long)(((unsigned long long)(uint32_t)e[t.W + 4] << 32) | (uint32_t)e[t.W + 3]);
    atomicMin(&t.t_fpar[slot[k]], fpar);
  }
}

template <bool kUnpacked, int kVec>
__global__ void __launch_bounds__(kThreads, 1) keyrow_insert_kernel(
    Table t, const int32_t* __restrict__ pend, int PW, int32_t* __restrict__ lane_slot,
    int32_t* __restrict__ lane_flag, int max_probes, int fill, int32_t* __restrict__ run,
    long long* __restrict__ counters, long long* __restrict__ state,
    int32_t* __restrict__ tail, int cap, const int32_t* __restrict__ recv) {
  __shared__ long long red[32];
#ifdef K10_PHASES
  long long mark[kMarks] = {};
#endif
  K10_MARK(0);
  step::wait_predecessor();  // the programmatic edge from K9
  K10_MARK(1);
  // one thread rewrites the flag at the end; on the grid path every block
  // has read it by the first grid sync, and a block that reads the new
  // flag has nothing to do
  if (*run == 0) return;
  // the sharded step: the rows received end where pend starts, and claim
  // with their places
  if (recv != nullptr) {
    t.n_front = *recv;
    pend -= t.n_front * PW;
  }
  const long long lanes = state[step::kNValid];  // K9's survivors: the counters' lanes
  const long long n = state[step::kNPend];       // the pending list's length
  const int tid = threadIdx.x, lane = tid & 31;
  int rounds = 0;
  long long undone = 0;
  if ((lanes > 0 || n > 0) && cap > 0 && n <= cap) {
    // ---- the whole-list block path: block 0 alone, every round
    if (blockIdx.x != 0) return;
    K10_MARK(5);
    int32_t idx[kLanes], slot[kLanes], flag[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      idx[k] = tid + k * kThreads;
      slot[k] = idx[k] < n ? kOpen : kNone;
      flag[k] = 0;
    }
    rounds = block_rounds<kUnpacked, kVec, true>(t, pend, PW, max_probes, state, idx, slot,
                                                 flag, undone);
    K10_MARK(6);
    if constexpr (kUnpacked) block_decrease_key(t, pend, PW, idx, slot, flag, state, red);
  } else if (lanes > 0 || n > 0) {
    // ---- round 0 on the grid, over the list (empty if K9 settled all)
    const long long first = (long long)blockIdx.x * kThreads + tid;
    const long long stride = (long long)gridDim.x * kThreads;
    cg::grid_group grid = cg::this_grid();
    for (long long i = first; i < n; i += stride) {
      const int32_t* e = pend + i * PW;
      const uint32_t at = step::probe_slot((uint32_t)e[t.W], 0, t.Cmask);
      decide<kUnpacked>(t, i, read_slot<kUnpacked, kVec>(t, at), e, lane_slot[i],
                        lane_flag[i]);
    }
    grid.sync();
    K10_MARK(2);
    bool block_path = false;
    for (int r = 0;; ++r) {
      // the smallest tag at each claimed slot writes its row
      for (long long i = first; i < n; i += stride) {
        if (lane_flag[i] != kClaim) continue;
        const int32_t* e = pend + i * PW;
        int32_t c;
        const Slot s = read_claim<kUnpacked>(
            t, step::probe_slot((uint32_t)e[t.W], r, t.Cmask), c);
        if (c == tag_of(t, i, e))
          write_row<kUnpacked, kVec>(t, s, e, lane_slot[i], lane_flag[i]);
      }
      grid.sync();
      if (r == 0) K10_MARK(3);
      // the losers re-read (match2); the unsettled go on to round r + 1,
      // and after round 0 into the tail list.  A warp runs each pass
      // whole (lanes past n idle), so its ballot is the tail's append.
      long long left = 0;
      for (long long b = first - lane; b < n; b += stride) {
        const long long i = b + lane;
        bool open = false;
        if (i < n && lane_slot[i] < 0)
          open = reread<kUnpacked, kVec>(t, i, r, lane_flag[i] == kClaim, pend + i * PW,
                                         max_probes, lane_slot[i], lane_flag[i]);
        if (r == 0) {
          const unsigned ballot = __ballot_sync(kFull, open);
          long long base = 0;
          if (lane == 0 && ballot != 0)
            base = (long long)atomicAdd((unsigned long long*)&state[step::kCnt],
                                        (unsigned long long)__popc(ballot));
          base = __shfl_sync(kFull, base, 0);
          const long long at = base + __popc(ballot & ((1u << lane) - 1u));
          if (open && at < cap) tail[at] = (int32_t)i;
        } else {
          left += open;
        }
      }
      if (r > 0) {
        left = step::block_sum(left, red);
        if (tid == 0 && left != 0)
          atomicAdd((unsigned long long*)&state[step::kCnt + r], (unsigned long long)left);
      }
      grid.sync();
      if (r == 0) K10_MARK(4);
      rounds = r + 1;
      undone = *(volatile long long*)&state[step::kCnt + r];
      if (undone == 0 || rounds >= max_probes) break;
      if (r == 0 && undone <= cap) {
        block_path = true;
        break;
      }
    }
    if (block_path) {
      // ---- the tail in block 0: its lanes' states from the arrays, and
      // back (unpacked: the decrease-key on the grid reads them)
      K10_MARK(5);
      if (blockIdx.x == 0) {
        int32_t idx[kLanes], slot[kLanes], flag[kLanes];
#pragma unroll
        for (int k = 0; k < kLanes; ++k) {
          // a tail lane may have matched in round 1's reads already
          const long long at = tid + (long long)k * kThreads;
          idx[k] = at < undone ? __ldcg(tail + at) : 0;
          slot[k] = at < undone ? __ldcg(lane_slot + idx[k]) : kNone;
          flag[k] = at < undone ? __ldcg(lane_flag + idx[k]) : 0;
        }
        rounds = block_rounds<kUnpacked, kVec, false>(t, pend, PW, max_probes, state, idx, slot,
                                                      flag, undone);
        if constexpr (kUnpacked) {
#pragma unroll
          for (int k = 0; k < kLanes; ++k) {
            if (slot[k] == kNone) continue;
            lane_slot[idx[k]] = slot[k];
            lane_flag[idx[k]] = flag[k];
          }
        }
      }
      if constexpr (kUnpacked)
        grid.sync();  // the decrease-key reads every lane's state
      else if (blockIdx.x != 0)
        return;
    }
    K10_MARK(6);
    if constexpr (kUnpacked) {
      // decrease-key: the min g, then (f, parent) among the lanes that
      // brought it; a tail lane's state was written by block 0
      long long re = 0;
      for (long long i = first; i < n; i += stride) {
        const int flag = __ldcg(lane_flag + i);
        const int32_t slot_i = __ldcg(lane_slot + i);
        if (slot_i < 0 || !(flag & kImprove)) continue;
        const uint32_t slot = (uint32_t)slot_i;
        atomicMin(&t.t_g[slot], pend[i * PW + t.W + 2]);
        t.t_fpar[slot] = kI64Max;
        t.t_state[slot] = 1;
        re += (flag & kReopen) != 0;
      }
      re = step::block_sum(re, red);
      if (tid == 0 && re != 0)
        atomicAdd((unsigned long long*)&state[step::kReopen], (unsigned long long)re);
      grid.sync();
      for (long long i = first; i < n; i += stride) {
        const int32_t slot_i = __ldcg(lane_slot + i);
        if (slot_i < 0 || !(__ldcg(lane_flag + i) & kImprove)) continue;
        const uint32_t slot = (uint32_t)slot_i;
        const int32_t* e = pend + i * PW;
        if (__ldcg(&t.t_g[slot]) != e[t.W + 2]) continue;
        const long long fpar =
            (long long)(((unsigned long long)(uint32_t)e[t.W + 4] << 32) | (uint32_t)e[t.W + 3]);
        atomicMin(&t.t_fpar[slot], fpar);
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    const long long un = rounds >= 1 ? *(volatile long long*)&state[step::kCnt] : 0;
    const long long tail_n = rounds >= 2 ? *(volatile long long*)&state[step::kCnt + 1] : 0;
    step::finish_step(counters, state, run, fill, lanes, undone,
                      (long long)(rounds > 1 ? rounds - 1 : 0) * lanes, un, tail_n);
    state[step::kCalls] = rounds;
#ifdef K10_PHASES
    mark[7] = globaltimer();
    for (int k = 0; k < kMarks; ++k) reinterpret_cast<long long*>(tail)[k] = mark[k];
#endif
  }
}

__global__ void __launch_bounds__(kThreads, 1) sync_chain_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < syncs; ++k) grid.sync();
}

// The card's multiprocessors and how many blocks of `kernel` each holds
// (the cooperative grid's limit), queried once a process.
template <typename Kernel>
int grid_limits(Kernel kernel, int& sms, int& per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) sms = 0;
  return (int)e;
}

cudaLaunchConfig_t cooperative(int blocks, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kUnpacked, int kVec>
int launch(const Table& t, const void* pend, int PW, void* lane_slot, void* lane_flag,
           int max_probes, int fill, void* run, void* counters, void* state, int blocks,
           void* tail, int cap, const void* recv, void* stream) {
  static int sms = 0, per_sm = 0;  // one card a process
  if (sms == 0) {
    const int e = grid_limits(keyrow_insert_kernel<kUnpacked, kVec>, sms, per_sm);
    if (e != 0) return e;
  }
  if (blocks == 0) blocks = sms;
  if (blocks < 1 || blocks > sms * per_sm) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cooperative(blocks, stream, attr);
  attr[1] = step::programmatic_edge();  // from K9 (or whatever ran before)
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, keyrow_insert_kernel<kUnpacked, kVec>, t, (const int32_t*)pend, PW, (int32_t*)lane_slot,
      (int32_t*)lane_flag, max_probes, fill, (int32_t*)run, (long long*)counters,
      (long long*)state, (int32_t*)tail, cap, (const int32_t*)recv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// t_key: (>= C, KWs) int32 key rows (packed: KWs = W + 1, the last column
// h; unpacked: KWs = W); claim: (>= C,) int32; packed: t_best (>= C,)
// int32 (t_g, t_fpar, t_state null); unpacked: t_g int32, t_fpar int64,
// t_state int32, each (>= C,) (t_best null); C a power of two; pend: K9's
// pending list, (lanes, W + 4 or W + 5) int32, its length in
// state[kNPend] (state[kNValid]: every surviving lane); lane_slot,
// lane_flag: (lanes,) int32 scratch; run: int32 device flag; counters: the
// 14 int64 counters; state: step_state.cuh.
// blocks: the cooperative grid, 0 for one block a multiprocessor; a grid
// larger than can be co-resident is refused.  tail: (>= cap,) int32, the
// tail list; cap: 0 .. kCap, the longest list that block 0 takes whole,
// and the most lanes left after round 0 on the grid that it takes then
// (0: every round on the grid).  keyrow_insert_recv:
// recv, the int32 count of rows received (read on the card), which lie
// just before pend: the list starts that many rows earlier, and they
// claim with their places; keyrow_insert is keyrow_insert_recv with none.
extern "C" int keyrow_insert_recv(void* t_key, int KWs, int N, int C, void* claim,
                                  void* t_best, void* t_g, void* t_fpar, void* t_state,
                                  int unpacked, const void* pend, void* lane_slot,
                                  void* lane_flag, int max_probes, int fill, void* run,
                                  void* counters, void* state, int blocks, void* tail, int cap,
                                  const void* recv, void* stream) {
  const int W = (N + 1) / 2;
  if (N < 2 || N > 16 || C < 2 || (C & (C - 1)) != 0 || KWs != W + (unpacked ? 0 : 1) ||
      max_probes < 1 || max_probes > step::kMaxCalls || fill < 1 || blocks < 0 || cap < 0 ||
      cap > kCap || (cap > 0 && tail == nullptr) ||
      (unpacked ? (t_g == nullptr || t_fpar == nullptr || t_state == nullptr)
                : t_best == nullptr))
    return (int)cudaErrorInvalidValue;
  const Table t{(int32_t*)t_key, KWs, W, (uint32_t)(C - 1), (int32_t*)claim,
                (int32_t*)t_best, (int32_t*)t_g, (long long*)t_fpar, (int32_t*)t_state, 0};
  if (unpacked)
    return launch<true, 1>(t, pend, W + 5, lane_slot, lane_flag, max_probes, fill, run,
                           counters, state, blocks, tail, cap, recv, stream);
  // packed key rows in int4 where they are 16-byte aligned (W = 3 or 7)
  const bool vec = KWs % 4 == 0 && (uintptr_t)t_key % 16 == 0;
  return vec ? launch<false, 4>(t, pend, W + 4, lane_slot, lane_flag, max_probes, fill, run,
                                counters, state, blocks, tail, cap, recv, stream)
             : launch<false, 1>(t, pend, W + 4, lane_slot, lane_flag, max_probes, fill, run,
                                counters, state, blocks, tail, cap, recv, stream);
}

extern "C" int keyrow_insert(void* t_key, int KWs, int N, int C, void* claim, void* t_best,
                             void* t_g, void* t_fpar, void* t_state, int unpacked,
                             const void* pend, void* lane_slot, void* lane_flag, int max_probes,
                             int fill, void* run, void* counters, void* state, int blocks,
                             void* tail, int cap, void* stream) {
  return keyrow_insert_recv(t_key, KWs, N, C, claim, t_best, t_g, t_fpar, t_state, unpacked,
                            pend, lane_slot, lane_flag, max_probes, fill, run, counters, state,
                            blocks, tail, cap, nullptr, stream);
}

// `syncs` grid syncs in an otherwise empty cooperative kernel of `blocks`
// (0: one a multiprocessor) x kThreads threads: the cost of K10's barrier.
extern "C" int grid_sync_chain(int syncs, int blocks, void* stream) {
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    const int e = grid_limits(sync_chain_kernel, sms, per_sm);
    if (e != 0) return e;
  }
  if (blocks == 0) blocks = sms;
  if (syncs < 0 || blocks < 1 || blocks > sms * per_sm) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cooperative(blocks, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sync_chain_kernel, syncs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
