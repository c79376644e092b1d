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
//             (grid sync) each improving lane atomicMins g into t_g, sets
//             t_fpar = INT64_MAX and t_state = 1, and counts a reopen when
//             state_before was 2; (grid sync) each lane whose g is the new
//             t_g atomicMins f * 2^n + m into t_fpar (the plain step's
//             scatter-min among the winners).
// Key rows, claim words, t_g and lane states that another block may have
// written are read through L2 (__ldcg), never a stale L1.
//
// What bounds it on an H100: the chain of dependent rounds (each a read
// phase, a claim/write phase, a re-read phase, with a barrier between),
// not bytes: a lane is W + 4 or W + 5 words and each round reads one key
// row (16-24 B) per live lane.  A step is at least one round.  On the
// grid every barrier is a grid sync of 132 x 512 threads (1.1 us on the
// H100, chip_smoke.py), and the main path's steps leave few lanes after
// round 0 (kinase unpacked step 150: 550 of 8,342, then 29 and 5): their
// rounds cost the grid syncs and the dependent loads, not their bytes.
//
// Design: one cooperative launch a step (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative, which a CUDA graph captures).  Round 0
// on the grid: every block strides over the lanes, a lane's state in two
// device arrays (lane_slot: its slot once settled, else -1; lane_flag:
// claiming this round, and on the unpacked layout improve and reopen)
// touched only by the thread that owns the lane; a grid sync after its
// reads and after its writes.  In round 0's re-read phase, which also
// makes round 1's reads, each lane still unsettled appends its index to
// the tail list (one atomicAdd a warp into state[kCnt], which so counts
// round 0's unsettled lanes as before).  After a third grid sync every
// block reads that count t and all take the same path:
//   - t <= cap (the block path; cap <= kCap = kThreads x kLanes): block 0
//     alone runs rounds 1, 2, ... over the tail, a thread holding kLanes
//     lanes (index and claim flag) in registers, a __syncthreads after each
//     write phase and after each re-read phase (with the round's unsettled
//     count as a block sum); the other blocks return (packed) or wait at
//     one grid sync for the decrease-key (unpacked), which keeps its two
//     phases on the grid: its improving lanes are spread over the grid
//     and many (kinase unpacked: median 10,224 a step, far above any
//     block's share).  One block beats the grid's two syncs a round up to
//     about 1,024 lanes left and is no faster above (chip_smoke.py
//     --k10-sweep), so kCap is 1,024;
//   - t > cap or cap = 0 (the grid path): every round on the grid as round
//     0, two grid syncs a round; the re-read of round r and the read of
//     round r + 1 are one phase, which also sums round r's unsettled count
//     (one atomic a block into state[kCnt + r], read by every thread after
//     the sync, so all leave the loop together).
// Every phase issues a lane's loads together: a probe position's key
// words with (unpacked) its g and state; the claim word with them; the
// re-read of round r's position with round r + 1's.  So a phase is one
// round trip to memory a lane, not one a word.
// Grid syncs a step (search/step.py::k10_grid_syncs): packed 1 + 2 x
// rounds on the grid, 3 on the block path; unpacked one more, and two more
// after the block path.  No lane reads round max_probes.  Last, one thread
// writes this step's counters (step::finish_step): lanes_probe is (rounds
// - 1) x lanes, lanes_unmatched the lanes unsettled after round 1,
// lanes_tail after round 2 (0 when fewer ran), as the plain step counts
// them; reopens come from K3 (packed) or from here (unpacked).  K10 is
// launched over a programmatic edge from the kernel before it (K9) and
// waits for it first thing (step::wait_predecessor).
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

#include <cooperative_groups.h>

#include "step_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 2;  // lanes a thread holds on the block path
constexpr int kCap = kThreads * kLanes;
constexpr int kMaxW = 8;   // key words of N <= 16
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSettled = -1;  // decide(): the lane matched its row
constexpr int kClaim = 1;    // lane_flag: claimed its slot this round
constexpr int kImprove = 2;  // lane_flag (unpacked): settled with g < g_before
constexpr int kReopen = 4;   // lane_flag (unpacked): ... at a closed slot
constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFll;

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

// The claim tag of lane i (`e`: its pending entry): a received row's place
// in the list, else the tag it carries.
__device__ __forceinline__ int32_t tag_of(const Table& t, long long i, const int32_t* e) {
  return i < t.n_front ? (int32_t)i : e[t.W + 1];
}

// A probe position as a phase reads it: its key words and, on the
// unpacked layout, the g and state a lane settling there compares with
// (neither changes while lanes probe).  All its loads are issued together,
// through L2: one round trip, not one a word.
struct Slot {
  uint32_t at;
  int32_t key[kMaxW];
  int32_t g, state;
};

template <bool kUnpacked>
__device__ __forceinline__ Slot read_slot(const Table& t, uint32_t at) {
  Slot s;
  s.at = at;
  const int32_t* row = t.t_key + (size_t)at * t.KWs;
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) s.key[w] = w < t.W ? __ldcg(row + w) : 0;
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

// A lane settles at slot `s`.
template <bool kUnpacked>
__device__ __forceinline__ void settle(const Table& t, long long i, const Slot& s,
                                       const int32_t* e, int32_t* lane_slot,
                                       int32_t* lane_flag) {
  lane_slot[i] = (int32_t)s.at;
  int flag = 0;
  if constexpr (kUnpacked) {
    if (e[t.W + 2] < s.g) flag = kImprove | (s.state == 2 ? kReopen : 0);
  } else {
    atomicMin(&t.t_best[s.at], e[t.W + 3]);
  }
  lane_flag[i] = flag;
}

// An unsettled lane's read of its next probe position `s`: match, or claim
// an empty row.  Returns kSettled, or the lane's flag for the write phase.
template <bool kUnpacked>
__device__ __forceinline__ int decide(const Table& t, long long i, const Slot& s,
                                      const int32_t* e, int32_t* lane_slot,
                                      int32_t* lane_flag) {
  int flag = 0;
  if (s.key[0] != -1) {
    if (holds(t, s, e)) {
      settle<kUnpacked>(t, i, s, e, lane_slot, lane_flag);
      return kSettled;
    }
  } else {
    atomicMin(&t.claim[s.at], tag_of(t, i, e));
    flag = kClaim;
  }
  lane_flag[i] = flag;
  lane_slot[i] = -1;
  return flag;
}

// Round r's write phase for a claiming lane: if its tag won the slot's
// claim, it writes its key row (packed: and h) there and settles.  The
// claim word and what the lane settles with are read together.
template <bool kUnpacked>
__device__ __forceinline__ bool write_if_won(const Table& t, long long i, int r,
                                             const int32_t* e, int32_t* lane_slot,
                                             int32_t* lane_flag) {
  Slot s;
  s.at = step::probe_slot((uint32_t)e[t.W], r, t.Cmask);
  const int32_t c = __ldcg(&t.claim[s.at]);
  s.g = kUnpacked ? __ldcg(t.t_g + s.at) : 0;
  s.state = kUnpacked ? __ldcg(t.t_state + s.at) : 0;
  if (c != tag_of(t, i, e)) return false;
  int32_t* row = t.t_key + (size_t)s.at * t.KWs;
  for (int w = 0; w < t.W; ++w) row[w] = e[w];
  if constexpr (!kUnpacked) row[t.W] = e[t.W + 2];  // h
  settle<kUnpacked>(t, i, s, e, lane_slot, lane_flag);
  return true;
}

// Round r's re-read of a lane left unsettled by the write phase (`claimed`:
// it claimed this round and lost), merged with round r + 1's read: both
// positions are read together; it settles where the winner wrote its key
// (match2), else it is open and decides at r + 1 (no lane reads round
// max_probes).  Returns whether it is open after round r and sets `flag`
// to its state for round r + 1.
template <bool kUnpacked>
__device__ __forceinline__ bool reread(const Table& t, long long i, int r, bool claimed,
                                       const int32_t* e, int max_probes, int32_t* lane_slot,
                                       int32_t* lane_flag, int& flag) {
  const uint32_t h0 = (uint32_t)e[t.W];
  const bool next = r + 1 < max_probes;
  Slot a, b;
  if (claimed) a = read_slot<kUnpacked>(t, step::probe_slot(h0, r, t.Cmask));
  if (next) b = read_slot<kUnpacked>(t, step::probe_slot(h0, r + 1, t.Cmask));
  if (claimed && holds(t, a, e)) {
    settle<kUnpacked>(t, i, a, e, lane_slot, lane_flag);
    flag = kSettled;
    return false;
  }
  flag = next ? decide<kUnpacked>(t, i, b, e, lane_slot, lane_flag) : 0;
  return true;
}

// Rounds 1, 2, ... of the tail list's `n_tail` lanes (round 1's reads
// made) in one block: kLanes lanes a thread in registers, a __syncthreads
// after each phase (CTA-scope ordering: every write and claim of a phase
// is seen by the next phase's reads in this block, and no other block
// touches the table meanwhile).  Writes state[kCnt + r]; returns the
// rounds run in all (round 0 included) and sets `undone` to the lanes left.
template <bool kUnpacked>
__device__ int block_rounds(const Table& t, const int32_t* __restrict__ pend, int PW,
                            int32_t* __restrict__ lane_slot, int32_t* __restrict__ lane_flag,
                            const int32_t* __restrict__ tail, long long n_tail, int max_probes,
                            long long* __restrict__ state, long long* red, long long& undone) {
  const int tid = threadIdx.x;
  int lane_i[kLanes], flag[kLanes];  // flag kSettled once settled
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    // a tail lane may have matched in round 1's reads already
    const long long at = tid + (long long)k * kThreads;
    lane_i[k] = at < n_tail ? __ldcg(tail + at) : 0;
    flag[k] = at >= n_tail || __ldcg(lane_slot + lane_i[k]) >= 0 ? kSettled
                                                                 : __ldcg(lane_flag + lane_i[k]);
  }
  for (int r = 1;; ++r) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (flag[k] == kClaim &&
          write_if_won<kUnpacked>(t, lane_i[k], r, pend + (size_t)lane_i[k] * PW, lane_slot,
                                  lane_flag))
        flag[k] = kSettled;
    __syncthreads();  // every write of round r before its re-reads
    long long left = 0;
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (flag[k] != kSettled)
        left += reread<kUnpacked>(t, lane_i[k], r, flag[k] == kClaim,
                                  pend + (size_t)lane_i[k] * PW, max_probes, lane_slot,
                                  lane_flag, flag[k]);
    left = step::block_sum(left, red);  // also the barrier before round r + 1's writes
    if (tid == 0 && left != 0) state[step::kCnt + r] = left;
    undone = left;
    if (left == 0 || r + 1 >= max_probes) return r + 1;
  }
}

template <bool kUnpacked>
__global__ void __launch_bounds__(kThreads, 1) keyrow_insert_kernel(
    Table t, const int32_t* __restrict__ pend, int PW, int32_t* __restrict__ lane_slot,
    int32_t* __restrict__ lane_flag, int max_probes, int fill, int32_t* __restrict__ run,
    long long* __restrict__ counters, long long* __restrict__ state,
    int32_t* __restrict__ tail, int cap, const int32_t* __restrict__ recv) {
  __shared__ long long red[32];
  step::wait_predecessor();  // the programmatic edge from K9
  // one thread rewrites the flag at the end; with lanes, every block has
  // read it by the first grid sync, and without, a block that reads the
  // new flag has nothing to do
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
  const long long first = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  cg::grid_group grid = cg::this_grid();
  int rounds = 0;
  long long undone = 0;
  if (lanes > 0 || n > 0) {  // round 0 runs, over the list (empty if K9 settled all)
    for (long long i = first; i < n; i += stride) {
      const int32_t* e = pend + i * PW;
      const uint32_t at = step::probe_slot((uint32_t)e[t.W], 0, t.Cmask);
      decide<kUnpacked>(t, i, read_slot<kUnpacked>(t, at), e, lane_slot, lane_flag);
    }
    grid.sync();
    bool block_path = false;
    for (int r = 0;; ++r) {
      // the smallest tag at each claimed slot writes its row
      for (long long i = first; i < n; i += stride)
        if (lane_flag[i] == kClaim)
          write_if_won<kUnpacked>(t, i, r, pend + i * PW, lane_slot, lane_flag);
      grid.sync();
      // the losers re-read (match2); the unsettled go on to round r + 1,
      // and after round 0 into the tail list.  A warp runs each pass
      // whole (lanes past n idle), so its ballot is the tail's append.
      long long left = 0;
      for (long long b = first - lane; b < n; b += stride) {
        const long long i = b + lane;
        bool open = false;
        int flag;
        if (i < n && lane_slot[i] < 0)
          open = reread<kUnpacked>(t, i, r, lane_flag[i] == kClaim, pend + i * PW, max_probes,
                                   lane_slot, lane_flag, flag);
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
      rounds = r + 1;
      undone = *(volatile long long*)&state[step::kCnt + r];
      if (undone == 0 || rounds >= max_probes) break;
      if (r == 0 && undone <= cap) {
        block_path = true;
        break;
      }
    }
    if (block_path) {
      if (blockIdx.x == 0)
        rounds = block_rounds<kUnpacked>(t, pend, PW, lane_slot, lane_flag, tail, undone,
                                         max_probes, state, red, undone);
      if constexpr (kUnpacked)
        grid.sync();  // the decrease-key reads every lane's state
      else if (blockIdx.x != 0)
        return;
    }
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

template <bool kUnpacked>
int launch(const Table& t, const void* pend, int PW, void* lane_slot, void* lane_flag,
           int max_probes, int fill, void* run, void* counters, void* state, int blocks,
           void* tail, int cap, const void* recv, void* stream) {
  static int sms = 0, per_sm = 0;  // one card a process
  if (sms == 0) {
    const int e = grid_limits(keyrow_insert_kernel<kUnpacked>, sms, per_sm);
    if (e != 0) return e;
  }
  if (blocks == 0) blocks = sms;
  if (blocks < 1 || blocks > sms * per_sm) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cooperative(blocks, stream, attr);
  attr[1] = step::programmatic_edge();  // from K9 (or whatever ran before)
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, keyrow_insert_kernel<kUnpacked>, t, (const int32_t*)pend, PW, (int32_t*)lane_slot,
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
// tail list; cap: 0 .. kCap, the most lanes left after round 0 that the
// block path takes (0: every round on the grid).  keyrow_insert_recv:
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
  const Table t{(int32_t*)t_key, KWs, W, (uint32_t)(C - 1), (int32_t*)claim, (int32_t*)t_best,
                (int32_t*)t_g, (long long*)t_fpar, (int32_t*)t_state, 0};
  return unpacked ? launch<true>(t, pend, W + 5, lane_slot, lane_flag, max_probes, fill, run,
                                 counters, state, blocks, tail, cap, recv, stream)
                  : launch<false>(t, pend, W + 4, lane_slot, lane_flag, max_probes, fill, run,
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
