// The claim-protocol insert of a key-row table (the packed and the unpacked
// layouts), and the step's counters: kernel K10.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :964
// _probe_body_packed_factory, :1262 _insert_core_packed and :1489
// _insert_packed (packed), :659 _probe_body_factory, :696 _insert_core and
// :799 _insert (unpacked), less their width ladders and compaction (XLA
// inside the run loops :1819 and :1999).  The port's plain versions are
// search/engine.py::_probe_claim, _insert_core_packed and _insert_core.
// Its lanes are the pending list that keyrow_expand.cu (K9) leaves: every
// candidate that survived the prune, with its key words, hash h0 and claim
// tag.  Round r = 0, 1, ... of every unsettled lane:
//   - reads the key row at probe_slot(h0, r) AS IT STOOD BEFORE ANY WRITE
//     OF ROUND r: a row that holds the key settles the lane (match); at an
//     empty row the lane claims the slot (atomicMin of its tag into claim);
//   - (grid sync) the lane whose tag is the slot's claim word writes its
//     key row there (packed: and h) and settles (won);
//   - (grid sync) every other claimer re-reads the row and settles if the
//     winner wrote its key (match2);
// for at most max_probes = 128 rounds, while a lane is unsettled.  Claim
// words start at INFP and a claimed slot is written in the round that
// claims it, so it is never claimed again: atomicMin over the old word
// gives the plain step's scatter-min of this round's tags.  Because the
// tags are content tags (K9), the winner, and so the table, is the plain
// step's whatever order the lanes run in.  A lane settles once; then
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
// Key rows written in one round are re-read after a grid sync, and claim
// words after the atomics: both through L2 (__ldcg), never a stale L1.
//
// What bounds it on an H100: the chain of dependent rounds (each a read
// phase, a claim/write phase, a re-read phase, with a grid sync between),
// not bytes: a lane is W + 4 or W + 5 words and each round reads one key row
// (16-24 B) per live lane.  A step is at least one round; the grid syncs
// (two a round, two more for the unpacked placement) set its floor.
//
// Design: one cooperative launch a step (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative, which a CUDA graph captures), every block
// striding over the lanes, a lane's state in two device arrays (lane_slot:
// its slot once settled, else -1; lane_flag: claiming this round, and on
// the unpacked layout improve and reopen) touched only by the thread that
// owns the lane.  The re-read of round r and the read of round r + 1 are
// one phase: the unsettled count of round r is summed there (one atomic a
// block into state[kCnt + r]) and read by every thread after the sync, so
// all leave the loop together; no lane reads round max_probes.  Last, one
// thread writes this step's counters (step::finish_step): lanes_probe is
// (rounds - 1) x lanes, lanes_unmatched the lanes unsettled after round 1,
// lanes_tail after round 2 (0 when fewer ran), as the plain step counts
// them; reopens come from K3 (packed) or from here (unpacked).

#include <cooperative_groups.h>

#include "step_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
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
};

// Does the key row at `slot` hold the lane's key (`e`: its pending entry)?
__device__ __forceinline__ bool row_holds(const Table& t, uint32_t slot, const int32_t* e) {
  const int32_t* row = t.t_key + (size_t)slot * t.KWs;
  for (int w = 0; w < t.W; ++w)
    if (__ldcg(row + w) != e[w]) return false;
  return true;
}

// A lane settles at `slot`.
template <bool kUnpacked>
__device__ __forceinline__ void settle(const Table& t, long long i, uint32_t slot,
                                       const int32_t* e, int32_t* lane_slot,
                                       int32_t* lane_flag) {
  lane_slot[i] = (int32_t)slot;
  int flag = 0;
  if constexpr (kUnpacked) {
    if (e[t.W + 2] < t.t_g[slot]) flag = kImprove | (t.t_state[slot] == 2 ? kReopen : 0);
  } else {
    atomicMin(&t.t_best[slot], e[t.W + 3]);
  }
  lane_flag[i] = flag;
}

// Round r's read of an unsettled lane: match, or claim an empty row.
template <bool kUnpacked>
__device__ __forceinline__ void probe(const Table& t, long long i, int r, const int32_t* e,
                                      int32_t* lane_slot, int32_t* lane_flag) {
  const uint32_t slot = step::probe_slot((uint32_t)e[t.W], r, t.Cmask);
  if (__ldcg(t.t_key + (size_t)slot * t.KWs) != -1) {
    if (row_holds(t, slot, e)) {
      settle<kUnpacked>(t, i, slot, e, lane_slot, lane_flag);
      return;
    }
    lane_flag[i] = 0;
  } else {
    atomicMin(&t.claim[slot], e[t.W + 1]);
    lane_flag[i] = kClaim;
  }
  lane_slot[i] = -1;
}

template <bool kUnpacked>
__global__ void __launch_bounds__(kThreads, 1) keyrow_insert_kernel(
    Table t, const int32_t* __restrict__ pend, int PW, int32_t* __restrict__ lane_slot,
    int32_t* __restrict__ lane_flag, int max_probes, int fill, int32_t* __restrict__ run,
    long long* __restrict__ counters, long long* __restrict__ state) {
  __shared__ long long red[32];
  // one thread rewrites the flag at the end; with lanes, every block has
  // read it by the first grid sync, and without, a block that reads the
  // new flag has nothing to do
  if (*run == 0) return;
  const long long n = state[step::kNValid];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  cg::grid_group grid = cg::this_grid();
  int rounds = 0;
  long long undone = n;
  if (n > 0) {
    for (long long i = first; i < n; i += stride)
      probe<kUnpacked>(t, i, 0, pend + i * PW, lane_slot, lane_flag);
    grid.sync();
    for (int r = 0;; ++r) {
      // the smallest tag at each claimed slot writes its row
      for (long long i = first; i < n; i += stride) {
        if (lane_flag[i] != kClaim) continue;
        const int32_t* e = pend + i * PW;
        const uint32_t slot = step::probe_slot((uint32_t)e[t.W], r, t.Cmask);
        if (__ldcg(&t.claim[slot]) != e[t.W + 1]) continue;
        int32_t* row = t.t_key + (size_t)slot * t.KWs;
        for (int w = 0; w < t.W; ++w) row[w] = e[w];
        if constexpr (!kUnpacked) row[t.W] = e[t.W + 2];  // h
        settle<kUnpacked>(t, i, slot, e, lane_slot, lane_flag);
      }
      grid.sync();
      // the losers re-read (match2); the unsettled go on to round r + 1
      long long left = 0;
      for (long long i = first; i < n; i += stride) {
        if (lane_slot[i] >= 0) continue;
        const int32_t* e = pend + i * PW;
        if (lane_flag[i] == kClaim) {
          const uint32_t slot = step::probe_slot((uint32_t)e[t.W], r, t.Cmask);
          if (row_holds(t, slot, e)) {
            settle<kUnpacked>(t, i, slot, e, lane_slot, lane_flag);
            continue;
          }
        }
        ++left;
        if (r + 1 < max_probes) probe<kUnpacked>(t, i, r + 1, e, lane_slot, lane_flag);
      }
      left = step::block_sum(left, red);
      if (tid == 0 && left != 0)
        atomicAdd((unsigned long long*)&state[step::kCnt + r], (unsigned long long)left);
      grid.sync();
      rounds = r + 1;
      undone = *(volatile long long*)&state[step::kCnt + r];
      if (undone == 0 || rounds >= max_probes) break;
    }
    if constexpr (kUnpacked) {
      // decrease-key: the min g, then (f, parent) among the lanes that
      // brought it
      long long re = 0;
      for (long long i = first; i < n; i += stride) {
        const int flag = lane_flag[i];
        if (lane_slot[i] < 0 || !(flag & kImprove)) continue;
        const uint32_t slot = (uint32_t)lane_slot[i];
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
        if (lane_slot[i] < 0 || !(lane_flag[i] & kImprove)) continue;
        const uint32_t slot = (uint32_t)lane_slot[i];
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
    const long long tail = rounds >= 2 ? *(volatile long long*)&state[step::kCnt + 1] : 0;
    step::finish_step(counters, state, run, fill, n, undone,
                      (long long)(rounds > 1 ? rounds - 1 : 0) * n, un, tail);
    state[step::kCalls] = rounds;
  }
}

template <bool kUnpacked>
int launch(const Table& t, const void* pend, int PW, void* lane_slot, void* lane_flag,
           int max_probes, int fill, void* run, void* counters, void* state, int blocks,
           void* stream) {
  static int sms = 0, per_sm = 0;  // one card a process
  cudaError_t e;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keyrow_insert_kernel<kUnpacked>,
                                                        kThreads, 0);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  if (blocks == 0) blocks = sms;
  if (blocks < 1 || blocks > sms * per_sm) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, keyrow_insert_kernel<kUnpacked>, t, (const int32_t*)pend, PW,
                         (int32_t*)lane_slot, (int32_t*)lane_flag, max_probes, fill,
                         (int32_t*)run, (long long*)counters, (long long*)state);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// t_key: (>= C, KWs) int32 key rows (packed: KWs = W + 1, the last column
// h; unpacked: KWs = W); claim: (>= C,) int32; packed: t_best (>= C,)
// int32 (t_g, t_fpar, t_state null); unpacked: t_g int32, t_fpar int64,
// t_state int32, each (>= C,) (t_best null); C a power of two; pend: K9's
// pending list, (lanes, W + 4 or W + 5) int32, its length in
// state[kNValid]; lane_slot, lane_flag: (lanes,) int32 scratch; run: int32
// device flag; counters: the 14 int64 counters; state: step_state.cuh.
// blocks: the cooperative grid, 0 for one block a multiprocessor; a grid
// larger than can be co-resident is refused.
extern "C" int keyrow_insert(void* t_key, int KWs, int N, int C, void* claim, void* t_best,
                             void* t_g, void* t_fpar, void* t_state, int unpacked,
                             const void* pend, void* lane_slot, void* lane_flag, int max_probes,
                             int fill, void* run, void* counters, void* state, int blocks,
                             void* stream) {
  const int W = (N + 1) / 2;
  if (N < 2 || N > 16 || C < 2 || (C & (C - 1)) != 0 || KWs != W + (unpacked ? 0 : 1) ||
      max_probes < 1 || max_probes > step::kMaxCalls || fill < 1 || blocks < 0 ||
      (unpacked ? (t_g == nullptr || t_fpar == nullptr || t_state == nullptr)
                : t_best == nullptr))
    return (int)cudaErrorInvalidValue;
  const Table t{(int32_t*)t_key, KWs, W, (uint32_t)(C - 1), (int32_t*)claim, (int32_t*)t_best,
                (int32_t*)t_g, (long long*)t_fpar, (int32_t*)t_state};
  return unpacked ? launch<true>(t, pend, W + 5, lane_slot, lane_flag, max_probes, fill, run,
                                 counters, state, blocks, stream)
                  : launch<false>(t, pend, W + 4, lane_slot, lane_flag, max_probes, fill, run,
                                  counters, state, blocks, stream);
}
