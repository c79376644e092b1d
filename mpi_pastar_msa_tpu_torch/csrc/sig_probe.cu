// The claimless bucket probe of the sig insert, and the step's counters:
// kernel K5.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :1551 _insert_sig,
// :1441 _insert_core_sig, :1304 _insert_cascade_sig and :1007
// _probe_body_sig_factory (XLA inside the run loop), less their width
// ladders, compaction and tiers; the port's plain version is
// search/engine.py::_insert_sig after its round 0.  Its lanes are the
// pending list that sig_expand.cu leaves: candidates whose home bucket row
// did not hold their word.  In call k = 0, 1, ... every unsettled lane
//   - reads its current bucket row AS IT STOOD BEFORE ANY WRITE OF CALL k,
//   - settles on a way that holds word = sig base | min(r, 63), where
//     r = (bucket - home) mod nbuck (atomicMin of its packed word into
//     t_best at once: nothing reads t_best during the insert),
//   - else writes word into the (mix32(word) mod n_empty)-th empty way of
//     the row, or moves to the next bucket when the row was full;
// a lane with r >= 64 is stuck (overflow).  The calls go on while a lane
// is unsettled, at most 128.  Writers racing for one way: the SMALLEST word
// wins, by atomicMin on the word read as unsigned (the empty mark -1 is
// then 0xFFFFFFFF, above every stored word, which is below 2^31; a signed
// min would keep -1).  So the table, and the whole run, do not depend on
// the order in which lanes or blocks run.
//
// What bounds it on an H100: the chain of dependent calls (each a read
// phase and a write phase over the whole list), then bytes: a pending lane
// is 12 B, each call reads a 32 B row per live lane.
//
// Design: one cooperative persistent launch (cudaLaunchCooperativeKernel,
// blocks co-resident, at most kBlocksPerSm a multiprocessor) in which
// threads stride over the lanes; cooperative_groups' grid sync separates
// each call's read phase from its write phase and the write phase from the
// next call's reads.  A lane's state (its current bucket, -1 once settled,
// and its write of this call) lives in device arrays touched only by the
// thread that owns the lane.  The read phase counts the lanes still
// unsettled into state[kCnt + k] (one atomic a block); every thread reads
// the count after the sync, so all leave the loop together, with no host
// read.  The alternative, two launches a call and a host read of the live
// count, would put a host sync back into every call.  After the loop one
// thread writes this step's counters (search/engine.py::N_COUNTERS): steps,
// expanded, reopened, n_open, overflow, f-min, the threshold of
// _adapt_thr, lanes_true and lanes_r0 (the surviving lanes), lanes_probe
// (calls x those lanes, the plain loop's lane-rounds), lanes_unmatched
// (the pending lanes) and lanes_tail (unsettled after call 2, 0 when
// fewer than 2 calls ran); then the run flag for the next step: the search
// goes on while f-min < goal_g and nothing overflowed (the stop test of
// the step loop, on the device).

#include <cooperative_groups.h>

#include "step_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;

__global__ void __launch_bounds__(kThreads) sig_probe_kernel(
    int32_t* __restrict__ t_sig, int32_t* __restrict__ t_best, const int32_t* __restrict__ pend,
    int32_t* __restrict__ lane_cur, int32_t* __restrict__ lane_dest,
    int32_t* __restrict__ lane_word, int bbits, int max_bprobes, int max_calls, int fill,
    int32_t* __restrict__ run, long long* __restrict__ counters, long long* __restrict__ state) {
  __shared__ long long red[32];
  cg::grid_group grid = cg::this_grid();
  // one thread rewrites the flag at the end: every block has read it by
  // the first grid sync, and without pending lanes (no sync) a block that
  // reads the new flag has nothing to do
  if (*run == 0) return;
  const uint32_t Bmask = (1u << bbits) - 1u;
  const long long n = state[step::kNPend];
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = first; i < n; i += stride) lane_cur[i] = pend[3 * i];  // home

  long long undone = n;
  int calls = 0;
  while (undone > 0 && calls < max_calls) {
    // read phase: every live lane against the rows as the last call left them
    long long left = 0;
    for (long long i = first; i < n; i += stride) {
      const int32_t cur = lane_cur[i];
      lane_dest[i] = -1;
      if (cur < 0) continue;
      const uint32_t home = (uint32_t)pend[3 * i];
      const uint32_t r = ((uint32_t)cur - home) & Bmask;
      ++left;
      if (r >= (uint32_t)max_bprobes) continue;  // stuck: overflow
      const int32_t word = (int32_t)((uint32_t)pend[3 * i + 1] | r);
      const int4* row4 = reinterpret_cast<const int4*>(t_sig + (size_t)cur * 8);
      const int4 a = row4[0], c = row4[1];
      const int32_t ways[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      int mway = -1;
      unsigned emask = 0;
      for (int w = 7; w >= 0; --w) {
        if (ways[w] == word) mway = w;
        emask |= (unsigned)(ways[w] == -1) << w;
      }
      if (mway >= 0) {
        atomicMin(&t_best[(size_t)cur * 8 + mway], pend[3 * i + 2]);
        lane_cur[i] = -1;
        --left;
        continue;
      }
      const int n_empty = __popc(emask);
      if (n_empty == 0) {
        lane_cur[i] = (int32_t)(((uint32_t)cur + 1u) & Bmask);
        continue;
      }
      // the rank-th empty way, rank = mix32(word) mod n_empty
      int rank = (int)(step::mix32((uint32_t)word) % (uint32_t)n_empty);
      int fway = 0;
      for (int w = 0; w < 8; ++w) {
        if ((emask >> w) & 1) {
          if (rank == 0) {
            fway = w;
            break;
          }
          --rank;
        }
      }
      lane_dest[i] = cur * 8 + fway;
      lane_word[i] = word;
    }
    const long long blk = step::block_sum(left, red);
    if (threadIdx.x == 0 && blk != 0)
      atomicAdd((unsigned long long*)&state[step::kCnt + calls], (unsigned long long)blk);
    grid.sync();
    undone = *(volatile long long*)&state[step::kCnt + calls];
    // write phase: the smallest word wins each way
    for (long long i = first; i < n; i += stride) {
      const int32_t d = lane_dest[i];
      if (d >= 0) atomicMin((unsigned int*)&t_sig[d], (unsigned int)lane_word[i]);
    }
    grid.sync();
    ++calls;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long* c = counters;
    const long long n_sel = state[step::kNSel], lanes = state[step::kNValid];
    c[step::cFmin] = state[step::kFmin];
    c[step::cSteps] += 1;
    c[step::cExpanded] += n_sel;
    c[step::cReopened] += state[step::kReopen];
    c[step::cNOpen] = state[step::kNOpen];
    c[step::cOverflow] += undone;
    // _adapt_thr: widen when the batch under-fills, shrink when full
    const long long thr = c[step::cThr];
    long long nt = n_sel < fill / 2 ? thr * 2 + 32 : (n_sel >= fill - fill / 8 ? thr / 2 : thr);
    c[step::cThr] = nt < (1ll << 20) ? nt : (1ll << 20);
    c[step::cSelProc] += n_sel;
    c[step::cLanesTrue] += lanes;
    c[step::cLanesR0] += lanes;
    c[step::cLanesProbe] += (long long)calls * lanes;
    c[step::cLanesUnmatched] += n;
    c[step::cLanesTail] += calls >= 2 ? state[step::kCnt + 1] : 0;
    state[step::kCalls] = calls;
    *run = c[step::cFmin] < c[step::cGoal] && c[step::cOverflow] == 0;
  }
}

}  // namespace

// pend: the pending list of sig_expand.cu, (cap, 3) int32; lane_cur,
// lane_dest, lane_word: (cap,) int32 scratch; run: int32 device flag;
// counters: the 14 int64 counters; state: step_state.cuh.  blocks: the
// cooperative grid, 0 for every multiprocessor times kBlocksPerSm (capped
// by the occupancy); a grid larger than can be co-resident is refused.
extern "C" int sig_probe(void* t_sig, void* t_best, const void* pend, void* lane_cur,
                         void* lane_dest, void* lane_word, int bbits, int max_bprobes,
                         int max_calls, int fill, void* run, void* counters, void* state,
                         int blocks, void* stream) {
  if (bbits < 1 || bbits > 28 || max_bprobes < 1 || max_bprobes > 64 || max_calls < 1 ||
      max_calls > step::kMaxCalls || fill < 1 || blocks < 0)
    return (int)cudaErrorInvalidValue;
  static int sms = 0, per_sm = 0;  // one card a process
  cudaError_t e;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sig_probe_kernel, kThreads, 0);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  const int most = sms * per_sm;
  if (blocks == 0) blocks = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  if (blocks < 1 || blocks > most) return (int)cudaErrorInvalidValue;
  int32_t* a_sig = (int32_t*)t_sig;
  int32_t* a_best = (int32_t*)t_best;
  const int32_t* a_pend = (const int32_t*)pend;
  int32_t* a_cur = (int32_t*)lane_cur;
  int32_t* a_dest = (int32_t*)lane_dest;
  int32_t* a_word = (int32_t*)lane_word;
  int32_t* a_run = (int32_t*)run;
  long long* a_ctr = (long long*)counters;
  long long* a_state = (long long*)state;
  void* args[] = {&a_sig, &a_best, &a_pend, &a_cur, &a_dest, &a_word, &bbits, &max_bprobes,
                  &max_calls, &fill, &a_run, &a_ctr, &a_state};
  e = cudaLaunchCooperativeKernel((const void*)sig_probe_kernel, dim3(blocks), dim3(kThreads),
                                  args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
