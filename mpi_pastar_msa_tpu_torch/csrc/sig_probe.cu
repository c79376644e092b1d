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
// the order in which lanes or blocks run, nor on which path below ran.
//
// What bounds it on an H100: the chain of dependent calls (each a read
// phase, then a write phase that the next read must see), not bytes: a
// pending lane is 12 B and each call reads a 32 B row per live lane
// (kinase: 0.1 us of HBM time a step).  A step is at least two calls (a
// lane that wrote re-reads its row to settle), 2 to 9 on the main path.
//
// Design: one launch a step, cooperative (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative, which a CUDA graph captures), whose
// blocks read the pending count n from the state vector and take one of
// two paths; the choice depends on n alone, so the host reads nothing.
//   - n <= cap (the block path; cap <= kCap = kThreads x kLanes): block 0
//     runs every call and the other blocks return at once.  A thread holds
//     kLanes lanes (lane tid + k kThreads) in registers: current bucket
//     (-1 once settled), home, sig base, packed word (all read once) and
//     the way it writes this call (4 bits).  A call requests every live
//     lane's row before it looks at any (kLanes loads in flight a thread:
//     one round trip to memory a call, not kLanes), then __syncthreads,
//     its writes, __threadfence and __syncthreads; rows are read through
//     L2 (__ldcg), where the atomics land.  The unsettled count of a call
//     is a block sum read after the first barrier (two barriers a call),
//     and the last call, the one that settles every lane, skips its writes
//     and their barrier.  Up to about 2,048 lanes one multiprocessor does
//     the calls faster than the whole card meets at grid barriers; above,
//     its load/store unit, which serves every lane's scattered row as a
//     request of its own, takes longer than the barriers (chip_smoke.py
//     --k5-sweep on kinase and synth6), so kCap is 2,048.  Most steps of
//     kinase `off` are below it (median 1,402 lanes), most of `auto` above
//     (median 5,984).
//   - n > cap (the grid path): every block, threads striding over the
//     lanes, a lane's state in device arrays (lane_cur, lane_dest,
//     lane_word) touched only by the thread that owns it; a grid sync
//     between each call's reads and its writes and after the writes, none
//     after the last call's reads.  Call 0 reads each lane's home from the
//     pending list (no separate pass).  The unsettled count of call k goes
//     to state[kCnt + k] (one atomic a block) and every thread reads it
//     after the sync, so all leave the loop together.
// K5 is launched over a programmatic edge from the kernel before it (K4)
// and waits for it first thing (step::wait_predecessor).
// After the loop one thread writes this step's counters
// (search/engine.py::N_COUNTERS): steps, expanded, reopened, n_open,
// overflow, f-min, the threshold of _adapt_thr, lanes_true and lanes_r0
// (the surviving lanes), lanes_probe (calls x those lanes, the plain
// loop's lane-rounds), lanes_unmatched (the pending lanes) and lanes_tail
// (unsettled after call 2, 0 when fewer than 2 calls ran); then the run
// flag for the next step: the search goes on while f-min < goal_g and
// nothing overflowed (the stop test of the step loop, on the device).
//
// -DK5_PHASES (a measurement build, not the engine's) leaves five
// %globaltimer readings of block 0's thread 0 in lane_word, read as int64:
// the start, the summed read phases (each up to its barrier), the summed
// write phases (each up to its barrier), the loop's end and the end.

#include <cooperative_groups.h>

#include "step_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 4;  // lanes a thread holds on the block path
constexpr int kCap = kThreads * kLanes;
constexpr int kNoWay = 8;  // a lane that writes nothing this call

#ifdef K5_PHASES
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// A lane's current bucket row, read through L2 (where the atomics land).
__device__ __forceinline__ void load_row(const int32_t* t_sig, int32_t cur, int4& a, int4& c) {
  const int4* row4 = reinterpret_cast<const int4*>(t_sig + (size_t)cur * 8);
  a = __ldcg(row4);
  c = __ldcg(row4 + 1);
}

// What a live, unstuck lane does with its bucket row `cur` as this call
// read it (a, c; word = sig base | r): settles on a way that holds word
// (returns 0, cur = -1, its packed word min'ed into t_best), or stays
// unsettled (returns 1) and moves to the next bucket (the row was full) or
// sets `way` to the empty way it writes this call.
__device__ __forceinline__ int settle_or_place(const int4 a, const int4 c, int32_t word,
                                               int32_t packed, int32_t& cur, int& way,
                                               int32_t* t_best, uint32_t Bmask) {
  const int32_t ways[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  int mway = -1;
  unsigned emask = 0;
#pragma unroll
  for (int w = 7; w >= 0; --w) {
    if (ways[w] == word) mway = w;
    emask |= (unsigned)(ways[w] == -1) << w;
  }
  if (mway >= 0) {
    atomicMin(&t_best[(size_t)cur * 8 + mway], packed);
    cur = -1;
    return 0;
  }
  const int n_empty = __popc(emask);
  if (n_empty == 0) {
    cur = (int32_t)(((uint32_t)cur + 1u) & Bmask);
    return 1;
  }
  // the rank-th empty way, rank = mix32(word) mod n_empty
  int rank = (int)(step::mix32((uint32_t)word) % (uint32_t)n_empty);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    if ((emask >> w) & 1) {
      if (rank == 0 && way == kNoWay) way = w;
      --rank;
    }
  }
  return 1;
}

// The step's counters and the run flag (one thread, after the calls): probe
// lane-rounds are calls x lanes, the unmatched lanes the pending ones, the
// tail the lanes unsettled after call 2 (0 when fewer ran).
__device__ void finish(long long* c, long long* state, int32_t* run, long long n, int calls,
                       long long undone, int fill) {
  const long long lanes = state[step::kNValid];
  step::finish_step(c, state, run, fill, lanes, undone, (long long)calls * lanes, n,
                    calls >= 2 ? state[step::kCnt + 1] : 0);
  state[step::kCalls] = calls;
}

__global__ void __launch_bounds__(kThreads, 1) sig_probe_kernel(
    int32_t* __restrict__ t_sig, int32_t* __restrict__ t_best, const int32_t* __restrict__ pend,
    int32_t* __restrict__ lane_cur, int32_t* __restrict__ lane_dest,
    int32_t* __restrict__ lane_word, int bbits, int max_bprobes, int max_calls, int fill,
    int cap, int32_t* __restrict__ run, long long* __restrict__ counters,
    long long* __restrict__ state, const int32_t* __restrict__ recv) {
  __shared__ long long red[32];
  step::wait_predecessor();  // the programmatic edge from K4
  // one thread rewrites the flag at the end: on the grid path every block
  // has read it by the first grid sync; on the block path a block that
  // reads the new flag has nothing to do
  if (*run == 0) return;
  // the sharded step: the rows received end where pend starts
  if (recv != nullptr) pend -= 3 * (long long)*recv;
  const long long n = state[step::kNPend];
  const uint32_t Bmask = (1u << bbits) - 1u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef K5_PHASES
  const long long t_start = globaltimer();
  long long t_read = 0, t_write = 0, t_mark = t_start;
#define K5_MARK(acc)                    \
  do {                                  \
    const long long t_ = globaltimer(); \
    acc += t_ - t_mark;                 \
    t_mark = t_;                        \
  } while (0)
#else
#define K5_MARK(acc) \
  do {               \
  } while (0)
#endif
  int calls = 0;
  long long undone = n;
  if (n <= cap) {
    // ---- the block path: block 0 alone, lanes in registers
    if (blockIdx.x != 0) return;
    int32_t cur[kLanes], packed[kLanes];
    uint32_t home[kLanes], sigb[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const long long i = tid + (long long)k * kThreads;
      cur[k] = i < n ? __ldg(pend + 3 * i) : -1;
      home[k] = (uint32_t)cur[k];
      sigb[k] = i < n ? (uint32_t)__ldg(pend + 3 * i + 1) : 0u;
      packed[k] = i < n ? __ldg(pend + 3 * i + 2) : 0;
    }
    while (undone > 0 && calls < max_calls) {
      // every live lane's row requested before any is used
      int4 a[kLanes], c[kLanes];
#pragma unroll
      for (int k = 0; k < kLanes; ++k)
        if (cur[k] >= 0 && (((uint32_t)cur[k] - home[k]) & Bmask) < (uint32_t)max_bprobes)
          load_row(t_sig, cur[k], a[k], c[k]);
      int left = 0;
      uint32_t ways = 0;  // the way lane k writes this call, 4 bits a lane
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        int way = kNoWay;
        if (cur[k] >= 0) {
          const uint32_t r = ((uint32_t)cur[k] - home[k]) & Bmask;
          if (r >= (uint32_t)max_bprobes)
            ++left;  // stuck: overflow
          else
            left += settle_or_place(a[k], c[k], (int32_t)(sigb[k] | r), packed[k], cur[k], way,
                                    t_best, Bmask);
        }
        ways |= (uint32_t)way << (4 * k);
      }
      left = __reduce_add_sync(0xffffffffu, left);
      if (lane == 0) red[warp] = left;  // the last reads of red were before B
      __syncthreads();  // A: every read of this call before any write
      undone = 0;
      for (int w = 0; w < kThreads / 32; ++w) undone += red[w];
      if (tid == 0) state[step::kCnt + calls] = undone;
      ++calls;
      K5_MARK(t_read);
      if (undone == 0) break;  // nothing left to write
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        const int way = (ways >> (4 * k)) & 15;
        if (way == kNoWay) continue;
        // a writing lane stays at its bucket: its word is sig base | r
        const uint32_t r = ((uint32_t)cur[k] - home[k]) & Bmask;
        atomicMin((unsigned int*)&t_sig[(size_t)cur[k] * 8 + way], sigb[k] | r);
      }
      __threadfence();
      __syncthreads();  // B: every write of this call before the next reads
      K5_MARK(t_write);
    }
  } else {
    // ---- the grid path: every block, lane state in device arrays
    cg::grid_group grid = cg::this_grid();
    const long long first = (long long)blockIdx.x * kThreads + tid;
    const long long stride = (long long)gridDim.x * kThreads;
    while (undone > 0 && calls < max_calls) {
      long long left = 0;
      for (long long i = first; i < n; i += stride) {
        const int32_t* pend_i = pend + 3 * i;
        const uint32_t home = (uint32_t)__ldg(pend_i);
        int32_t cur = calls == 0 ? (int32_t)home : lane_cur[i];
        if (cur < 0) continue;  // settled in an earlier call: its dest is -1
        ++left;
        const uint32_t r = ((uint32_t)cur - home) & Bmask;
        if (r >= (uint32_t)max_bprobes) continue;  // stuck: overflow
        int4 a, c;
        load_row(t_sig, cur, a, c);
        const int32_t word = (int32_t)((uint32_t)__ldg(pend_i + 1) | r);
        int way = kNoWay;
        if (!settle_or_place(a, c, word, __ldg(pend_i + 2), cur, way, t_best, Bmask)) --left;
        lane_cur[i] = cur;
        lane_dest[i] = way == kNoWay ? -1 : cur * 8 + way;
        if (way != kNoWay) lane_word[i] = word;
      }
      left = step::block_sum(left, red);
      if (tid == 0 && left != 0)
        atomicAdd((unsigned long long*)&state[step::kCnt + calls], (unsigned long long)left);
      grid.sync();
      undone = *(volatile long long*)&state[step::kCnt + calls];
      ++calls;
      K5_MARK(t_read);
      if (undone == 0) break;
      // write phase: the smallest word wins each way
      for (long long i = first; i < n; i += stride) {
        const int32_t d = lane_dest[i];
        if (d >= 0) atomicMin((unsigned int*)&t_sig[d], (unsigned int)lane_word[i]);
      }
      grid.sync();
      K5_MARK(t_write);
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
#ifdef K5_PHASES
    const long long t_loop = globaltimer();
#endif
    finish(counters, state, run, n, calls, undone, fill);
#ifdef K5_PHASES
    long long* out = reinterpret_cast<long long*>(lane_word);
    out[0] = t_start;
    out[1] = t_read;
    out[2] = t_write;
    out[3] = t_loop;
    out[4] = globaltimer();
#endif
  }
#undef K5_MARK
}

}  // namespace

// pend: the pending list of sig_expand.cu, (cap, 3) int32; lane_cur,
// lane_dest, lane_word: (cap,) int32 scratch of the grid path (lane_word
// holds >= 10 words); run: int32 device flag; counters: the 14 int64
// counters; state: step_state.cuh.  cap: the largest pending count the
// block path takes, 0 .. kCap (0: the grid path always).  blocks: the
// cooperative grid, 0 for one block a multiprocessor; a grid larger than
// can be co-resident is refused.  recv: null, or (the sharded step) the
// int32 count of rows received, which lie just before pend: the list then
// starts that many rows earlier (its length, state[kNPend], counts them).
extern "C" int sig_probe(void* t_sig, void* t_best, const void* pend, void* lane_cur,
                         void* lane_dest, void* lane_word, int bbits, int max_bprobes,
                         int max_calls, int fill, int cap, void* run, void* counters,
                         void* state, int blocks, const void* recv, void* stream) {
  if (bbits < 1 || bbits > 28 || max_bprobes < 1 || max_bprobes > 64 || max_calls < 1 ||
      max_calls > step::kMaxCalls || fill < 1 || cap < 0 || cap > kCap || blocks < 0)
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
  if (blocks == 0) blocks = sms;
  if (blocks < 1 || blocks > sms * per_sm) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1] = step::programmatic_edge();
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, sig_probe_kernel, (int32_t*)t_sig, (int32_t*)t_best,
                         (const int32_t*)pend, (int32_t*)lane_cur, (int32_t*)lane_dest,
                         (int32_t*)lane_word, bbits, max_bprobes, max_calls, fill, cap,
                         (int32_t*)run, (long long*)counters, (long long*)state,
                         (const int32_t*)recv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
