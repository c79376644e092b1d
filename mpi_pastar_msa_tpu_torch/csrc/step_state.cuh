// The search step's shared device state: one int64 vector that a step's
// three kernels pass between them (select_best.cu, then sig_expand.cu and
// sig_probe.cu on the sig layout, keyrow_expand.cu and keyrow_insert.cu on
// the packed and unpacked ones), and the helpers they share.
// search/step.py names the same slots (STATE_*); the two lists must agree.
//
// The select (K3) writes every slot once a step: its own five when it has
// reduced the table, 0 in the rest (from kNValid on), which the expand and
// the insert then accumulate.  So every slot below is a count or a min of
// this step.
//
// Also here: the two halves of the programmatic edge that the expand (K4,
// K9) and the insert (K5, K10) are launched over (wait_predecessor,
// programmatic_edge).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace step {

constexpr long long kInfp = 0x7FFFFFFF;  // empty / infinite packed word
constexpr int kGmax = 0;    // INFP - the min over groups of the group min (K3)
constexpr int kNOpen = 1;   // open words in the table (K3)
constexpr int kNSel = 2;    // selected (active) rows: the compact list's length (K3)
constexpr int kReopen = 3;  // active rows whose slot was closed before (K3;
                            // unpacked: 0 from K3, the insert's reopens, K10)
constexpr int kFmin = 4;    // f-min of this step, f0 added (K3)
constexpr int kNValid = 5;  // candidate lanes that survive the prune (K4, K9)
constexpr int kNPend = 6;   // of them, pending: unmatched in their home row (K4, K9
                            // packed; K9 unpacked: all of them)
constexpr int kCalls = 7;   // probe calls (K5) or claim rounds (K10) run
constexpr int kCnt = 8;     // kCnt + k: lanes unsettled after call or round k
constexpr int kMaxCalls = 128;
constexpr int kWords = kCnt + kMaxCalls;

// The 14 counters of search/engine.py (N_COUNTERS), by slot.
constexpr int cGoal = 0, cFmin = 1, cSteps = 2, cExpanded = 3, cReopened = 4,
              cNOpen = 5, cOverflow = 6, cThr = 7, cSelProc = 8, cLanesTrue = 9,
              cLanesR0 = 10, cLanesProbe = 11, cLanesUnmatched = 12, cLanesTail = 13;

constexpr long long kInf = 1 << 30;  // search/engine.py INF: no g, no f

// Murmur3 finalizer, bijective on u32 (search/engine.py::_mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Key word i of a coordinate, two 16-bit coordinates a word
// (search/engine.py::_pack_keys; a missing odd coordinate is 0).
__device__ __forceinline__ uint32_t key_word(const int32_t* c, int i, int N) {
  const uint32_t lo = (uint32_t)c[2 * i];
  const uint32_t hi = 2 * i + 1 < N ? (uint32_t)c[2 * i + 1] : 0u;
  return lo | (hi << 16);
}

// FNV-1a over the W key words, then the Murmur3 finalizer
// (search/engine.py::_hash_keys).
__device__ __forceinline__ uint32_t hash_keys(const uint32_t* w, int W) {
  uint32_t h = 2166136261u;
  for (int i = 0; i < W; ++i) h = (h ^ w[i]) * 16777619u;
  return mix32(h);
}

// Triangular probing: round r of a key whose hash is h0 visits slot
// h0 + r (r + 1) / 2 of a 2^k table (search/engine.py::_probe_slot).
__device__ __forceinline__ uint32_t probe_slot(uint32_t h0, int r, uint32_t Cmask) {
  return (h0 + (uint32_t)((r * (r + 1)) >> 1)) & Cmask;
}

// Sum of v over the block (every thread gets it).  blockDim.x is a
// multiple of 32 and at most 1024; `red` holds 32 words of shared memory.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// The kernel's end of a programmatic edge (sm_90): it waits until the
// previous kernel on the stream has finished and its writes are visible
// (griddepcontrol.wait), before its first read of them.  A no-op unless
// the kernel was launched with the attribute of programmatic_edge(); so a
// kernel that calls this first thing is correct under either launch, and
// so is every kernel after it (it ends only after its predecessor has).
// No kernel of the step triggers its successor early
// (griddepcontrol.launch_dependents): the successor's blocks would wait
// beside the running grid.
__device__ __forceinline__ void wait_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The launch attribute of a programmatic edge from the previous kernel on
// the stream: the runtime may start this grid's launch while that one
// drains (a CUDA graph captures it as a programmatic edge).  Host side.
inline cudaLaunchAttribute programmatic_edge() {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return a;
}

// The step's 14 counters and the run flag, by one thread after the insert
// (the plain step loop's bookkeeping, search/engine.py::_run_chunk_plain):
// steps, expanded, reopened, n_open, overflow (`undone` lanes the insert
// left), f-min, the threshold of _adapt_thr, lanes_true and lanes_r0 (the
// `lanes` that survived the prune), and counter slots 11-13 as the insert
// counts them; then the run flag for the next step: the search goes on
// while f-min < goal_g and nothing overflowed.  The state slots are read
// through L2 (__ldcg): other blocks of the insert may have added to them.
__device__ __forceinline__ void finish_step(long long* c, const long long* state, int32_t* run,
                                            int fill, long long lanes, long long undone,
                                            long long probe_lanes, long long unmatched,
                                            long long tail) {
  const long long n_sel = __ldcg(&state[kNSel]);
  c[cFmin] = __ldcg(&state[kFmin]);
  c[cSteps] += 1;
  c[cExpanded] += n_sel;
  c[cReopened] += __ldcg(&state[kReopen]);
  c[cNOpen] = __ldcg(&state[kNOpen]);
  c[cOverflow] += undone;
  // _adapt_thr: widen when the batch under-fills, shrink when full
  const long long thr = c[cThr];
  long long nt = n_sel < fill / 2 ? thr * 2 + 32 : (n_sel >= fill - fill / 8 ? thr / 2 : thr);
  c[cThr] = nt < (1ll << 20) ? nt : (1ll << 20);
  c[cSelProc] += n_sel;
  c[cLanesTrue] += lanes;
  c[cLanesR0] += lanes;
  c[cLanesProbe] += probe_lanes;
  c[cLanesUnmatched] += unmatched;
  c[cLanesTail] += tail;
  *run = c[cFmin] < c[cGoal] && c[cOverflow] == 0;
}

}  // namespace step
