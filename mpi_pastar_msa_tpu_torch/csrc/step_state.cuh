// The sig search step's shared device state: one int64 vector that the
// step's three kernels (select_best.cu, sig_expand.cu, sig_probe.cu) pass
// between them, and the helpers they share.  search/step.py names the same
// slots (STATE_*); the two lists must agree.
//
// The select (K3) writes every slot once a step: its own five when it has
// reduced the table, 0 in the rest (from kNValid on), which K4 and K5 then
// accumulate.  So every slot below is a count or a min of this step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace step {

constexpr long long kInfp = 0x7FFFFFFF;  // empty / infinite packed word
constexpr int kGmax = 0;    // INFP - the min over groups of the group min (K3)
constexpr int kNOpen = 1;   // open words in the table (K3)
constexpr int kNSel = 2;    // selected (active) rows: the compact list's length (K3)
constexpr int kReopen = 3;  // active rows whose slot was closed before (K3)
constexpr int kFmin = 4;    // f-min of this step, f0 added (K3)
constexpr int kNValid = 5;  // candidate lanes that survive the prune (K4)
constexpr int kNPend = 6;   // of them, unmatched in their home row (K4)
constexpr int kCalls = 7;   // probe calls run (K5)
constexpr int kCnt = 8;     // kCnt + k: lanes unsettled after call k (K5)
constexpr int kMaxCalls = 128;
constexpr int kWords = kCnt + kMaxCalls;

// The 14 counters of search/engine.py (N_COUNTERS), by slot.
constexpr int cGoal = 0, cFmin = 1, cSteps = 2, cExpanded = 3, cReopened = 4,
              cNOpen = 5, cOverflow = 6, cThr = 7, cSelProc = 8, cLanesTrue = 9,
              cLanesR0 = 10, cLanesProbe = 11, cLanesUnmatched = 12, cLanesTail = 13;

// Murmur3 finalizer, bijective on u32 (search/engine.py::_mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
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

}  // namespace step
