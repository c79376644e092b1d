// Grouped-argmin selection of the sig and packed layouts: kernel K3.
//
// Replaces mpi_pastar_msa_tpu/search/engine.py:1620 _select_sig and :1668
// _select_packed (the grouped argmin they share, XLA inside the run loop);
// in the port it is search/engine.py::_select_best, whose plain version
// (_select_best_plain) computes the same thing.  The table (C,) of packed
// words ((f - f0) << n) | parent mask is viewed as B groups of G = C / B
// slots.  A word is open when t_best < t_closed and (t_best >> n) <
// goal_g - f0.  Each group offers its argmin open word, the FIRST index on
// ties (INFP for a group with no open word); the step's f-min is the min of
// the group mins; a group's pick is active when its word is at most
//   cut = (min(fmin_r + thr + 1, INFP >> n) << n) - 1,
// and then t_closed[slot] takes the word.  Also counted: open words,
// active rows, and active rows whose slot was closed before (reopens).
//
// What bounds it on an H100: bytes.  It must read t_best and t_closed once,
// 2 x 4 B x 2^23 = 67.1 MB at kinase, 20.0 us at 3.35 TB/s; the outputs
// are B x 17 B.
//
// Design: two launches from one C call, after a memset of the step's state
// vector (step_state.cuh).
//  - group_argmin: one block of 256 threads per group; neighbouring threads
//    read neighbouring words (coalesced).  Each thread keeps the 64-bit key
//    (word << 32) | index, so a plain min of keys is the argmin with the
//    first index on ties; warp shuffles and one shared word per warp reduce
//    the block.  The block writes its slot and word, adds its open count,
//    and folds its min into the global one with one atomicMax of INFP - min
//    (the state is zeroed, so no group means INFP).
//  - select_finish: blocks run in no order, so the cut needs the global min
//    of every group: a second launch, one thread per group, applies the
//    cut, closes the active slots (read before the write, for the reopen
//    count) and adds its block's counts.
// A null `run` flag runs the selection; a flag that reads 0 (the search
// step loop of search/step.py has stopped) makes both launches return at
// once.

#include "step_state.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads) group_argmin(
    const int32_t* __restrict__ best, const int32_t* __restrict__ closed, int G, int nb,
    long long f0, const long long* __restrict__ goal, const int32_t* __restrict__ run,
    long long* __restrict__ slots, long long* __restrict__ vmin,
    long long* __restrict__ state) {
  __shared__ unsigned long long skey[kThreads / 32];
  __shared__ long long red[32];
  if (run != nullptr && *run == 0) return;
  const int b = blockIdx.x;
  const long long lim = *goal - f0;
  const size_t base = (size_t)b * G;
  unsigned long long key = ~0ull;
  long long n_open = 0;
  for (int j = threadIdx.x; j < G; j += kThreads) {
    const int32_t w = best[base + j];
    const bool open = w < closed[base + j] && (long long)(w >> nb) < lim;
    n_open += open;
    key = umin64(key, ((unsigned long long)(open ? w : step::kInfp) << 32) | (unsigned)j);
  }
  for (int o = 16; o > 0; o >>= 1) key = umin64(key, __shfl_down_sync(0xffffffffu, key, o));
  if ((threadIdx.x & 31) == 0) skey[threadIdx.x >> 5] = key;
  const long long opened = step::block_sum(n_open, red);  // syncs the block
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) key = umin64(key, skey[w]);
    const long long v = (long long)(key >> 32);
    slots[b] = (long long)base + (long long)(key & 0xffffffffu);
    vmin[b] = v;
    atomicMax((unsigned long long*)&state[step::kGmax], (unsigned long long)(step::kInfp - v));
    atomicAdd((unsigned long long*)&state[step::kNOpen], (unsigned long long)opened);
  }
}

__global__ void __launch_bounds__(kThreads) select_finish(
    int32_t* __restrict__ closed, int B, int nb, long long f0,
    const long long* __restrict__ thr, const int32_t* __restrict__ run,
    const long long* __restrict__ slots, long long* __restrict__ vmin,
    uint8_t* __restrict__ active, long long* __restrict__ state) {
  __shared__ long long red[32];
  if (run != nullptr && *run == 0) return;
  const long long fmin_r = (step::kInfp - state[step::kGmax]) >> nb;
  long long lim = fmin_r + *thr + 1;
  if (lim > (step::kInfp >> nb)) lim = step::kInfp >> nb;
  const long long cut = (lim << nb) - 1;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b == 0) state[step::kFmin] = fmin_r + f0;
  bool act = false, reopen = false;
  if (b < B) {
    const long long v = vmin[b];
    act = v <= cut;  // an empty group holds INFP > cut
    if (act) {
      const long long s = slots[b];
      reopen = closed[s] < step::kInfp;
      closed[s] = (int32_t)v;
    }
    vmin[b] = act ? v : step::kInfp;
    active[b] = act;
  }
  const long long n_sel = step::block_sum(act, red);
  const long long n_re = step::block_sum(reopen, red);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)&state[step::kNSel], (unsigned long long)n_sel);
    atomicAdd((unsigned long long*)&state[step::kReopen], (unsigned long long)n_re);
  }
}

}  // namespace

// best, closed: (>= C,) int32 tables; goal, thr: int64 device scalars;
// run: int32 device flag or null; slots, vmin: (B,) int64 and active: (B,)
// uint8 outputs; state: (step::kWords,) int64, zeroed here.
extern "C" int select_best(const void* best, void* closed, int C, int B, int nb, long long f0,
                           const void* goal, const void* thr, const void* run, void* slots,
                           void* vmin, void* active, void* state, void* stream) {
  if (B < 1 || C < B || C % B != 0 || nb < 1 || nb > 30) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(state, 0, step::kWords * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  group_argmin<<<B, kThreads, 0, s>>>(
      (const int32_t*)best, (const int32_t*)closed, C / B, nb, f0, (const long long*)goal,
      (const int32_t*)run, (long long*)slots, (long long*)vmin, (long long*)state);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_finish<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (int32_t*)closed, B, nb, f0, (const long long*)thr, (const int32_t*)run,
      (const long long*)slots, (long long*)vmin, (uint8_t*)active, (long long*)state);
  return (int)cudaGetLastError();
}
