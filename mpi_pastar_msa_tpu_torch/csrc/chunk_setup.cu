// The set-up of a chunk of the single-table step loop (K6): one launch
// before a chunk's steps, eager or replayed (search/step.py::_setup).
//
// Replaces the set-up of the JAX engine's run loops
// (mpi_pastar_msa_tpu/search/engine.py :1882 _make_run_loop_sig, :1819
// _make_run_loop_packed, :1999 _make_run_loop): a chunk's while_loop
// starts from f-min 0, so its first step runs unless goal_g <= 0 or the
// table overflowed.  The plain version is search/step.py's
// chunk_setup_plain.  One thread: f-min (counters[1]) = 0 and the run
// flag = goal_g > 0 and no overflow.  What bounds it on an H100 is the
// launch: 28 bytes move.  (A set-up of PyTorch ops, five launches, left
// the card idle while the host issued them.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_state.cuh"

namespace {

__global__ void chunk_setup_kernel(long long* __restrict__ counters, int32_t* __restrict__ run) {
  counters[step::cFmin] = 0;
  *run = counters[step::cGoal] > 0 && counters[step::cOverflow] == 0;
}

}  // namespace

// counters: the 14 int64 counters; run: the int32 run flag.
extern "C" int chunk_setup(void* counters, void* run, void* stream) {
  if (counters == nullptr || run == nullptr) return (int)cudaErrorInvalidValue;
  chunk_setup_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)counters, (int32_t*)run);
  return (int)cudaGetLastError();
}
