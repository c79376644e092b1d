// The sharded search loop on the card: kernels consensus, exchange and
// walk_advance (K6s).
//
// Replaces, in mpi_pastar_msa_tpu/parallel/sharded.py, what the JAX
// engine's sharded chunk computes between the route and the insert inside
// its one while_loop a chunk (sig :365 with the loop at :456, packed :621
// at :709, unpacked :796 at :871): :312 _consensus (goal g, f-min with the
// carry ring's, rows selected, overflow), the exchange's sizes of :87
// _route_cap and :169 _route_ragged (:214-:231: the all-gathered send
// counts and the allowance A), the all_to_all that moves the wire rows
// (:148, :231), and the stop test; and the round of :482
// _make_batched_walk's while_loop (:545) that sums the shards' runs and
// moves the coordinate on.  The port's plain versions are
// parallel/sharded.py::consensus_plain, exchange_plain and
// walk_advance_plain.  With these the host reads the card once a chunk of
// the sharded search and once a replay of the walk's rounds, not once a
// step and once a round: every size lives on the device.
//
//   consensus: from the reports of every shard, (7 + ndev + 3) int64 a
//     shard (goal g, table overflow, K3's g max, open, selected, reopened
//     and f-min, then K11's out: send counts, migrants, carry overflow,
//     ring min; gathered, or read where they lie when every shard is on
//     the card), the step's consensus into cons (int64: steps,
//     goal_g, fmin_g, rows selected, table and carry overflow shards, wire
//     rows, migrated rows, peak carry, the run flag; per shard expanded,
//     reopened, open and migrated; A (ndev, ndev)), and into each local
//     shard's step state: ctr[0] = goal_g, state[kFmin] = fmin_g,
//     state[kNSel] = rows selected, state[kNPend] += rows received, the
//     received count and the insert's flag.  On overflow the step stops
//     before the exchange and the insert (their flags 0, no state
//     written); on fmin_g >= goal_g the insert still runs and the next step
//     does not (run = 0).
//   exchange: for every receiver r on this card, A[i][r] rows of sender
//     i's wire (ragged: from row sum_{j<r} A[i][j]; dense: from r cap)
//     into the receiver's pending list, in sender order, ending at row R
//     where its self-owned lanes begin.
//   walk_advance: after every shard's hop-limited walk (path_walk.cu) of a
//     round, the sum of the runs (one shard's is non-zero), its masks
//     appended, the coordinate stepped back, and the walk's flag cleared at
//     the origin or when a round emits nothing.
//
// What bounds them on an H100: latency, not bytes or operations.  The
// consensus reads ndev x 14 words and writes a few dozen (kinase on 4
// shards: 0.6 KB, 0.0002 us at 3.35 TB/s); the exchange moves the rows
// received (kinase: 2,000 to 8,000 rows of 9 words a step, 0.01-0.04 us);
// walk_advance reads ndev x 8 words.  Each is one dependent chain of a few
// loads and stores, so the design is one launch each with every load of a
// launch issued together: the consensus is one block whose threads bring
// the reports and the telemetry into shared memory in one round trip,
// thread 0 computes the consensus there (O(ndev^2) integer operations),
// and all threads write it back; the exchange is a row of kExchangeBlocks
// blocks a receiver, a word a thread (coalesced rows); walk_advance one
// warp, a mask a lane.
// Each returns at once when its flag reads 0, so a CUDA graph of a whole
// chunk (or of a batch of walk rounds) does nothing after the stop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_state.cuh"

namespace {

constexpr int kMaxDev = 32;  // shards a mesh may hold
constexpr int kThreads = 128;
// the report's slots (parallel/sharded.py R_*)
constexpr int rGoal = 0, rOvf = 1, rNOpen = 3, rNSel = 4, rReopen = 5, rFmin = 6, rRoute = 7;
// cons's slots (parallel/sharded.py C_*): the head, then 4 words a shard
// (expanded, reopened, open, migrated), then A
constexpr int qSteps = 0, qGoal = 1, qFmin = 2, qNSel = 3, qTOvf = 4, qCOvf = 5, qWire = 6,
              qMigr = 7, qPeak = 8, qRun = 9, qHead = 10;
constexpr int kRepWords = rRoute + kMaxDev + 3;
constexpr int kTgt = 6;  // a target's words: ctr, state, route out, received, flag, shard
constexpr int kExchangeBlocks = 16;  // blocks a receiver

__global__ void __launch_bounds__(kThreads) consensus_kernel(
    const long long* __restrict__ rep, int ndev, int cap, int ragged, int unpacked, int nb,
    long long f0, long long ccar, int32_t* __restrict__ run, const long long* __restrict__ tgt,
    int n_tgt, long long* __restrict__ cons) {
  __shared__ long long s_rep[kMaxDev * kRepWords];
  __shared__ long long s_cons[qHead + 4 * kMaxDev + kMaxDev * kMaxDev];
  __shared__ long long s_recv[kMaxDev];
  __shared__ long long s_goal, s_fmin, s_nsel;
  __shared__ int s_go, s_stop;
  const int tid = threadIdx.x;
  const int RW = rRoute + ndev + 3;
  const int nc = qHead + 4 * ndev + ndev * ndev;
  if (tid == 0) s_go = *run;
  if (rep != nullptr) {
    for (int k = tid; k < ndev * RW; k += blockDim.x) s_rep[k] = rep[k];
  } else {
    // every shard a target: its report's words where they lie (goal,
    // overflow, K3's five, K11's out)
    for (int k = tid; k < n_tgt * RW; k += blockDim.x) {
      const long long* t = tgt + kTgt * (k / RW);
      const int w = k % RW;
      const long long* ctr = (const long long*)t[0];
      const long long* state = (const long long*)t[1];
      const int32_t* out = (const int32_t*)t[2];
      s_rep[(int)t[5] * RW + w] = w == rGoal  ? ctr[step::cGoal]
                                  : w == rOvf ? ctr[step::cOverflow]
                                  : w < rRoute ? state[w - 2]
                                               : (long long)out[w - rRoute];
    }
  }
  for (int k = tid; k < qHead + 4 * ndev; k += blockDim.x) s_cons[k] = cons[k];
  __syncthreads();
  if (s_go == 0) return;
  if (tid == 0) {
    long long* per = s_cons + qHead;
    long long* A = s_cons + qHead + 4 * ndev;
    long long goal = step::kInf, fmin = 0, nsel = 0, tovf = 0, covf = 0, wire = 0, migr = 0;
    long long peak = s_cons[qPeak];
    for (int i = 0; i < ndev; ++i) {
      const long long* r = s_rep + i * RW;
      const long long* route = r + rRoute;
      const long long ring_min = route[ndev + 2];
      // the carry ring's f keeps its rows in the bound (parallel/sharded.py
      // carry_bound): unpacked rows sort by f itself, packed words by f
      // above their mask bits
      const long long carry_f =
          unpacked ? ring_min : (ring_min < step::kInfp ? (ring_min >> nb) + f0 : step::kInf);
      const long long f = r[rFmin] < carry_f ? r[rFmin] : carry_f;
      goal = i == 0 || r[rGoal] < goal ? r[rGoal] : goal;
      fmin = i == 0 || f < fmin ? f : fmin;
      nsel += r[rNSel];
      tovf += r[rOvf] > 0;
      covf += route[ndev + 1] > 0;
      migr += route[ndev];
      per[4 * i] += r[rNSel];
      per[4 * i + 1] += r[rReopen];
      per[4 * i + 2] = r[rNOpen];
      per[4 * i + 3] += route[ndev];
    }
    for (int j = 0; j < ndev; ++j) s_recv[j] = 0;
    for (int i = 0; i < ndev; ++i) {
      const long long* S = s_rep + i * RW + rRoute;
      long long sent = 0, want = 0;
      for (int j = 0; j < ndev; ++j) {
        long long a;
        if (ragged) {
          // receiver j takes ndev cap rows, senders in order
          long long before = 0;
          for (int k = 0; k < i; ++k) before += s_rep[k * RW + rRoute + j];
          a = (long long)ndev * cap - before;
          a = a < 0 ? 0 : (a > S[j] ? S[j] : a);
        } else {
          a = S[j] < cap ? S[j] : cap;
        }
        A[i * ndev + j] = a;
        s_recv[j] += a;
        sent += a;
        want += S[j];
      }
      wire += sent;
      long long spill = want - sent;
      spill = spill < 0 ? 0 : (spill > ccar ? ccar : spill);
      peak = spill > peak ? spill : peak;
    }
    const int stop = tovf > 0 || covf > 0;
    s_cons[qSteps] += 1;
    s_cons[qGoal] = goal;
    s_cons[qFmin] = fmin;
    s_cons[qNSel] = nsel;
    s_cons[qTOvf] = tovf;
    s_cons[qCOvf] = covf;
    s_cons[qWire] += wire;
    s_cons[qMigr] += migr;
    s_cons[qPeak] = peak;
    s_cons[qRun] = !stop && fmin < goal;
    s_goal = goal;
    s_fmin = fmin;
    s_nsel = nsel;
    s_stop = stop;
  }
  __syncthreads();
  for (int k = tid; k < nc; k += blockDim.x) cons[k] = s_cons[k];
  if (tid < n_tgt) {
    // target: counters, state, the route's out, received count, the
    // insert's flag, shard
    const long long* t = tgt + kTgt * tid;
    long long* ctr = (long long*)t[0];
    long long* state = (long long*)t[1];
    int32_t* recv = (int32_t*)t[3];
    int32_t* go = (int32_t*)t[4];
    const int me = (int)t[5];
    if (s_stop) {
      *go = 0;
    } else {
      ctr[step::cGoal] = s_goal;
      state[step::kFmin] = s_fmin;
      state[step::kNSel] = s_nsel;
      atomicAdd((unsigned long long*)&state[step::kNPend], (unsigned long long)s_recv[me]);
      *recv = (int32_t)s_recv[me];
      *go = 1;
    }
  }
  if (tid == 0) *run = (int32_t)s_cons[qRun];
}

__global__ void __launch_bounds__(256) exchange_kernel(
    const long long* __restrict__ cons, int ndev, int cap, int ragged, int R, int pw,
    const long long* __restrict__ wires, const long long* __restrict__ pends,
    const long long* __restrict__ flags, int n_recv_shards, const long long* __restrict__ recv_me) {
  const int b = blockIdx.x;
  if (b >= n_recv_shards) return;
  if (*(const int32_t*)flags[b] == 0) return;
  const int r = (int)recv_me[b];
  const long long* A = cons + qHead + 4 * ndev;
  long long n_recv = 0;
  for (int i = 0; i < ndev; ++i) n_recv += A[i * ndev + r];
  int32_t* dst = (int32_t*)pends[b] + ((long long)R - n_recv) * pw;
  // the receiver's words split over the gridDim.y blocks of its row
  const long long first = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (int i = 0; i < ndev; ++i) {
    const long long n = A[i * ndev + r];
    long long off = (long long)r * cap;
    if (ragged) {
      off = 0;
      for (int j = 0; j < r; ++j) off += A[i * ndev + j];
    }
    const int32_t* src = (const int32_t*)wires[i] + off * pw;
    for (long long k = first; k < n * pw; k += stride) dst[k] = src[k];
    dst += n * pw;
  }
}

__global__ void walk_advance_kernel(const int32_t* __restrict__ wout, int ndev, int hops, int N,
                                    int32_t* __restrict__ params, int32_t* __restrict__ masks,
                                    int mcap, int32_t* __restrict__ wst,
                                    int32_t* __restrict__ wrun) {
  const int lane = threadIdx.x;
  if (*wrun == 0) return;
  const int width = hops + N + 1;  // a shard's run, stop coordinate and length
  int m = 0;
  if (lane < hops)
    for (int s = 0; s < ndev; ++s) m += wout[(size_t)s * width + lane];
  const bool pos = m > 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, pos);
  const int n = wst[0];
  const int at = n + __popc(ballot & ((1u << lane) - 1u));
  if (pos && at < mcap) masks[at] = m;
  int any = 0;
  for (int d = 0; d < N; ++d) {
    const int dec = __reduce_add_sync(0xffffffffu, pos ? (m >> d) & 1 : 0);
    const int c = params[d] - dec;
    any |= c != 0;
    __syncwarp();  // every lane has read params[d]
    if (lane == 0) params[d] = c;
  }
  if (lane == 0) {
    const int emitted = __popc(ballot);
    wst[0] = n + emitted;
    wst[1] += 1;
    if (emitted == 0 || !any || n + emitted + hops > mcap) *wrun = 0;
  }
}

}  // namespace

// rep: (ndev, 7 + ndev + 3) int64, the gathered reports (the rows of
// parallel/sharded.py::_Shard.report), or null when every shard is a
// target (a mesh of one card): each report is then read where its words
// lie; cap: the exchange cap; ragged: the ragged allowance (else dense);
// unpacked: the ring's min is an f (else a packed word, f = (word >> nb)
// + f0); ccar: the ring's rows; run: the card's int32 run flag (read,
// then written: the next step's); tgt: (n_tgt, 6) int64, each local
// shard's counters, step state, int32 route out (K11's), int32 received
// count, int32 insert flag (pointers) and its index; cons: the int64
// consensus vector (qHead + 4 ndev + ndev^2 words).  One block.
extern "C" int consensus(const void* rep, int ndev, int cap, int ragged, int unpacked, int nb,
                         long long f0, long long ccar, void* run, const void* tgt, int n_tgt,
                         void* cons, void* stream) {
  if (run == nullptr || cons == nullptr || ndev < 1 || ndev > kMaxDev ||
      cap < 1 || nb < 1 || nb > 30 || ccar < 1 || n_tgt < 0 || n_tgt > ndev ||
      (n_tgt > 0 && tgt == nullptr) || (rep == nullptr && n_tgt != ndev))
    return (int)cudaErrorInvalidValue;
  consensus_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)rep, ndev, cap, ragged, unpacked, nb, f0, ccar, (int32_t*)run,
      (const long long*)tgt, n_tgt, (long long*)cons);
  return (int)cudaGetLastError();
}

// cons: the consensus vector (its A); wires: (ndev,) int64 pointers to each
// sender's wire rows, (rows, pw) int32; pends, flags, recv_me: for each of
// the n_recv_shards receivers on this card, its pending list (int32 rows
// of pw words), its insert flag (int32) and its index; R: the received
// region's end, ndev cap.  kExchangeBlocks blocks a receiver.
extern "C" int exchange(const void* cons, int ndev, int cap, int ragged, int R, int pw,
                        const void* wires, const void* pends, const void* flags,
                        int n_recv_shards, const void* recv_me, void* stream) {
  if (cons == nullptr || wires == nullptr || pends == nullptr || flags == nullptr ||
      recv_me == nullptr || ndev < 1 || ndev > kMaxDev || cap < 1 || R < 0 || pw < 1 ||
      n_recv_shards < 1 || n_recv_shards > ndev)
    return (int)cudaErrorInvalidValue;
  exchange_kernel<<<dim3(n_recv_shards, kExchangeBlocks), 256, 0, (cudaStream_t)stream>>>(
      (const long long*)cons, ndev, cap, ragged, R, pw, (const long long*)wires,
      (const long long*)pends, (const long long*)flags, n_recv_shards,
      (const long long*)recv_me);
  return (int)cudaGetLastError();
}

// wout: (ndev, hops + N + 1) int32, each shard's path_walk_hops output;
// params: int32 [coordinate N, key bit widths N] (the coordinate moved on
// in place); masks: (mcap,) int32; wst: int32 [masks emitted, rounds];
// wrun: the walk's int32 flag.  One warp; hops <= 32.
extern "C" int walk_advance(const void* wout, int ndev, int hops, int N, void* params,
                            void* masks, int mcap, void* wst, void* wrun, void* stream) {
  if (wout == nullptr || params == nullptr || masks == nullptr || wst == nullptr ||
      wrun == nullptr || ndev < 1 || hops < 1 || hops > 32 || N < 2 || N > 24 || mcap < hops)
    return (int)cudaErrorInvalidValue;
  walk_advance_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)wout, ndev, hops, N, (int32_t*)params, (int32_t*)masks, mcap,
      (int32_t*)wst, (int32_t*)wrun);
  return (int)cudaGetLastError();
}
