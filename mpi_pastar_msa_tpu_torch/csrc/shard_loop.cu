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
//     ring min; gathered, or read where they lie, on this card or a peer),
//     the step's consensus into cons (int64: steps,
//     goal_g, fmin_g, rows selected, table and carry overflow shards, wire
//     rows, migrated rows, peak carry, the run flag; per shard expanded,
//     reopened, open and migrated; A (ndev, ndev)), and into each local
//     shard's step state: ctr[0] = goal_g, state[kFmin] = fmin_g,
//     state[kNSel] = rows selected, state[kNPend] += rows received, the
//     received count and the insert's flag.  Every card of a mesh runs it
//     on every shard's report (JAX: _consensus runs on every device) and
//     gets the same vector, A and run flag; it writes its own shards'
//     targets.  On overflow the step stops
//     before the exchange and the insert (their flags 0, no state
//     written); on fmin_g >= goal_g the insert still runs and the next step
//     does not (run = 0).
//   exchange: for every receiver r on this card, A[i][r] rows of sender
//     i's wire (on this card, a peer, or another process's card mapped
//     into this one) (ragged: from row sum_{j<r} A[i][j]; dense: from r cap)
//     into the receiver's pending list, in sender order, ending at row R
//     where its self-owned lanes begin.  With `received` the dense rows
//     come from the receiver's own buffer after a fixed-shape all-to-all
//     of the wires (a rank of a ProcessMesh, NCCL's all_to_all_single):
//     sender i's block for it at row i cap.
//   walk_advance: after every shard's hop-limited walk (path_walk.cu) of a
//     round, the sum of the runs (one shard's is non-zero; each read where
//     it lies, on this card or a peer), its masks appended, the card's own
//     copy of the coordinate stepped back, a round counted, and the walk's
//     flag cleared at the origin, when a round emits nothing, or when the
//     masks have no room for another round.
//
// Across the cards of one process the kernels read their peers' buffers
// through device addresses (peer access enabled, UVA over NVLink): no
// collective and no host read sizes the exchange, so one graph of the
// whole mesh's step holds it (parallel/sharded.py).  Two host entries
// serve that mesh: peer_access, and copy_table, the step's gathers as
// copies.  Across processes (a ProcessMesh, one shard a rank) each rank's
// step graph holds the mesh's fixed-shape NCCL collectives instead: the
// gathered reports' rows are read in this rank's buffer; the ragged
// exchange reads every peer's wire where it lies, through a CUDA IPC
// mapping of it into this rank's process (host entries ipc_export,
// ipc_open, ipc_close: plain device addresses to the kernel), the dense
// one copies from the rank's received wire blocks (`received`), every
// size still read on the device.
//
// What bounds them on an H100: latency, not bytes or operations.  The
// consensus reads ndev x 14 words and writes a few dozen (kinase on 4
// shards: 0.6 KB, 0.0002 us at 3.35 TB/s); the exchange moves the rows
// received (kinase: 2,000 to 8,000 rows of 9 words a step, 0.01-0.04 us);
// walk_advance reads ndev x 8 words.  Each is one dependent chain of a few
// loads and stores, so the design is one launch each with every load of a
// launch issued together: the consensus is one warp, a shard a lane, whose
// loads are one round (its targets' addresses ride in the launch's
// parameters), then shuffles and stores, with no barrier; walk_advance
// one warp, a hop and a dimension a lane, whose loads (flag, counts,
// coordinate, runs) are one round after the wait for the round's last
// walk, over whose drain it is launched (a programmatic edge, on one
// card), then ballots and one store an address.  The exchange is a row of
// kExchangeBlocks blocks a receiver whose every address rides in the
// launch's parameters (XTable: the senders' wires, the receivers' pending
// lists, flags and indices), so a block's loads before the copy are its
// flag and A, in one round: warp 0 loads the receiver's column of A and,
// ragged, each sender's row up to it (a sender a lane) beside the flag,
// forms the receiver's ranges with shuffles into shared memory, one
// barrier; then the rows from every sender are one flat range, a row a
// thread, each thread issuing its kExchangeRows rows' loads before its
// stores.
// Each returns at once when its flag reads 0, so a CUDA graph of a step
// (or of a walk round) replayed past the stop does nothing.
#include <climits>
#include <cstring>
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_state.cuh"

namespace {

constexpr int kMaxDev = 32;  // shards a mesh may hold
// the report's slots (parallel/sharded.py R_*)
constexpr int rGoal = 0, rOvf = 1, rNOpen = 3, rNSel = 4, rReopen = 5, rFmin = 6, rRoute = 7;
// cons's slots (parallel/sharded.py C_*): the head, then 4 words a shard
// (expanded, reopened, open, migrated), then A
constexpr int qSteps = 0, qGoal = 1, qFmin = 2, qNSel = 3, qTOvf = 4, qCOvf = 5, qWire = 6,
              qMigr = 7, qPeak = 8, qRun = 9, qHead = 10;
constexpr int kTgt = 5;  // a target's words: ctr, state, received, flag, shard
constexpr int kExchangeBlocks = 16;  // blocks a receiver
constexpr int kExchangeThreads = 256;
constexpr int kExchangeRows = 2;   // a thread's rows whose loads precede its stores
constexpr int kMaxRowWords = 16;   // a wire row: a pending entry, at most W + 5 = 13 words

// Every shard's report, by shard index, where the consensus reads it: a
// row of the gathered reports (int64, rRoute + ndev + 3 words), or its
// counters, step state and route out (K11's) where they lie, on this card
// or on a peer (a copy of them, the several-card mesh's snapshot, or the
// live words on a mesh of one card).  And the targets, this card's shards,
// as the consensus writes them: counters, step state, received count and
// insert flag, null where the shard lies on another card.  Both passed by
// value in the launch's parameters (__grid_constant__: read in place,
// never copied), so a lane reaches its shard's words with one load each
// and no table in device memory.
struct Reports {
  const long long* row[kMaxDev];
  const long long* ctr[kMaxDev];
  const long long* state[kMaxDev];
  const int32_t* out[kMaxDev];
};

struct Targets {
  long long* ctr[kMaxDev];
  long long* state[kMaxDev];
  int32_t* recv[kMaxDev];
  int32_t* go[kMaxDev];
};

constexpr long long kLMax = 0x7FFFFFFFFFFFFFFFLL;  // the identity of a min

// One warp, lane i shard i (ndev <= 32).  Every load of the launch is
// issued first: the run flag, lane i's report (its row, or its shard's
// words, on whichever card they lie) and telemetry, on lane 0 the head's
// running words.  The sums, mins and counts are warp reductions (xor
// butterflies over the ndev lanes, int64 as two 32-bit shuffles; ballots
// for the counts); A[i][j] is lane i's, column j's `before` an exclusive
// scan over the senders (shuffles up) and its column sum one redux.  Lane i
// writes its telemetry, row i of A and shard i's step state, lane 0 the
// head and the run flag: no shared memory and no barrier.
__global__ void __launch_bounds__(32) consensus_kernel(
    const __grid_constant__ Reports rp, int ndev, int cap, int ragged, int unpacked, int nb,
    long long f0, long long ccar, int32_t* __restrict__ run, const __grid_constant__ Targets tg,
    long long* __restrict__ cons) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x;
  const bool mine = lane < ndev;
  const int go = *run;
  long long goal = kLMax, ovf = 0, nopen = 0, nsel = 0, reopen = 0, fmin = kLMax;
  long long migr = 0, covf = 0, ring = 0;
  long long S[kMaxDev];  // row i of the send counts
  long long per[4] = {0, 0, 0, 0};
  if (mine) {
    const long long* r = rp.row[lane];
    if (r != nullptr) {
      goal = r[rGoal];
      ovf = r[rOvf];
      nopen = r[rNOpen];
      nsel = r[rNSel];
      reopen = r[rReopen];
      fmin = r[rFmin];
#pragma unroll
      for (int j = 0; j < kMaxDev; ++j) S[j] = j < ndev ? r[rRoute + j] : 0;
      migr = r[rRoute + ndev];
      covf = r[rRoute + ndev + 1];
      ring = r[rRoute + ndev + 2];
    } else {
      const long long* ctr = rp.ctr[lane];
      const long long* state = rp.state[lane];
      const int32_t* out = rp.out[lane];
      goal = ctr[step::cGoal];
      ovf = ctr[step::cOverflow];
      nopen = state[step::kNOpen];
      nsel = state[step::kNSel];
      reopen = state[step::kReopen];
      fmin = state[step::kFmin];
#pragma unroll
      for (int j = 0; j < kMaxDev; ++j) S[j] = j < ndev ? out[j] : 0;
      migr = out[ndev];
      covf = out[ndev + 1];
      ring = out[ndev + 2];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) per[k] = cons[qHead + 4 * lane + k];
  } else {
#pragma unroll
    for (int j = 0; j < kMaxDev; ++j) S[j] = 0;
  }
  long long steps = 0, wire = 0, migr_all = 0, peak = 0;
  if (lane == 0) {
    steps = cons[qSteps];
    wire = cons[qWire];
    migr_all = cons[qMigr];
    peak = cons[qPeak];
  }
  if (go == 0) return;
  // the allowance: A[i][j] of sender i (this lane) to receiver j, and
  // receiver j's rows on lane j; a sender's counts are >= 0 and each column
  // of A sums to at most ndev cap <= INT_MAX (the C entry checks it)
  const long long ncap = (long long)ndev * cap;
  long long* A = cons + qHead + 4 * ndev + (size_t)lane * ndev;
  long long sent = 0, want = 0, recv = 0;
#pragma unroll
  for (int j = 0; j < kMaxDev; ++j) {
    if (j >= ndev) break;
    const long long s = S[j];
    long long a;
    if (ragged) {
      // receiver j takes ndev cap rows, senders in order
      long long incl = s;
      for (int o = 1; o < ndev; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      a = ncap - (incl - s);
      a = a < 0 ? 0 : (a > s ? s : a);
    } else {
      a = s < cap ? s : cap;
    }
    const long long col = __reduce_add_sync(kFull, (unsigned)a);
    if (lane == j) recv = col;
    if (mine) A[j] = a;
    sent += a;
    want += s;
  }
  // the carry ring's f keeps its rows in the bound (parallel/sharded.py
  // carry_bound): unpacked rows sort by f itself, packed words by f above
  // their mask bits
  if (mine) {
    const long long carry_f =
        unpacked ? ring : (ring < step::kInfp ? (ring >> nb) + f0 : step::kInf);
    fmin = fmin < carry_f ? fmin : carry_f;
  }
  long long spill = want - sent;
  spill = spill < 0 ? 0 : (spill > ccar ? ccar : spill);
  const int tovf = __popc(__ballot_sync(kFull, mine && ovf > 0));
  const int covf_n = __popc(__ballot_sync(kFull, mine && covf > 0));
  long long g = goal, f = fmin, ns = nsel, mg = migr, wr = sent, pk = spill;
  for (int o = 1; o < ndev; o <<= 1) {
    const long long g2 = __shfl_xor_sync(kFull, g, o), f2 = __shfl_xor_sync(kFull, f, o);
    const long long pk2 = __shfl_xor_sync(kFull, pk, o);
    g = g2 < g ? g2 : g;
    f = f2 < f ? f2 : f;
    pk = pk2 > pk ? pk2 : pk;
    ns += __shfl_xor_sync(kFull, ns, o);
    mg += __shfl_xor_sync(kFull, mg, o);
    wr += __shfl_xor_sync(kFull, wr, o);
  }
  const bool stop = tovf > 0 || covf_n > 0;
  const int run_next = !stop && f < g;
  if (mine) {
    long long* p = cons + qHead + 4 * lane;
    p[0] = per[0] + nsel;
    p[1] = per[1] + reopen;
    p[2] = nopen;
    p[3] = per[3] + migr;
    int32_t* go_me = tg.go[lane];
    if (go_me != nullptr) {
      if (stop) {
        *go_me = 0;
      } else {
        long long* state = tg.state[lane];
        tg.ctr[lane][step::cGoal] = g;
        state[step::kFmin] = f;
        state[step::kNSel] = ns;
        atomicAdd((unsigned long long*)&state[step::kNPend], (unsigned long long)recv);
        *tg.recv[lane] = (int32_t)recv;
        *go_me = 1;
      }
    }
  }
  if (lane == 0) {
    cons[qSteps] = steps + 1;
    cons[qGoal] = g;
    cons[qFmin] = f;
    cons[qNSel] = ns;
    cons[qTOvf] = tovf;
    cons[qCOvf] = covf_n;
    cons[qWire] = wire + wr;
    cons[qMigr] = migr_all + mg;
    cons[qPeak] = pk > peak ? pk : peak;
    cons[qRun] = run_next;
    *run = run_next;
  }
}

// A card's exchange, by value in the launch's parameters
// (__grid_constant__: read in place): every sender's wire rows, and for
// each receiver b on this card its pending list, insert flag and shard
// index.
struct XTable {
  const int32_t* wire[kMaxDev];
  int32_t* pend[kMaxDev];
  const int32_t* flag[kMaxDev];
  int me[kMaxDev];
};

__global__ void __launch_bounds__(kExchangeThreads) exchange_kernel(
    const long long* __restrict__ cons, int ndev, int cap, int ragged, int received, int R,
    int pw, const __grid_constant__ XTable x) {
  // s_at[i]: the receiver's rows before sender i's (s_at[ndev]: all of
  // them); s_src[i]: sender i's first row for it in its wire
  __shared__ long long s_at[kMaxDev + 1], s_src[kMaxDev];
  const int b = blockIdx.x;
  const int r = x.me[b];
  // the flag and A in one round: warp 0 issues its A loads before the
  // flag's test
  long long n = 0, off = 0;
  const int i = threadIdx.x;  // warp 0: a sender a lane
  if (i < ndev) {
    // A[i][r] and, ragged, A[i][0 .. r): independent loads
    const long long* row = cons + qHead + 4 * ndev + (long long)i * ndev;
    long long v[kMaxDev];
#pragma unroll
    for (int j = 0; j < kMaxDev; ++j) v[j] = j == r || (ragged && j < r) ? row[j] : 0;
#pragma unroll
    for (int j = 0; j < kMaxDev; ++j) {
      off += j < r ? v[j] : 0;
      n += j == r ? v[j] : 0;
    }
    if (!ragged) off = (long long)(received ? i : r) * cap;
  }
  if (*x.flag[b] == 0) return;  // the whole block
  if (i < 32) {
    long long at = n;  // inclusive prefix over the senders
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, at, o);
      if (i >= o) at += t;
    }
    if (i < ndev) {
      s_at[i + 1] = at;
      s_src[i] = off;
    }
    if (i == 0) s_at[0] = 0;
  }
  __syncthreads();
  // the rows from every sender as one flat range ending at row R: a row a
  // thread, kExchangeRows rows' words loaded before any is stored
  const long long rows = s_at[ndev];
  int32_t* dst = x.pend[b] + ((long long)R - rows) * pw;
  const long long first = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long q0 = first; q0 < rows; q0 += kExchangeRows * stride) {
    int32_t v[kExchangeRows][kMaxRowWords];
#pragma unroll
    for (int u = 0; u < kExchangeRows; ++u) {
      const long long q = q0 + u * stride;
      if (q < rows) {
        int s = 0;  // the sender whose range holds row q
        while (s_at[s + 1] <= q) ++s;
        const int32_t* src = x.wire[s] + (s_src[s] + q - s_at[s]) * pw;
#pragma unroll
        for (int w = 0; w < kMaxRowWords; ++w)
          if (w < pw) v[u][w] = src[w];
      }
    }
#pragma unroll
    for (int u = 0; u < kExchangeRows; ++u) {
      const long long q = q0 + u * stride;
      if (q < rows) {
#pragma unroll
        for (int w = 0; w < kMaxRowWords; ++w)
          if (w < pw) dst[q * pw + w] = v[u][w];
      }
    }
  }
}

// Every shard's run of a walk round, by shard index, where it lies (this
// card or a peer): hops masks, the coordinate it stopped at and the run's
// length (path_walk_hops' output).  By value in the launch's parameters,
// kRuns >= ndev addresses: 4 up to 4 shards, else kMaxDev, so a mesh of
// few shards pays neither the larger parameter block nor the predicated
// loads of the rest (on an H100, kinase on 4 shards: 0.0016 ms a launch
// with 32 addresses, 0.0013 with 4; PERF.md K6s).
template <int kRuns>
struct Runs {
  const int32_t* run[kRuns];
};

constexpr int kMaxWalkN = 24;  // a walk's coordinates: a lane each

// One warp; lane h a hop of every run, lane d dimension d of the
// coordinate (N <= kMaxWalkN < 32).  Every load of the launch is issued
// in one round, after the wait for the kernel before it: the flag, the
// counts, lane d's coordinate and lane h's word of every run (the runs'
// addresses ride in the launch's parameters).  A read of the walk's own
// state before the wait would race the kernel before it wherever that
// one writes the state (a fill, a restore), and issued beside the runs'
// loads it adds no dependent trip.  The masks' places are one ballot and
// a prefix popcount; dimension d's decrement is the popcount of one ballot
// over the positive masks, kept by lane d; each address is stored once.
// With the flag at 0 (a replay after the stop) nothing is stored.
template <int kRuns>
__global__ void __launch_bounds__(32) walk_advance_kernel(
    const __grid_constant__ Runs<kRuns> w, int ndev, int hops, int N,
    int32_t* __restrict__ params, int32_t* __restrict__ masks, int mcap,
    int32_t* __restrict__ wst, int32_t* __restrict__ wrun) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x;
  step::wait_predecessor();  // the programmatic edge from the round's last walk
  const int go = *wrun;
  const int n = wst[0];
  const int rounds = lane == 0 ? wst[1] : 0;
  const int p = lane < N ? params[lane] : 0;
  int v[kRuns];
#pragma unroll
  for (int s = 0; s < kRuns; ++s) v[s] = s < ndev && lane < hops ? w.run[s][lane] : 0;
  int m = 0;
#pragma unroll
  for (int s = 0; s < kRuns; ++s) m += v[s];
  const bool pos = m > 0;
  const unsigned ballot = __ballot_sync(kFull, pos);
  const int emitted = __popc(ballot);
  const int at = n + __popc(ballot & ((1u << lane) - 1u));
  int dec = 0;
#pragma unroll
  for (int d = 0; d < kMaxWalkN; ++d) {
    if (d >= N) break;  // N is the warp's: every lane leaves together
    const int c = __popc(__ballot_sync(kFull, pos && ((m >> d) & 1)));
    if (lane == d) dec = c;
  }
  const int c = p - dec;
  const bool any = __any_sync(kFull, lane < N && c != 0);
  if (go == 0) return;
  if (pos && at < mcap) masks[at] = m;
  if (lane < N) params[lane] = c;
  if (lane == 0) {
    wst[0] = n + emitted;
    wst[1] = rounds + 1;
    if (emitted == 0 || !any || n + emitted + hops > mcap) *wrun = 0;
  }
}

// walk_advance's launch with its runs' table of kRuns addresses (the
// first ndev of t, each checked), over a programmatic edge.
template <int kRuns>
int launch_walk_advance(const long long* t, int ndev, int hops, int N, int32_t* params,
                        int32_t* masks, int mcap, int32_t* wst, int32_t* wrun,
                        cudaStream_t stream) {
  Runs<kRuns> w = {};
  for (int s = 0; s < ndev; ++s) {
    if (!t[s]) return (int)cudaErrorInvalidValue;
    w.run[s] = (const int32_t*)t[s];
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {step::programmatic_edge()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, walk_advance_kernel<kRuns>, w, ndev, hops, N,
                                           params, masks, mcap, wst, wrun);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// rtab: in host memory, ndev rows of rwords int64 addresses, shard i's
// report: rwords 1, its row of 7 + ndev + 3 int64 (the rows of
// parallel/sharded.py::_Shard.report, gathered); rwords 3, its counters,
// step state and int32 route out (K11's), on this card or a peer; cap: the
// exchange cap (ndev cap <= INT_MAX); ragged: the ragged allowance (else
// dense); unpacked: the ring's min is an f (else a packed word, f = (word
// >> nb) + f0); ccar: the ring's rows; run: the card's int32 run flag
// (read, then written: the next step's); tgt: in host memory, (n_tgt, 5)
// int64, each shard of this card's counters, step state, int32 received
// count, int32 insert flag (addresses on this card) and its index; both
// tables copied into the launch's parameters (a graph keeps the copy);
// cons: the int64 consensus vector (qHead + 4 ndev + ndev^2 words).  One
// warp.
extern "C" int consensus(const void* rtab, int rwords, int ndev, int cap, int ragged,
                         int unpacked, int nb, long long f0, long long ccar, void* run,
                         const void* tgt, int n_tgt, void* cons, void* stream) {
  if (run == nullptr || cons == nullptr || rtab == nullptr || (rwords != 1 && rwords != 3) ||
      ndev < 1 || ndev > kMaxDev || cap < 1 || (long long)ndev * cap > INT_MAX || nb < 1 ||
      nb > 30 || ccar < 1 || n_tgt < 0 || n_tgt > ndev || (n_tgt > 0 && tgt == nullptr))
    return (int)cudaErrorInvalidValue;
  Reports rp = {};
  const long long* r = (const long long*)rtab;
  for (int i = 0; i < ndev; ++i, r += rwords) {
    for (int w = 0; w < rwords; ++w)
      if (!r[w]) return (int)cudaErrorInvalidValue;
    if (rwords == 1) {
      rp.row[i] = (const long long*)r[0];
    } else {
      rp.ctr[i] = (const long long*)r[0];
      rp.state[i] = (const long long*)r[1];
      rp.out[i] = (const int32_t*)r[2];
    }
  }
  Targets tg = {};
  const long long* t = (const long long*)tgt;
  for (int k = 0; k < n_tgt; ++k, t += kTgt) {
    const long long me = t[4];
    if (me < 0 || me >= ndev || tg.go[me] != nullptr || !t[0] || !t[1] || !t[2] || !t[3])
      return (int)cudaErrorInvalidValue;
    tg.ctr[me] = (long long*)t[0];
    tg.state[me] = (long long*)t[1];
    tg.recv[me] = (int32_t*)t[2];
    tg.go[me] = (int32_t*)t[3];
  }
  consensus_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(rp, ndev, cap, ragged, unpacked, nb, f0,
                                                       ccar, (int32_t*)run, tg,
                                                       (long long*)cons);
  return (int)cudaGetLastError();
}

// cons: the consensus vector (its A); xtab: in host memory, int64, the
// ndev senders' wire rows ((rows, pw) int32 on the card), then for each of
// the n_recv receivers on this card its pending list (int32 rows of pw
// words), its insert flag (int32) and its shard index (addresses, copied
// into the launch's parameters: a graph keeps the copy); R: the received
// region's end, ndev cap; pw at most kMaxRowWords; received (dense only):
// sender i's rows at row i cap of the wire its entry names (a receiver's
// buffer after the all-to-all), else at row r cap of sender i's own wire.
// kExchangeBlocks blocks a receiver.
extern "C" int exchange(const void* cons, int ndev, int cap, int ragged, int received, int R,
                        int pw, const void* xtab, int n_recv, void* stream) {
  if (cons == nullptr || xtab == nullptr || ndev < 1 || ndev > kMaxDev || cap < 1 || R < 0 ||
      pw < 1 || pw > kMaxRowWords || n_recv < 1 || n_recv > ndev || (ragged && received))
    return (int)cudaErrorInvalidValue;
  XTable x = {};
  const long long* t = (const long long*)xtab;
  for (int i = 0; i < ndev; ++i) {
    if (!t[i]) return (int)cudaErrorInvalidValue;
    x.wire[i] = (const int32_t*)t[i];
  }
  for (int b = 0; b < n_recv; ++b) {
    const long long* e = t + ndev + 3 * b;
    if (!e[0] || !e[1] || e[2] < 0 || e[2] >= ndev) return (int)cudaErrorInvalidValue;
    x.pend[b] = (int32_t*)e[0];
    x.flag[b] = (const int32_t*)e[1];
    x.me[b] = (int)e[2];
  }
  exchange_kernel<<<dim3(n_recv, kExchangeBlocks), kExchangeThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)cons, ndev, cap, ragged, received, R, pw, x);
  return (int)cudaGetLastError();
}

// wtab: in host memory, ndev int64 addresses of each shard's run, hops + N
// + 1 int32 (path_walk_hops' output; on this card or a peer), copied into
// the launch's parameters; params: int32 [coordinate N, key bit widths N]
// (the coordinate moved on in place); masks: (mcap,) int32; wst: int32
// [masks emitted, rounds]; wrun: the walk's int32 flag; all four this
// card's own.  One warp; hops <= 32, N <= kMaxWalkN.  Launched over a
// programmatic edge from the kernel before it on the stream (the round's
// last path_walk_hops, which triggers nothing early): the launch overlaps
// that kernel's drain, and the kernel waits for it before its first load
// (step::wait_predecessor), so it is correct under any predecessor on
// this card.  A graph captures the edge from each kernel it follows; a
// copy before it (the rank form's sum into wsum) keeps a full edge.  No
// CUDA document says that griddepcontrol.wait orders another card's
// grid, so where the runs of the round come from other cards the caller
// makes the capture's dependency an empty node after them
// (utils/graph.py::join_full): a full edge.
extern "C" int walk_advance(const void* wtab, int ndev, int hops, int N, void* params,
                            void* masks, int mcap, void* wst, void* wrun, void* stream) {
  if (wtab == nullptr || params == nullptr || masks == nullptr || wst == nullptr ||
      wrun == nullptr || ndev < 1 || ndev > kMaxDev || hops < 1 || hops > 32 || N < 2 ||
      N > kMaxWalkN || mcap < hops)
    return (int)cudaErrorInvalidValue;
  const long long* t = (const long long*)wtab;
  auto go = [&](auto launch) {
    return launch(t, ndev, hops, N, (int32_t*)params, (int32_t*)masks, mcap, (int32_t*)wst,
                  (int32_t*)wrun, (cudaStream_t)stream);
  };
  return ndev <= 4 ? go(launch_walk_advance<4>) : go(launch_walk_advance<kMaxDev>);
}

// Host entries of a mesh across the cards of one process (no kernel).
//
// peer_access: card dev may read and write card peer's memory (UVA over
// NVLink): cudaDeviceEnablePeerAccess from dev; access already enabled is
// no error (and leaves none behind).  The current card is restored.
extern "C" int peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}

// Host entries of a mesh across processes (no kernel): a buffer's CUDA IPC
// handle, and its mapping into another process.
//
// ipc_export: the IPC handle (kIpcHandleBytes, into handle) of the device
// allocation that holds ptr, and ptr's byte offset in it: the caching
// allocator hands out blocks inside larger allocations, and a handle
// names a whole allocation.  The allocation's base comes from the
// driver's cuMemGetAddressRange, reached through the runtime (no link to
// the driver library).  Memory the handles cannot name (PyTorch's
// expandable segments, cuMemCreate's mappings) fails in
// cudaIpcGetMemHandle and returns its error.
constexpr int kIpcHandleBytes = 64;
static_assert(sizeof(cudaIpcMemHandle_t) == kIpcHandleBytes, "CUDA IPC handle size");
typedef int (*AddressRange)(unsigned long long* base, size_t* size, unsigned long long ptr);

extern "C" int ipc_export(const void* ptr, void* handle, long long* offset) {
  if (ptr == nullptr || handle == nullptr || offset == nullptr)
    return (int)cudaErrorInvalidValue;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion("cuMemGetAddressRange", &fn, 12000,
                                                   cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuMemGetAddressRange", &fn, cudaEnableDefault,
                                          &found);
#endif
  if (e != cudaSuccess) return (int)e;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return (int)cudaErrorSymbolNotFound;
  unsigned long long base = 0;
  size_t size = 0;
  if (((AddressRange)fn)(&base, &size, (unsigned long long)ptr) != 0)
    return (int)cudaErrorInvalidValue;
  cudaIpcMemHandle_t h;
  if ((e = cudaIpcGetMemHandle(&h, (void*)base)) != cudaSuccess) return (int)e;
  memcpy(handle, &h, sizeof h);
  *offset = (long long)((unsigned long long)ptr - base);
  return 0;
}

// ipc_open: another process's allocation (its handle, from ipc_export)
// mapped into this one on the current card, its base into *base; the
// current card reaches a peer card's memory with peer access enabled
// lazily.  A handle of this process's own memory fails.
extern "C" int ipc_open(const void* handle, void** base) {
  if (handle == nullptr || base == nullptr) return (int)cudaErrorInvalidValue;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
}

// ipc_close: unmaps a base that ipc_open returned.
extern "C" int ipc_close(void* base) {
  if (base == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaIpcCloseMemHandle(base);
}

// copy_table: n device-to-device copies on stream, in order: tab in host
// memory, n rows of int64 (destination, source, bytes), any card of the
// process (a peer copy where they differ); the gathers of the several-card
// step (parallel/sharded.py::_Card), captured into its graph as copy nodes.
extern "C" int copy_table(const void* tab, int n, void* stream) {
  if (tab == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  const long long* t = (const long long*)tab;
  for (int k = 0; k < n; ++k, t += 3) {
    if (!t[0] || !t[1] || t[2] < 0) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaMemcpyAsync((void*)t[0], (const void*)t[1], (size_t)t[2],
                                          cudaMemcpyDefault, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
