// Expansion of the selected rows of a key-row table (the packed and the
// unpacked layouts), and on the packed layout the round-0 row match of the
// insert: kernel K9.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :497 _expand with g
// given (packed) and with pathmax (unpacked), :1720 _candidates_packed,
// :348 _pack_keys, :360 _hash_keys and the round-0 match of :1262
// _insert_core_packed (XLA inside the run loops :1819 and :1999).  The
// port's plain versions are search/engine.py::_select_packed's and
// _select's row reads, _expand, the prune, _candidates_packed /
// _candidates_unpacked, _pack_keys, _hash_keys and round 0 of
// _probe_claim.  For each active row of the selection (K3's compact list:
// slot, word) and each move mask m = 1 .. 2^N - 1, the edge cost and h of
// expand_row.cuh (shared with K4) and
//   packed:   coord from the row's key words, g = f(word) - h (column W)
//   unpacked: coord from the row's key words, g = t_g[slot], the parent
//             mask and the parent's f from t_fpar[slot]
//   g_child = g + cost, f_child = g_child + h, on the unpacked layout
//   raised to at least the parent's f (pathmax).
// valid = child <= final; the goal is found BEFORE the upper-bound prune
// (atomicMin on the counters' slot 0), then valid &= f_child <= ub.  Every
// surviving lane counts in state[kNValid].  On the packed layout it reads
// its home probe row probe_slot(h0, 0) as the insert's round 0 does (the
// row as it stood before any write of round 0: the insert, K10, has not
// run yet): a row that holds its key settles it here, by atomicMin of its
// packed word into t_best (nothing reads t_best during the insert).  Every
// other surviving lane (on the unpacked layout every one: a matched lane
// must join the insert's decrease-key on the grid) appends one entry to
// the pending list of the insert (keyrow_insert.cu, K10), its place
// counted in state[kNPend]: its key words, their hash, its claim tag, then
//   packed:   h (= f - g, no pathmax) and the packed word ((f - f0) << n) | m
//   unpacked: g and f * 2^n + m (two words, low first).
// The claim tag is the lane's content tag row_rank * M + m - 1 (row_rank:
// the row's place in K3's list, which is group order): the plain step's
// tag (search/engine.py::_expand_insert), the same whatever order the
// lanes reach the list in.  A matched lane never claims, so the claims,
// and the table, are the plain step's.
//
// What bounds it on an H100: integer work where M is large, else a chain
// of dependent loads.  Per mask, P + T lookup-adds (synth10: 1023 masks x
// (45 + T) a row); per active row its list entry, its key row (and t_g,
// t_fpar), P T8 rows of 32 B and T x 8 cube corners gathered at random,
// then per surviving lane its home row read (packed) and its pending entry
// (W + 4 or W + 5 words) written.
//
// Design: a block a row (search/step.py::k9_launch_shape).  The block has
// min(256, M rounded up to a warp) threads, one warp at M <= 31, and takes
// the row's masks in passes of its size (synth10: 256 threads, 4 passes);
// the grid is a block a listed row up to what the card holds at once (64
// registers a thread: 1024 / threads blocks a multiprocessor, at most 16),
// and its blocks stride over K3's list.  A row is staged once, behind one
// __syncthreads: every thread reads the row (key words, g, parent mask)
// itself, and the block builds the row's term tables (expand_row.cuh
// pair_terms: 4P int64 pairs, from the P T8 rows) and its 8T cube corners
// in shared memory, a thread an entry, up to kStage entries a thread with
// their loads issued together.  A mask's cost and h are then P
// lookups and int64 adds and T corners: no multiply in the mask loop.
// Validity and the goal test are two masks of the row (the dimensions
// that may still move, the mask that reaches the final coordinate).  A
// pass reserves its pending places with one atomicAdd on kNPend for the
// block (warp ballots, a count a warp in shared memory, two
// __syncthreads); kNValid takes one atomicAdd a block.
//
// The sharded instantiation (C entry keyrow_expand_sharded, K9s: the
// multi-device step of parallel/sharded.py on key rows, JAX :645-671 in
// _make_sharded_run_packed and :812-838 in _make_sharded_run) is the same
// kernel with four changes, as sig_expand.cu's is of K4:
//   - with sharded cubes (packed only: the unpacked step reads the whole
//     stack), h3 (B, M + 1) int32 from tri_partial.cu (K12) after the
//     mesh's reduce-scatter, row i of the compact list, stands in for the
//     cube reads: child m adds h3[i][m - 1] (the packed row's g comes from
//     its stored h, so the row's own column M is not read);
//   - each surviving lane's owner shard comes from its child coordinate
//     (owner.cuh, parallel/partition.py); only a self-owned lane is
//     matched in its home row (packed) or goes to the pending list, given
//     at the caller's offset (the received rows go in front of it);
//   - every lane of a listed row writes its candidate row at i M + m - 1
//     of `cand` for route_pack.cu (K11, route_pack_rows): (dest, fsort,
//     the pending entry), fsort the packed word (unpacked: f), dest the
//     owner for a lane owned elsewhere, else the empty row (ndev, INFP or
//     INF, key words -1, the rest 0);
//   - a lane's claim tag is tag_base + i M + m - 1, tag_base = ndev x the
//     exchange cap: the rows a shard receives claim with their places in
//     the received region, 0 .. tag_base - 1 (keyrow_insert.cu's
//     keyrow_insert_recv), so every tag of an insert is unique and none
//     depends on the order in which the lanes arrive.
// The round-0 match may settle self-owned lanes only; it stays right
// because round 0 reads the table as it stood before any of its writes and
// nothing reads t_best during the insert.  The unsharded instantiation
// compiles none of it.

#include "expand_row.cuh"
#include "owner.cuh"
#include "step_state.cuh"

namespace {

constexpr int kMaxThreads = 256;  // search/step.py K9_MAX_THREADS
constexpr int kMaxWarps = kMaxThreads / 32;
// blocks of kMaxThreads resident a multiprocessor: at most 64 registers a
// thread, so the grid of k9_launch_shape (up to 1024 / threads blocks a
// multiprocessor) is resident at once
constexpr int kMinBlocks = 4;
constexpr int kMaxW = 8;  // key words of N <= 16 coordinates
// staged entries a thread (constants, term tables, corners) whose loads are
// issued together: one round trip, not one an entry (N <= 7 needs at most
// 4 a thread at its block size)
constexpr int kStage = 4;
constexpr unsigned kFull = 0xffffffffu;

// What the sharded instantiation adds (null h3: the shard reads its cubes).
struct Sharded {
  const int32_t* h3;
  int32_t* cand;
  int CW;  // a candidate row's words: 2 + the pending entry's
  owner::Hash hash;
  int ndev, me, tag_base;
};

// Shared memory of a block: the term tables (4P longlong2), then the
// constants (expand_row.cuh const_words), then the cube corners (8T).
__host__ __device__ __forceinline__ size_t shared_bytes(int N, int P, int T) {
  return sizeof(longlong2) * 4 * (size_t)P +
         sizeof(int32_t) * ((size_t)expand::const_words(N, P, T) + 8 * (size_t)T);
}

// The places of this pass's pending lanes: one atomicAdd on kNPend for the
// block (a block of one warp: its ballot, no barrier).  `cnt` holds two
// buffers of a count a warp (by pass parity: a warp may write the next
// pass's count while another still reads this one's).
__device__ __forceinline__ int block_place(bool pending, int (*cnt)[kMaxWarps], int* base,
                                           int buf, long long* state) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned ballot = __ballot_sync(kFull, pending);
  const int below = __popc(ballot & ((1u << lane) - 1u));
  if (blockDim.x == 32) {  // a warp a row: its ballot is the block's
    int at = 0;
    if (lane == 0 && ballot != 0)
      at = (int)atomicAdd((unsigned long long*)&state[step::kNPend],
                          (unsigned long long)__popc(ballot));
    return __shfl_sync(kFull, at, 0) + below;
  }
  if (lane == 0) cnt[buf][warp] = __popc(ballot);
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += cnt[buf][w];
    *base = total ? (int)atomicAdd((unsigned long long*)&state[step::kNPend],
                                   (unsigned long long)total)
                  : 0;
  }
  __syncthreads();
  int at = *base;
  for (int w = 0; w < warp; ++w) at += cnt[buf][w];
  return at + below;
}

template <bool kUnpacked, bool kSharded>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) keyrow_expand_kernel(
    const int32_t* __restrict__ t_key, int KWs, const int32_t* __restrict__ t_g,
    const long long* __restrict__ t_fpar, int32_t* __restrict__ t_best, uint32_t Cmask,
    const int32_t* __restrict__ sel, const int32_t* __restrict__ tables4,
    const int32_t* __restrict__ cubes, const int32_t* __restrict__ params, int N, int P, int T,
    int S, int nb, long long f0, long long ub, int E, int GG, int gap_oe,
    const int32_t* __restrict__ run, long long* __restrict__ counters,
    long long* __restrict__ state, int32_t* __restrict__ pend, Sharded sh) {
  extern __shared__ longlong2 s_term[];
  __shared__ int s_cnt[2][kMaxWarps];
  __shared__ int s_base;
  __shared__ unsigned long long s_valid;
  step::wait_predecessor();  // the programmatic edge from K3
  if (*run == 0) return;
  const long long n_rows = state[step::kNSel];
  if ((long long)blockIdx.x >= n_rows) return;  // the whole block: no row

  int32_t* sm = reinterpret_cast<int32_t*>(s_term + 4 * P);
  const int n_const = expand::const_words(N, P, T);
  expand::Consts k = expand::consts_at(sm, N, P, T, S);
  if constexpr (kSharded)
    if (sh.h3 != nullptr) k.T = 0;  // h3 stands in for the cube reads
  int32_t* s_cube = sm + n_const;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int q0 = 0; q0 < n_const; q0 += kStage * blockDim.x) {  // loads first
    int32_t v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int q = q0 + j * blockDim.x + tid;
      v[j] = q < n_const ? params[q] : 0;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int q = q0 + j * blockDim.x + tid;
      if (q < n_const) sm[q] = v[j];
    }
  }
  if (tid == 0) s_valid = 0;
  __syncthreads();

  const int W = (N + 1) / 2;
  const int PW = W + (kUnpacked ? 5 : 4);  // pending words a lane
  const int M = (1 << N) - 1;
  const int passes = (M + blockDim.x - 1) / blockDim.x;
  const size_t SS = (size_t)S * S;
  uint32_t n_valid = 0;
  int pass = 0;  // passes run, for block_place's buffers
  for (long long i = blockIdx.x; i < n_rows; i += gridDim.x) {
    // 1. the row, read by every thread: key words, g, the parent mask
    const int2 e = reinterpret_cast<const int2*>(sel)[i];
    const int32_t* row = t_key + (size_t)e.x * KWs;
    uint32_t kw[kMaxW];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) kw[w] = w < W ? (uint32_t)row[w] : 0u;
    long long g, f_par = 0;
    int par;
    if constexpr (kUnpacked) {
      const long long fp = t_fpar[e.x];
      g = t_g[e.x];
      par = (int)(fp & ((1ll << nb) - 1));
      f_par = fp >> nb;
    } else {
      g = (long long)(e.y >> nb) + f0 - row[W];
      par = e.y & ((1 << nb) - 1);
    }
    // validity: child <= final needs coord <= final where a bit is 0 and
    // coord < final where it is 1; the goal is the one mask that lands on
    // final (none unless every coordinate is final or one short of it)
    uint32_t room = 0, short1 = 0;
    bool fits = true, near = true;
#pragma unroll
    for (int d = 0; d < 2 * kMaxW; ++d) {
      if (d < N) {
        const int c = (int)((kw[d >> 1] >> (16 * (d & 1))) & 0xFFFFu), f = k.final_c[d];
        fits &= c <= f;
        room |= (uint32_t)(c < f) << d;
        short1 |= (uint32_t)(c + 1 == f) << d;
        near &= c == f || c + 1 == f;
      }
    }
    const int goal_m = near ? (int)short1 : -1;

    // 2. the row's term tables and cube corners, a thread an entry, each
    // thread's loads issued before any is used (the last row's lookups are
    // done: its last block_place synced the block)
    auto coord = [&](int d) {  // from the row in L1, not a dynamically indexed kw
      return min(max((int)(((uint32_t)row[d >> 1] >> (16 * (d & 1))) & 0xFFFFu), 0), S - 2);
    };
    const int items = 4 * P + 8 * k.T;
    for (int q0 = 0; q0 < items; q0 += kStage * blockDim.x) {
      int32_t a[kStage] = {}, b[kStage] = {};  // a T8 cell and the residue cost, or a corner
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int q = q0 + j * blockDim.x + tid;
        if (q < 4 * P) {
          const int p = q >> 2;
          const int32_t* t8 = tables4 + ((size_t)p * SS + (size_t)coord(k.xs[p]) * S +
                                         coord(k.ys[p])) * 8;
          a[j] = t8[q & 3];
          b[j] = t8[4];
        } else if (q < items) {
          const int r = q - 4 * P, t = r >> 3;
          const int cx = coord(k.tri[3 * t]) + ((r >> 2) & 1);
          const int cy = coord(k.tri[3 * t + 1]) + ((r >> 1) & 1);
          const int cz = coord(k.tri[3 * t + 2]) + (r & 1);
          a[j] = cubes[(size_t)t * SS * S + ((size_t)cx * S + cy) * S + cz];
        }
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int q = q0 + j * blockDim.x + tid;
        if (q < 4 * P)
          s_term[q] = expand::pair_terms(k, q >> 2, q & 3, par, E, GG, gap_oe, a[j], b[j]);
        else if (q < items)
          s_cube[q - 4 * P] = a[j];
      }
    }
    __syncthreads();

    // 3. the masks, a thread a mask, passes of blockDim.x
    const int32_t* h3_row = nullptr;
    if constexpr (kSharded)
      if (sh.h3 != nullptr) h3_row = sh.h3 + i * (M + 1);
    for (int ps = 0; ps < passes; ++ps, ++pass) {
      const int m = 1 + ps * (int)blockDim.x + tid;
      bool valid = m <= M && fits && (m & ~(int)room) == 0;
      long long h = 0, gc = 0, fc = 0;
      if (valid) {
        long long cost;
        expand::child_cost_h_terms(k, m, s_term, s_cube, cost, h);
        if constexpr (kSharded)
          if (h3_row != nullptr) h += h3_row[m - 1];
        gc = g + cost;
        fc = gc + h;
        if constexpr (kUnpacked) fc = fc > f_par ? fc : f_par;  // pathmax
        if (m == goal_m) atomicMin(&counters[step::cGoal], gc);  // before the prune
        valid = fc <= ub;
      }
      n_valid += valid;
      uint32_t words[kMaxW];
      uint32_t h0 = 0;
      bool pending = valid;
      int dest = 0;  // the owner of a lane owned elsewhere, else ndev
      if constexpr (kSharded) dest = sh.ndev;
      if (valid) {
        // the child's key words: the row's plus the move bits (a valid
        // child's coordinates are at most final < 2^16: no carry)
#pragma unroll
        for (int w = 0; w < kMaxW; ++w)
          words[w] = kw[w] + ((uint32_t)(m >> (2 * w)) & 1u) +
                     (((uint32_t)(m >> (2 * w + 1)) & 1u) << 16);
        h0 = step::hash_keys(words, W);
        if constexpr (kSharded) {
          int32_t child[2 * kMaxW];
#pragma unroll
          for (int d = 0; d < 2 * kMaxW; ++d)
            child[d] = (int32_t)((words[d >> 1] >> (16 * (d & 1))) & 0xFFFFu);
          const int o = owner::of(sh.hash, child, N);
          if (o != sh.me) {
            dest = o;
            pending = false;  // it rides the route, not this shard's insert
          }
        }
        if (pending && !kUnpacked) {
          // round 0 of the insert: the home row holds the key -> settled
          const uint32_t at = step::probe_slot(h0, 0, Cmask);
          const int32_t* hr = t_key + (size_t)at * KWs;
          int32_t hw[kMaxW];
#pragma unroll
          for (int w = 0; w < kMaxW; ++w) hw[w] = w < W ? hr[w] : 0;
          bool eq = hw[0] != -1;
#pragma unroll
          for (int w = 0; w < kMaxW; ++w)
            if (w < W) eq &= hw[w] == (int32_t)words[w];
          if (eq) {
            atomicMin(&t_best[at], (int32_t)(((fc - f0) << nb) | m));
            pending = false;
          }
        }
      }
      // a lane's pending entry: key words, hash, claim tag, then (packed)
      // h and the packed word, or (unpacked) g and f * 2^n + m
      auto entry = [&](int32_t* out) {
        for (int w = 0; w < W; ++w) out[w] = (int32_t)words[w];
        out[W] = (int32_t)h0;
        int tag = (int)(i * M + m - 1);  // the content tag
        if constexpr (kSharded) tag += sh.tag_base;
        out[W + 1] = tag;
        if constexpr (kUnpacked) {
          const long long fpar = fc * (1ll << nb) + m;
          out[W + 2] = (int32_t)gc;
          out[W + 3] = (int32_t)(uint32_t)(unsigned long long)fpar;
          out[W + 4] = (int32_t)(fpar >> 32);
        } else {
          out[W + 2] = (int32_t)h;
          out[W + 3] = (int32_t)(((fc - f0) << nb) | m);
        }
      };
      if constexpr (kSharded)
        if (m <= M) {
          int32_t* row = sh.cand + (size_t)(i * M + m - 1) * sh.CW;
          if (dest < sh.ndev) {
            row[0] = dest;
            row[1] = kUnpacked ? (int32_t)fc : (int32_t)(((fc - f0) << nb) | m);
            entry(row + 2);
          } else {  // the empty row
            row[0] = sh.ndev;
            row[1] = kUnpacked ? (int32_t)step::kInf : (int32_t)step::kInfp;
            for (int w = 2; w < sh.CW; ++w) row[w] = w < 2 + W ? -1 : 0;
          }
        }
      const int at = block_place(pending, s_cnt, &s_base, pass & 1, state);
      if (pending) entry(pend + (size_t)at * PW);
    }
  }
  // 4. the surviving lanes: one atomic a block
  n_valid = __reduce_add_sync(kFull, n_valid);
  if (blockDim.x == 32) {
    if (lane == 0 && n_valid != 0)
      atomicAdd((unsigned long long*)&state[step::kNValid], (unsigned long long)n_valid);
    return;
  }
  if (lane == 0 && n_valid != 0) atomicAdd(&s_valid, (unsigned long long)n_valid);
  __syncthreads();
  if (tid == 0 && s_valid != 0)
    atomicAdd((unsigned long long*)&state[step::kNValid], s_valid);
}

template <bool kUnpacked, bool kSharded>
int launch(const void* t_key, int KWs, const void* t_g, const void* t_fpar, void* t_best,
           uint32_t Cmask, const void* sel, const void* tables4, const void* cubes,
           const void* params, int N, int P, int T, int S, int nb, long long f0, long long ub,
           int E, int GG, int gap_oe, int blocks, int threads, const void* run, void* counters,
           void* state, void* pend, Sharded sh, void* stream) {
  const size_t shared = shared_bytes(N, P, T);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1] = {step::programmatic_edge()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, keyrow_expand_kernel<kUnpacked, kSharded>, (const int32_t*)t_key, KWs,
      (const int32_t*)t_g, (const long long*)t_fpar, (int32_t*)t_best, Cmask,
      (const int32_t*)sel, (const int32_t*)tables4, (const int32_t*)cubes,
      (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, (const int32_t*)run,
      (long long*)counters, (long long*)state, (int32_t*)pend, sh);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The checks of both C entries (h3: the sharded entry's, null otherwise).
bool bad_args(int KWs, const void* t_g, const void* t_fpar, const void* t_best, int C,
              int unpacked, const void* cubes, const void* h3, int N, int P, int T, int S,
              int nb, int B, int blocks, int threads) {
  const int W = (N + 1) / 2;
  return N < 2 || N > 2 * kMaxW || P != N * (N - 1) / 2 || T < 0 ||
         (T > 0 && cubes == nullptr && h3 == nullptr) || S < 2 || nb != N || B < 1 ||
         KWs != W + (unpacked ? 0 : 1) || C < 2 || (C & (C - 1)) != 0 ||
         (unpacked ? (t_g == nullptr || t_fpar == nullptr) : t_best == nullptr) || blocks < 1 ||
         threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
         (long long)B * ((1ll << N) - 1) >= (1ll << 31);
}

}  // namespace

// t_key: (>= C, KWs) int32 key rows (packed: KWs = W + 1, the last column
// h; unpacked: KWs = W); t_g, t_fpar: the unpacked table's (null when
// packed); t_best: the packed table's (null when unpacked); C: the table's
// size, a power of two; unpacked: 0 packed, 1 unpacked; sel: K3's compact
// list (slot, word) as (>= B, 2) int32, its length in state[kNSel];
// params: as K4's (search/step.py::_kernel_params); blocks, threads: the
// launch shape (search/step.py::k9_launch_shape; threads a multiple of 32,
// at most kMaxThreads); run: int32 device flag; counters: the 14 int64
// counters; state: step_state.cuh (kNValid counts the surviving lanes,
// kNPend the pending ones); pend: (B * (2^N - 1), W + 4 or W + 5) int32
// pending list.  B bounds the list: at most B rows are active.  Every
// launch carries a programmatic edge from the kernel before it (K3 in a
// chunk step, search/step.py): the kernel waits for it first thing.
extern "C" int keyrow_expand(const void* t_key, int KWs, const void* t_g, const void* t_fpar,
                             void* t_best, int C, int unpacked, const void* sel,
                             const void* tables4, const void* cubes, const void* params, int N,
                             int P, int T, int S, int nb, long long f0, long long ub, int E,
                             int GG, int gap_oe, int B, int blocks, int threads,
                             const void* run, void* counters, void* state, void* pend,
                             void* stream) {
  if (bad_args(KWs, t_g, t_fpar, t_best, C, unpacked, cubes, nullptr, N, P, T, S, nb, B, blocks,
               threads))
    return (int)cudaErrorInvalidValue;
  const uint32_t Cmask = (uint32_t)(C - 1);
  return unpacked ? launch<true, false>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                        cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe,
                                        blocks, threads, run, counters, state, pend, Sharded{},
                                        stream)
                  : launch<false, false>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                         cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe,
                                         blocks, threads, run, counters, state, pend, Sharded{},
                                         stream);
}

// The sharded instantiation: keyrow_expand's arguments, then h3 ((B, M + 1)
// int32, packed only, or null: the shard reads its cubes, non-null when T >
// 0), cand ((B M, CW) int32), CW (2 + the pending entry's words), the owner
// hash (kind, size, shift, zbits: parallel/partition.py::owner_params),
// ndev (= the hash's size), this shard's index me and tag_base (the
// self-owned lanes' first claim tag, tag_base + B M < 2^31); pend points
// where the self-owned pending lanes go.
extern "C" int keyrow_expand_sharded(const void* t_key, int KWs, const void* t_g,
                                     const void* t_fpar, void* t_best, int C, int unpacked,
                                     const void* sel, const void* tables4, const void* cubes,
                                     const void* params, int N, int P, int T, int S, int nb,
                                     long long f0, long long ub, int E, int GG, int gap_oe, int B,
                                     int blocks, int threads, const void* run, void* counters,
                                     void* state, void* pend, const void* h3, void* cand, int CW,
                                     int hash_kind, int hash_size, int hash_shift, int zbits,
                                     int ndev, int me, int tag_base, void* stream) {
  const int W = (N + 1) / 2;
  if (bad_args(KWs, t_g, t_fpar, t_best, C, unpacked, cubes, h3, N, P, T, S, nb, B, blocks,
               threads) ||
      cand == nullptr || CW != 2 + W + (unpacked ? 5 : 4) || (unpacked && h3 != nullptr) ||
      ndev < 1 || me < 0 || me >= ndev || hash_size != ndev || hash_kind < 0 || hash_kind > 3 ||
      hash_shift < 0 || hash_shift > 31 || zbits < 1 || zbits > 32 || tag_base < 0 ||
      (long long)tag_base + (long long)B * ((1ll << N) - 1) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Sharded sh{(const int32_t*)h3, (int32_t*)cand, CW,
                   owner::Hash{hash_kind, hash_size, hash_shift, zbits}, ndev, me, tag_base};
  const uint32_t Cmask = (uint32_t)(C - 1);
  return unpacked ? launch<true, true>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                       cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe,
                                       blocks, threads, run, counters, state, pend, sh, stream)
                  : launch<false, true>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                        cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe,
                                        blocks, threads, run, counters, state, pend, sh, stream);
}
