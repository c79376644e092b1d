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
//
// K9s's rows form (keyrow_expand_rows_kernel): the sharded step's rows
// have M <= 31 masks (kinase: 31, 508 rows a shard at step 200), and the
// block form spends them a warp a block in a chain of about nine
// dependent steps (the K9S_PHASES split: the flag, then kNSel, params
// staged behind a block barrier, the list entry, then the key row, the T8
// rows, h3 inside the masks, the home row, the place atomic: 508
// returning atomics on one address, 508 more on kNValid).  The rows form
// gives a row a warp, a lane a mask, and R = blockDim.x / 32 rows a block
// (search/step.py::k9s_launch_shape, K9S_ROWS; the C entry's rows, 0 the
// block form, which N >= 6 keeps).  Three rounds of loads: the flag,
// kNSel, the list entry and the row's h3 words; the key row; each child's
// home row (read before the prune) with the T8 rows and cube corners.
// With one warp or two to a multiprocessor's scheduler, the kernel is
// bound by its instruction stream as much as by these rounds, so what is
// the same for every row is worked out once on the host
// (search/step.py::k9s_mask_codes: each mask's lookups in the term tables
// and corners, two words at the end of params), the hash and the owner
// take register arrays with constant indices, the pair terms are
// pair_terms's four cases multiplied out, the term tables are padded with
// zero entries (a mask's ten lookups with no branch), the candidate rows
// are staged at their destination's 16-byte phase and stored in int4
// chunks, and the block's one returning atomicAdd on kNPend is issued
// before those stores and read after them (kNValid's after the pending
// entries).  It writes every word the block form writes; the pending
// entries keep their multiset, not their order.

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

// Built with -DK9S_PHASES (a measurement build of chip_smoke.py, never the
// one the port loads), the sharded forms leave %globaltimer readings (ns)
// of the launches since the last read, which keyrow_expand_phases reads
// and resets: [0] the first block's start (a min over blocks), [1] the
// last block's end (a max), then block 0's thread 0 (row 0): [2] its
// start, [3] past wait_predecessor, [4] the prologue's reads (the flag,
// kNSel, and params staged in the block form; the list entry and h3 in
// the rows form), [5] the key row (the block form: the list entry, then
// it), [6] the T8 rows and corners staged (the rows form: with the home
// rows), [7] the masks, [8] the home-row probe, [9] the candidate rows
// staged in shared memory (the rows form; the block form has no stage),
// [10] the candidate rows stored, [11] the place atomic returned, [12] the
// pending entries stored, [13] the tail atomics done.  A reading waits for
// the values the step before it loaded (k9s_clock's dependency).
constexpr int kK9sStamps = 14;
#ifdef K9S_PHASES
__device__ unsigned long long g_k9s[kK9sStamps];
__device__ __forceinline__ unsigned long long k9s_clock(uint32_t dep) {
  unsigned long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, 0x7fffffff;\n\t"
      "@p mov.u64 %0, %%globaltimer;\n\t@!p mov.u64 %0, %%globaltimer;\n\t}"
      : "=l"(t)
      : "r"(dep)
      : "memory");
  return t;
}
#define K9S_MARK(k, dep)                                                  \
  do {                                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_k9s[k] = k9s_clock((uint32_t)(dep)); \
  } while (0)
#define K9S_EDGE(k, dep)                                                  \
  do {                                                                    \
    if (threadIdx.x == 0) {                                               \
      const unsigned long long t_ = k9s_clock((uint32_t)(dep));           \
      if (k == 0) atomicMin(&g_k9s[0], t_); else atomicMax(&g_k9s[1], t_); \
    }                                                                     \
  } while (0)
#else
#define K9S_MARK(k, dep) ((void)0)
#define K9S_EDGE(k, dep) ((void)0)
#endif

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
  if constexpr (kSharded) {
    K9S_EDGE(0, 0);
    K9S_MARK(2, 0);
  }
  step::wait_predecessor();  // the programmatic edge from K3
  if constexpr (kSharded) K9S_MARK(3, 0);
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
  if constexpr (kSharded) K9S_MARK(4, n_rows);

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
    if constexpr (kSharded)
      if (i == 0) K9S_MARK(5, kw[0] ^ (uint32_t)g);

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
    if constexpr (kSharded)
      if (i == 0) K9S_MARK(6, 0);

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
      if constexpr (kSharded)
        if (i == 0 && ps == 0) K9S_MARK(7, (uint32_t)fc);
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
      if constexpr (kSharded)
        if (i == 0 && ps == 0) {
          K9S_MARK(8, pending);
          K9S_MARK(9, 0);
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
      if constexpr (kSharded)
        if (i == 0 && ps == 0) K9S_MARK(10, 0);
      const int at = block_place(pending, s_cnt, &s_base, pass & 1, state);
      if constexpr (kSharded)
        if (i == 0 && ps == 0) K9S_MARK(11, at);
      if (pending) entry(pend + (size_t)at * PW);
      if constexpr (kSharded)
        if (i == 0 && ps == 0) K9S_MARK(12, 0);
    }
  }
  // 4. the surviving lanes: one atomic a block
  n_valid = __reduce_add_sync(kFull, n_valid);
  if (blockDim.x == 32) {
    if (lane == 0 && n_valid != 0)
      atomicAdd((unsigned long long*)&state[step::kNValid], (unsigned long long)n_valid);
    if constexpr (kSharded) {
      K9S_MARK(13, 0);
      K9S_EDGE(1, 0);
    }
    return;
  }
  if (lane == 0 && n_valid != 0) atomicAdd(&s_valid, (unsigned long long)n_valid);
  __syncthreads();
  if (tid == 0 && s_valid != 0)
    atomicAdd((unsigned long long*)&state[step::kNValid], s_valid);
  if constexpr (kSharded) {
    K9S_MARK(13, 0);
    K9S_EDGE(1, 0);
  }
}

// ---- K9s's rows form: the sharded step at M <= 31 (N <= 5)

constexpr int kRowsMaxN = 5;       // the rows form's widest row: 31 masks, a lane each
constexpr int kRowsMaxW = 3;       // its key words
constexpr int kRowsMaxP = 10;      // its pairs
constexpr int kRowsMaxT = 10;      // its cubes
constexpr int kRowsMaxCW = 2 + kRowsMaxW + 5;  // a candidate row's words
constexpr int kRowsCorners = 3;    // cube corners a lane (8 kRowsMaxT <= 3 x 32)
constexpr int kRowsParams = 3;     // params words a thread (4P + 3T + N <= 75 <= 3 x 32)
constexpr int kRowsChunks = 3;     // 16-byte chunks a lane of a row's candidates (<= 3 x 32)

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// A warp's shared memory in the rows form: its row's term tables (4
// kRowsMaxP longlong2, the pairs past P zero), its cube corners (8
// kRowsMaxT, the cubes past T zero), then the stage of its candidate rows
// (M CW words, placed at the phase of their destination's 16-byte
// alignment: up to 3 words before them).
__host__ __device__ __forceinline__ size_t rows_warp_bytes(int CW) {
  return 16 * (size_t)(4 * kRowsMaxP) + 4 * (size_t)(8 * kRowsMaxT) +
         align16(4 * (size_t)(31 * CW + 3));
}

// The rows form's block: the constants, then R warps' memory.
__host__ __device__ __forceinline__ size_t rows_shared_bytes(int N, int P, int T, int CW, int R) {
  return align16(4 * (size_t)expand::const_words(N, P, T)) + (size_t)R * rows_warp_bytes(CW);
}

// Coordinate d of a row of at most kRowsMaxW key words, in registers.
__device__ __forceinline__ int row_coord(const uint32_t (&kw)[kRowsMaxW], int d) {
  const uint32_t w = (d >> 1) == 0 ? kw[0] : ((d >> 1) == 1 ? kw[1] : kw[2]);
  return (int)((w >> (16 * (d & 1))) & 0xFFFFu);
}

// step::hash_keys over at most kRowsMaxW words, in registers.
__device__ __forceinline__ uint32_t rows_hash(const uint32_t (&w)[kRowsMaxW], int W) {
  uint32_t h = 2166136261u;
#pragma unroll
  for (int i = 0; i < kRowsMaxW; ++i)
    if (i < W) h = (h ^ w[i]) * 16777619u;
  return step::mix32(h);
}

// A warp's store of n (>= 8) words staged at s[g0 .. g0 + n) (s 16-byte
// aligned, g0 the destination's word phase, (dst address / 4) mod 4): the
// chunks the span covers as 16-byte stores across the warp, a lane's
// loads before its stores; the head's words (the chunk before the first
// whole one) by lanes 0-3, the tail's (the chunk after the last) by lanes
// 4-7, a word a lane.
__device__ __forceinline__ void store_span(int32_t* dst, const int32_t* s, int g0, int n,
                                           int lane) {
  int32_t* base = dst - g0;  // 16-byte aligned
  const int end = g0 + n, first = (g0 + 3) >> 2, last = end >> 2;
  int4 v[kRowsChunks];
#pragma unroll
  for (int k = 0; k < kRowsChunks; ++k) {
    const int j = first + lane + 32 * k;
    if (j < last) v[k] = reinterpret_cast<const int4*>(s)[j];
  }
  // a head word (chunk 0, when g0 > 0) or a tail word (chunk last)
  const int q = lane < 4 ? lane : 4 * last + lane - 4;
  const bool word = lane < 8 && (lane < 4 ? q >= g0 && q < 4 * first : q < end);
  const int32_t x = word ? s[q] : 0;
#pragma unroll
  for (int k = 0; k < kRowsChunks; ++k) {
    const int j = first + lane + 32 * k;
    if (j < last) reinterpret_cast<int4*>(base)[j] = v[k];
  }
  if (word) base[q] = x;
}

// K9s at M <= 31: a warp a row, R = blockDim.x / 32 rows a block, row i =
// blockIdx.x R + warp (the grid covers the B rows the list may hold: no
// stride).  The chain of a row is three rounds of loads and the place:
//   before the edge: params' loads (written at set-up, never by a step:
//     the constants, stored to shared memory once round 1 is in flight,
//     and the lane's two mask codes, search/step.py::k9s_mask_codes);
//   one round: the flag, kNSel, the row's list entry and its h3 words
//     (sel and h3 are B rows long: safe for any i < B);
//   the key row (and t_g, t_fpar), a broadcast load a word;
//   one round: each lane's child's home row (its hash from the key row;
//     read before the prune, the owner and the room: K9 writes no key
//     row, and a lane that is no self-owned survivor ignores it), the P
//     T8 rows (two int4 a lane) and the 8T cube corners;
// then the term tables and the masks (__syncwarp, no block barrier), the
// block's place atomic on kNPend (each warp's ballot, a prefix over the
// warps) issued before the candidate rows are staged and stored and read
// after them, the pending entries, and kNValid's atomic.  Every word it
// writes is the block form's.
template <bool kUnpacked>
__global__ void __launch_bounds__(kMaxThreads, 1) keyrow_expand_rows_kernel(
    const int32_t* __restrict__ t_key, int KWs, const int32_t* __restrict__ t_g,
    const long long* __restrict__ t_fpar, int32_t* __restrict__ t_best, uint32_t Cmask,
    const int32_t* __restrict__ sel, int B, const int32_t* __restrict__ tables4,
    const int32_t* __restrict__ cubes, const int32_t* __restrict__ params, int N, int P, int T,
    int S, int nb, long long f0, long long ub, int E, int GG, int gap_oe,
    const int32_t* __restrict__ run, long long* __restrict__ counters,
    long long* __restrict__ state, int32_t* __restrict__ pend, Sharded sh) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int s_cnt[kMaxWarps], s_val[kMaxWarps];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, R = blockDim.x >> 5;
  const int W = (N + 1) / 2, M = (1 << N) - 1, CW = sh.CW;
  const int PW = W + (kUnpacked ? 5 : 4);
  K9S_EDGE(0, 0);
  K9S_MARK(2, 0);
  // 0. the constants' loads, issued before the edge
  int32_t* sm = reinterpret_cast<int32_t*>(s_raw);
  const int n_const = expand::const_words(N, P, T);
  int32_t cv[kRowsParams];
#pragma unroll
  for (int j = 0; j < kRowsParams; ++j) {
    const int q = j * blockDim.x + tid;
    cv[j] = q < n_const ? params[q] : 0;
  }
  // the lane's mask codes, after the constants and the key bit widths
  // (search/step.py::_kernel_params): 2 bits a pair (its move bits), 3 a
  // cube (its corner)
  const int m = lane + 1;
  int32_t pcode = 0, ccode = 0;
  if (m <= M) {
    pcode = params[n_const + N + 2 * lane];
    ccode = params[n_const + N + 2 * lane + 1];
  }
  step::wait_predecessor();  // the programmatic edge from the step's kernel before
  K9S_MARK(3, 0);
  // 1. one round: the flag, the list's length, the row's entry, its h3
  const long long i = (long long)blockIdx.x * R + warp;
  const int32_t flag = *run;
  const long long n_rows = state[step::kNSel];
  int2 e = make_int2(0, 0);
  if (i < B) e = reinterpret_cast<const int2*>(sel)[i];
  int32_t h3m = 0;
  if (sh.h3 != nullptr && i < B && lane < M) h3m = sh.h3[i * (M + 1) + lane];
#pragma unroll
  for (int j = 0; j < kRowsParams; ++j) {
    const int q = j * blockDim.x + tid;
    if (q < n_const) sm[q] = cv[j];
  }
  K9S_MARK(4, (uint32_t)flag ^ (uint32_t)n_rows ^ (uint32_t)e.x ^ (uint32_t)h3m);
  if (flag == 0 || (long long)blockIdx.x * R >= n_rows) return;  // the whole block
  const bool live = i < n_rows;

  // 2. the key row (unpacked: t_g, t_fpar), every lane the same words
  uint32_t kw[kRowsMaxW] = {0u, 0u, 0u};
  int32_t hcol = 0;
  long long fp = 0, g = 0;
  if (live) {
    const int32_t* row = t_key + (size_t)e.x * KWs;
#pragma unroll
    for (int w = 0; w < kRowsMaxW; ++w)
      if (w < W) kw[w] = (uint32_t)row[w];
    if constexpr (kUnpacked) {
      fp = t_fpar[e.x];
      g = t_g[e.x];
    } else {
      hcol = row[W];
    }
  }
  __syncthreads();  // the constants
  expand::Consts k = expand::consts_at(sm, N, P, T, S);
  if (sh.h3 != nullptr) k.T = 0;  // h3 stands in for the cube reads
  unsigned char* mine = s_raw + align16(4 * (size_t)n_const) + warp * rows_warp_bytes(CW);
  longlong2* s_term = reinterpret_cast<longlong2*>(mine);
  int32_t* s_cube = reinterpret_cast<int32_t*>(mine + 16 * 4 * kRowsMaxP);
  int32_t* s_stage = reinterpret_cast<int32_t*>(mine + 16 * 4 * kRowsMaxP + 4 * 8 * kRowsMaxT);
  // the final coordinate, read while the key row is in flight
  int fin[kRowsMaxN];
#pragma unroll
  for (int d = 0; d < kRowsMaxN; ++d) fin[d] = d < N ? k.final_c[d] : 0;
  int par;
  long long f_par = 0;
  if constexpr (kUnpacked) {
    par = (int)(fp & ((1ll << nb) - 1));
    f_par = fp >> nb;
  } else {
    g = (long long)(e.y >> nb) + f0 - hcol;
    par = e.y & ((1 << nb) - 1);
  }
  K9S_MARK(5, kw[0] ^ (uint32_t)g);

  // 3. one round: each lane's child's home row (packed; its hash from the
  // key row, read whatever the child's owner and validity: K9 writes no
  // key row, and a lane that is not a self-owned survivor ignores it),
  // the T8 rows (lane p < P) and the cube corners (lane r mod 32), all
  // issued before the owner and the room are worked out
  uint32_t words[kRowsMaxW];
#pragma unroll
  for (int w = 0; w < kRowsMaxW; ++w)  // a valid child's coordinates: no carry
    words[w] = kw[w] + ((uint32_t)(m >> (2 * w)) & 1u) + (((uint32_t)(m >> (2 * w + 1)) & 1u) << 16);
  const uint32_t h0 = rows_hash(words, W);
  const uint32_t at = step::probe_slot(h0, 0, Cmask);
  int32_t hw[kRowsMaxW] = {0, 0, 0};
  if (!kUnpacked && live && m <= M) {
    const int32_t* hr = t_key + (size_t)at * KWs;
#pragma unroll
    for (int w = 0; w < kRowsMaxW; ++w)
      if (w < W) hw[w] = hr[w];
  }
  const auto clamp = [&](int d) { return min(max(row_coord(kw, d), 0), S - 2); };
  const size_t SS = (size_t)S * S;
  int4 ta = make_int4(0, 0, 0, 0), tc = ta;
  if (live && lane < P) {
    const int4* t8 = reinterpret_cast<const int4*>(
        tables4 + ((size_t)lane * SS + (size_t)clamp(k.xs[lane]) * S + clamp(k.ys[lane])) * 8);
    ta = __ldg(t8);
    tc = __ldg(t8 + 1);
  }
  int32_t corner[kRowsCorners];
#pragma unroll
  for (int j = 0; j < kRowsCorners; ++j) {
    const int r = lane + 32 * j, t = r >> 3;
    corner[j] = 0;
    if (live && r < 8 * k.T) {
      const int cx = clamp(k.tri[3 * t]) + ((r >> 2) & 1);
      const int cy = clamp(k.tri[3 * t + 1]) + ((r >> 1) & 1);
      const int cz = clamp(k.tri[3 * t + 2]) + (r & 1);
      corner[j] = __ldg(cubes + (size_t)t * SS * S + ((size_t)cx * S + cy) * S + cz);
    }
  }
  uint32_t room = 0, short1 = 0;
  bool fits = true, near = true;
#pragma unroll
  for (int d = 0; d < kRowsMaxN; ++d) {
    if (d < N) {
      const int c = row_coord(kw, d), f = fin[d];
      fits &= c <= f;
      room |= (uint32_t)(c < f) << d;
      short1 |= (uint32_t)(c + 1 == f) << d;
      near &= c == f || c + 1 == f;
    }
  }
  const int goal_m = near ? (int)short1 : -1;
  const bool can = live && m <= M && fits && (m & ~(int)room) == 0;
  int dest = sh.ndev;
  if (can) {
    const int o =
        owner::of_at<kRowsMaxN>(sh.hash, [&](int d) { return row_coord(words, d); }, N);
    if (o != sh.me) dest = o;
  }
  const bool self = can && dest == sh.ndev;
  if (lane < kRowsMaxP) {
    // pair_terms's four entries (2 bx + by), its sums multiplied out: w GG,
    // w E plus the gap's opening by the parent's move bit, w mm; h the
    // cell times w_h (the same integers)
    longlong2 t0 = make_longlong2(0, 0), t1 = t0, t2 = t0, t3 = t0;
    if (live && lane < P) {
      const long long w = k.w[lane], wh = k.wh[lane], go = (long long)gap_oe * w;
      const long long we = w * E;
      t0 = make_longlong2(w * GG, (long long)ta.x * wh);
      t1 = make_longlong2(we + go * ((par >> k.xs[lane]) & 1), (long long)ta.y * wh);
      t2 = make_longlong2(we + go * ((par >> k.ys[lane]) & 1), (long long)ta.z * wh);
      t3 = make_longlong2(w * tc.x, (long long)ta.w * wh);
    }
    s_term[4 * lane] = t0;
    s_term[4 * lane + 1] = t1;
    s_term[4 * lane + 2] = t2;
    s_term[4 * lane + 3] = t3;
  }
#pragma unroll
  for (int j = 0; j < kRowsCorners; ++j)
    if (lane + 32 * j < 8 * kRowsMaxT) s_cube[lane + 32 * j] = corner[j];
  // the home row's match, before the prune (a lane the prune drops
  // ignores it)
  bool home = !kUnpacked && self && hw[0] != -1;
#pragma unroll
  for (int w = 0; w < kRowsMaxW; ++w)
    if (w < W) home &= hw[w] == (int32_t)words[w];
  __syncwarp();
  K9S_MARK(6, (uint32_t)ta.x ^ (uint32_t)home ^ (uint32_t)corner[0]);

  // 4. the mask: cost and h from the term tables and corners, the goal
  // before the prune
  bool valid = can;
  long long h = 0, gc = 0, fc = 0;
  if (valid) {
    // entry 4p + 2 bx + by of pair p's terms, 8t + corner of cube t's (the
    // codes past P and T are 0: the padding's zero entries)
    long long cost = 0, hc = 0;
#pragma unroll
    for (int p = 0; p < kRowsMaxP; ++p) {
      const longlong2 v = s_term[4 * p + ((pcode >> (2 * p)) & 3)];
      cost += v.x;
      h += v.y;
    }
    if (k.T != 0) {  // else h3 stands in for the cubes
#pragma unroll
      for (int t = 0; t < kRowsMaxT; ++t) hc += s_cube[8 * t + ((ccode >> (3 * t)) & 7)];
    }
    h += hc + h3m;
    gc = g + cost;
    fc = gc + h;
    if constexpr (kUnpacked) fc = fc > f_par ? fc : f_par;  // pathmax
    if (m == goal_m) atomicMin(&counters[step::cGoal], gc);  // before the prune
    valid = fc <= ub;
  }
  K9S_MARK(7, (uint32_t)fc);
  // 5. round 0 of the insert (packed): the home row holds the key -> settled
  const int32_t fsort = kUnpacked ? (int32_t)fc : (int32_t)(((fc - f0) << nb) | m);
  bool pending = valid && self;
  if (!kUnpacked && pending && home) {
    atomicMin(&t_best[at], fsort);
    pending = false;
  }
  K9S_MARK(8, pending);
  // a lane's pending entry: key words, hash, claim tag, then (packed) h
  // and the packed word, or (unpacked) g and f * 2^n + m
  const int tag = sh.tag_base + (int)(i * M + m - 1);  // the content tag
  const long long fpar = fc * (1ll << nb) + m;
  auto entry = [&](int32_t* out) {
#pragma unroll
    for (int w = 0; w < kRowsMaxW; ++w)
      if (w < W) out[w] = (int32_t)words[w];
    out[W] = (int32_t)h0;
    out[W + 1] = tag;
    if constexpr (kUnpacked) {
      out[W + 2] = (int32_t)gc;
      out[W + 3] = (int32_t)(uint32_t)(unsigned long long)fpar;
      out[W + 4] = (int32_t)(fpar >> 32);
    } else {
      out[W + 2] = (int32_t)h;
      out[W + 3] = fsort;
    }
  };
  // 6. the places: one returning atomicAdd on kNPend a block (the warps'
  // ballots, a prefix over the warps), issued here and read after the
  // candidate stores; kNValid's atomic after the pending entries
  const unsigned ballot = __ballot_sync(kFull, pending);
  const int nv = __popc(__ballot_sync(kFull, valid));
  if (lane == 0) {
    s_cnt[warp] = __popc(ballot);
    s_val[warp] = nv;
  }
  __syncthreads();
  int n_valid = 0, total = 0;
  unsigned long long base = 0;
  if (tid == 0) {
    for (int w = 0; w < R; ++w) {
      total += s_cnt[w];
      n_valid += s_val[w];
    }
    if (total)
      base = atomicAdd((unsigned long long*)&state[step::kNPend], (unsigned long long)total);
  }
  // 7. the row's M candidate rows: staged at their destination's phase,
  // then 16-byte stores across the warp
  if (live) {
    int32_t* dst = sh.cand + (size_t)i * M * CW;
    const int g0 = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    if (m <= M) {
      int32_t* r = s_stage + g0 + (m - 1) * CW;
      if (valid && !self) {
        r[0] = dest;
        r[1] = fsort;
        entry(r + 2);
      } else {  // the empty row
        r[0] = sh.ndev;
        r[1] = kUnpacked ? (int32_t)step::kInf : (int32_t)step::kInfp;
#pragma unroll
        for (int w = 2; w < kRowsMaxCW; ++w)
          if (w < CW) r[w] = w < 2 + W ? -1 : 0;
      }
    }
    __syncwarp();
    K9S_MARK(9, 0);
    store_span(dst, s_stage, g0, M * CW, lane);
  }
  K9S_MARK(10, 0);
  if (tid == 0) s_base = (int)base;
  __syncthreads();
  int place = s_base + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) place += s_cnt[w];
  K9S_MARK(11, place);
  if (pending) entry(pend + (size_t)place * PW);
  K9S_MARK(12, 0);
  if (n_valid != 0)
    atomicAdd((unsigned long long*)&state[step::kNValid], (unsigned long long)n_valid);
  K9S_MARK(13, 0);
  K9S_EDGE(1, 0);
}

template <bool kUnpacked, bool kSharded>
int launch(const void* t_key, int KWs, const void* t_g, const void* t_fpar, void* t_best,
           uint32_t Cmask, const void* sel, const void* tables4, const void* cubes,
           const void* params, int N, int P, int T, int S, int nb, long long f0, long long ub,
           int E, int GG, int gap_oe, int B, int blocks, int threads, const void* run,
           void* counters, void* state, void* pend, Sharded sh, int rows, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1] = {step::programmatic_edge()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (kSharded && rows > 0) {  // K9s's rows form
    cfg.dynamicSmemBytes = rows_shared_bytes(N, P, T, sh.CW, rows);
    if (cfg.dynamicSmemBytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    e = cudaLaunchKernelEx(
        &cfg, keyrow_expand_rows_kernel<kUnpacked>, (const int32_t*)t_key, KWs,
        (const int32_t*)t_g, (const long long*)t_fpar, (int32_t*)t_best, Cmask,
        (const int32_t*)sel, B, (const int32_t*)tables4, (const int32_t*)cubes,
        (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, (const int32_t*)run,
        (long long*)counters, (long long*)state, (int32_t*)pend, sh);
  } else {
    cfg.dynamicSmemBytes = shared_bytes(N, P, T);
    if (cfg.dynamicSmemBytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    e = cudaLaunchKernelEx(
        &cfg, keyrow_expand_kernel<kUnpacked, kSharded>, (const int32_t*)t_key, KWs,
        (const int32_t*)t_g, (const long long*)t_fpar, (int32_t*)t_best, Cmask,
        (const int32_t*)sel, (const int32_t*)tables4, (const int32_t*)cubes,
        (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, (const int32_t*)run,
        (long long*)counters, (long long*)state, (int32_t*)pend, sh);
  }
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
                                        cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, B,
                                        blocks, threads, run, counters, state, pend, Sharded{},
                                        0, stream)
                  : launch<false, false>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                         cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, B,
                                         blocks, threads, run, counters, state, pend, Sharded{},
                                         0, stream);
}

// The sharded instantiation: keyrow_expand's arguments, then h3 ((B, M + 1)
// int32, packed only, or null: the shard reads its cubes, non-null when T >
// 0), cand ((B M, CW) int32), CW (2 + the pending entry's words), the owner
// hash (kind, size, shift, zbits: parallel/partition.py::owner_params),
// ndev (= the hash's size), this shard's index me, tag_base (the
// self-owned lanes' first claim tag, tag_base + B M < 2^31) and rows: 0
// the block form (a block a row, K9's; any M), else the rows form at M <=
// 31 with `rows` rows a block (threads = 32 rows, blocks x rows >= B;
// search/step.py::k9s_launch_shape); pend points where the self-owned
// pending lanes go.
extern "C" int keyrow_expand_sharded(const void* t_key, int KWs, const void* t_g,
                                     const void* t_fpar, void* t_best, int C, int unpacked,
                                     const void* sel, const void* tables4, const void* cubes,
                                     const void* params, int N, int P, int T, int S, int nb,
                                     long long f0, long long ub, int E, int GG, int gap_oe, int B,
                                     int blocks, int threads, const void* run, void* counters,
                                     void* state, void* pend, const void* h3, void* cand, int CW,
                                     int hash_kind, int hash_size, int hash_shift, int zbits,
                                     int ndev, int me, int tag_base, int rows, void* stream) {
  const int W = (N + 1) / 2;
  if (bad_args(KWs, t_g, t_fpar, t_best, C, unpacked, cubes, h3, N, P, T, S, nb, B, blocks,
               threads) ||
      cand == nullptr || CW != 2 + W + (unpacked ? 5 : 4) || (unpacked && h3 != nullptr) ||
      ndev < 1 || me < 0 || me >= ndev || hash_size != ndev || hash_kind < 0 || hash_kind > 3 ||
      hash_shift < 0 || hash_shift > 31 || zbits < 1 || zbits > 32 || tag_base < 0 ||
      (long long)tag_base + (long long)B * ((1ll << N) - 1) >= (1ll << 31) || rows < 0 ||
      (rows > 0 && (N > kRowsMaxN || threads != 32 * rows || (long long)blocks * rows < B)))
    return (int)cudaErrorInvalidValue;
  const Sharded sh{(const int32_t*)h3, (int32_t*)cand, CW,
                   owner::Hash{hash_kind, hash_size, hash_shift, zbits}, ndev, me, tag_base};
  const uint32_t Cmask = (uint32_t)(C - 1);
  return unpacked ? launch<true, true>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                       cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, B,
                                       blocks, threads, run, counters, state, pend, sh, rows,
                                       stream)
                  : launch<false, true>(t_key, KWs, t_g, t_fpar, t_best, Cmask, sel, tables4,
                                        cubes, params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, B,
                                        blocks, threads, run, counters, state, pend, sh, rows,
                                        stream);
}

#ifdef K9S_PHASES
// The %globaltimer readings of the launches since the last read (kK9sStamps
// uint64 into host memory; 0 where no block wrote one; waits for the
// card), then reset: the first block's start to the largest value, the
// rest to 0.
extern "C" int keyrow_expand_phases(unsigned long long* host, int n) {
  if (host == nullptr || n != kK9sStamps) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyFromSymbol(host, g_k9s, sizeof(unsigned long long) * kK9sStamps);
  if (e != cudaSuccess) return (int)e;
  unsigned long long fresh[kK9sStamps] = {};
  fresh[0] = ~0ull;
  return (int)cudaMemcpyToSymbol(g_k9s, fresh, sizeof(fresh));
}
#endif
