// Expansion of the selected rows, sig encoding and the round-0 row match of
// the insert: kernel K4.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :442 _sig_decode, :497
// _expand, :1724 _candidates_sig -> :400 _sig_encode and the round-0
// lookup of :1441 _insert_core_sig (XLA inside the run loop).  The port's
// plain versions are search/engine.py::_sig_decode, _expand (g_is_f),
// _candidates_sig, _sig_encode and the round 0 of _insert_sig.  For each
// active row b of the selection and each move mask m = 1 .. 2^N - 1, the
// edge cost and h of expand_row.cuh (shared with keyrow_expand.cu, K9) and
//   g    = f(row) - h(row) + cost,  f = g + h,  child = coord + bits(m).
// valid = child <= final; the goal is found BEFORE the
// upper-bound prune (goal_g = min g over goal lanes, by atomicMin on the
// counters' slot 0), then valid &= f <= ub.  A surviving lane encodes
// (home, sig base) from its child's key, forms packed = ((f - f0) << n) | m
// and reads its home bucket row: a way that holds its sig base settles it
// at once (atomicMin of packed into t_best: nothing reads t_best during the
// insert, so the order of these mins does not matter); otherwise it
// appends (home, sig base, packed) to the pending list of the probe
// (sig_probe.cu) through one atomicAdd per warp.  The list's order varies
// from run to run; the probe's result does not depend on it.
//
// What bounds it on an H100: a chain of dependent loads, not bytes.  Per
// active row: its list entry, its slot's sig word, P T8 rows of 32 B
// (24.7 MB table at kinase, gathered at random) and T x 8 cube corners
// (343.8 MB stack), then per surviving lane one 32 B bucket row and 4 or
// 12 B written: about 0.55 MB at a kinase step, 0.16 us at 3.35 TB/s.  A
// row is four dependent round trips to memory (entry, sig word, T8 rows
// and corners, bucket rows), so the floor is one launch plus those trips.
//
// Design: a fixed grid whose warps stride over the compact list of active
// rows that K3 wrote (its length read from the state vector: the host
// reads nothing), a warp a row, a lane a mask (kinase: 31 masks, one pass;
// N = 6: 63 masks, two passes; N = 4: 15 masks, half a warp).  The block
// stages the constants (pairs, weights, triangles, final coordinate, bit
// widths) once.  Every lane of a warp decodes the row's coordinate from
// (slot, t_sig[slot]); lanes then fetch the P T8 rows (two int4 loads a
// lane) and the 8T cube corners in parallel into the warp's own shared
// memory, behind __syncwarp(): no block barrier inside the row loop.  Each
// mask reads the staged rows from there.  Sig words need u32 arithmetic,
// which CUDA has: the child's key is one u64 (sig_bits <= 53), klo its low
// bbits, khi the next 32 bits.  Stored words are (khi << 6) | r < 2^31,
// because the sig layout is taken only where sig_bits - bbits <= 25
// (engine.py::_Static.sig_ok).  kNValid takes one atomicAdd a block.
// The encoding and its inverse are sig_key.cuh's (shared with K7).
//
// The sharded instantiation (C entry sig_expand_sharded: the multi-device
// step of parallel/sharded.py, JAX :386-426 in _make_sharded_run_sig) is
// the same kernel with three changes:
//   - with sharded cubes, h3 (B, M + 1) int32 from tri_partial.cu (K12)
//     after the mesh's reduce-scatter, row i of the compact list, stands
//     in for the row's cube reads: child m adds h3[i][m - 1], the parent
//     h3[i][M] (JAX _expand(..., h3=h3));
//   - each surviving lane's owner shard comes from its child coordinate
//     (owner.cuh, parallel/partition.py); only a self-owned lane reads its
//     home row and goes to the pending list (given at the caller's offset:
//     the received rows go in front of it);
//   - every lane of a listed row writes its candidate row (dest, packed,
//     home, sig base) at i M + m - 1 of `cand` for route_pack.cu (K11):
//     dest the owner for a lane owned elsewhere, else the empty row (ndev,
//     INFP, 0, -1).
// The unsharded instantiation compiles none of it.
//
// K4s's rows form (sig_expand_rows_kernel): the sharded step's rows have
// M <= 31 masks (kinase and synth5: 31; 512 rows a shard), and the form
// above spends each in a chain of about eight dependent steps (the flag,
// kNSel, params staged behind a block barrier, the list entry, the sig
// word and its decode, the T8 rows and corners, the home bucket row, then
// a returning atomic on kNPend for every warp and row, kNValid's after
// it).  The rows form gives a row a warp, a lane a mask, and R =
// blockDim.x / 32 rows a block (search/step.py::K4S_ROWS; the C entry's
// rows, 0 the form above, which N >= 6 keeps), as K9s's rows form does
// (keyrow_expand.cu).  Every constant it reads comes from params, which
// set-up wrote and no step writes, loaded into registers before
// griddepcontrol.wait: the lane's pair (xs, ys, w, w_h), its cube
// corners' triangles, the final coordinate, the key's bit widths and the
// lane's two mask codes (search/step.py::k9s_mask_codes).  Then two
// rounds of loads:
//   one round: the flag, kNSel, the row's list entry, its h3 words (a
//     lane a column) and its coordinate from sig_coords' (B, N) output
//     (tri_partial.cu, K12's gather: the same decode of (slot,
//     t_sig[slot]), which JAX's _select_sig hands to _expand as well);
//     with no sharded cubes (no sig_coords launch: coords null) the
//     coordinate is decoded from t_sig[slot], one round later;
//   one round: each lane's child's home bucket row (32 B; read before the
//     prune and the owner: a lane that is no self-owned survivor ignores
//     it), the P T8 rows (a lane a pair, two int4) and the 8T corners;
// then the term tables in the warp's shared memory (pair_terms's four
// cases multiplied out), the masks with no load (a mask's ten lookups in
// the padded tables), the owner hash on constant indices, the round-0
// match (atomicMin on t_best), one place atomic a block on kNPend issued
// before the candidate rows' int4 stores and read after them, the pending
// entries, and one kNValid atomic a block.  It writes every word the form
// above writes; the pending entries keep their multiset, not their order.

#include "expand_row.cuh"
#include "owner.cuh"
#include "sig_key.cuh"
#include "step_state.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxN = 24;

// What the sharded instantiation adds (null h3: the shard reads its cubes).
struct Sharded {
  const int32_t* h3;
  int32_t* cand;
  owner::Hash hash;
  int ndev, me;
  const int32_t* coords;  // the rows form's (B, N) coordinates, or null
};

// Built with -DK4S_PHASES (a measurement build of chip_smoke.py, never the
// one the port loads), the rows form leaves %globaltimer readings (ns) of
// the launches since the last read, which sig_expand_phases reads and
// resets: [0] the first block's start (a min over blocks), [1] the last
// block's end (a max), then block 0's thread 0 (row 0): [2] its start, [3]
// past wait_predecessor, [4] round 1 (the flag, kNSel, the list entry,
// h3, the coordinate), [5] the coordinate decoded (= [4] with coords),
// [6] round 2 (the home bucket rows, T8 rows and corners), [7] the masks,
// [8] the round-0 match, [9] the candidate rows stored, [10] the place
// atomic returned, [11] the pending entries stored, [12] the tail atomic
// done.  A reading waits for the values the step before it loaded.
#ifdef K4S_PHASES
constexpr int kK4sStamps = 13;
__device__ unsigned long long g_k4s[kK4sStamps];
__device__ __forceinline__ unsigned long long k4s_clock(uint32_t dep) {
  unsigned long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, 0x7fffffff;\n\t"
      "@p mov.u64 %0, %%globaltimer;\n\t@!p mov.u64 %0, %%globaltimer;\n\t}"
      : "=l"(t)
      : "r"(dep)
      : "memory");
  return t;
}
#define K4S_MARK(k, dep)                                                               \
  do {                                                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_k4s[k] = k4s_clock((uint32_t)(dep));    \
  } while (0)
#define K4S_EDGE(k, dep)                                                               \
  do {                                                                                 \
    if (threadIdx.x == 0) {                                                            \
      const unsigned long long t_ = k4s_clock((uint32_t)(dep));                        \
      if (k == 0) atomicMin(&g_k4s[0], t_); else atomicMax(&g_k4s[1], t_);             \
    }                                                                                  \
  } while (0)
#else
#define K4S_MARK(k, dep) ((void)0)
#define K4S_EDGE(k, dep) ((void)0)
#endif

template <bool kSharded>
__global__ void __launch_bounds__(32 * kMaxWarps, kBlocksPerSm) sig_expand_kernel(
    const int32_t* __restrict__ t_sig, int32_t* __restrict__ t_best,
    const int32_t* __restrict__ sel, const int32_t* __restrict__ tables4,
    const int32_t* __restrict__ cubes, const int32_t* __restrict__ params, int N, int P, int T,
    int S, int nb, long long f0, long long ub, int E, int GG, int gap_oe, int bbits,
    const int32_t* __restrict__ run, long long* __restrict__ counters,
    long long* __restrict__ state, int32_t* __restrict__ pend, Sharded sh) {
  extern __shared__ int32_t sm[];
  __shared__ unsigned long long s_valid;
  step::wait_predecessor();  // the programmatic edge from K3
  if (*run == 0) return;
  const int n_const = expand::const_words(N, P, T) + N;  // and the bit widths
  expand::Consts k = expand::consts_at(sm, N, P, T, S);
  if constexpr (kSharded)
    if (sh.h3 != nullptr) k.T = 0;  // h3 stands in for the cube reads
  const int32_t* s_final = k.final_c;
  const int32_t* s_bitw = s_final + N;
  int32_t* s_shift = sm + n_const;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's own staging: T8 rows, cube corners, coordinate
  int32_t* s_t8 = s_shift + N + warp * expand::warp_words(N, P, T);
  int32_t* s_cube = s_t8 + 5 * P;
  int32_t* s_coord = s_cube + 8 * T;

  // 1. the constants, once a block
  for (int q = tid; q < n_const; q += blockDim.x) sm[q] = params[q];
  if (tid == 0) {
    s_valid = 0;
    int sh = 0;
    for (int i = 0; i < N; ++i) {
      s_shift[i] = sh;
      sh += params[4 * P + 3 * T + N + i];
    }
  }
  __syncthreads();

  const int M = (1 << N) - 1;
  const long long n_rows = state[step::kNSel];
  const int nw = gridDim.x * (blockDim.x >> 5);
  uint32_t n_valid = 0;
  for (long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp; i < n_rows; i += nw) {
    // 2. the row's coordinate from (slot, stored sig word): _sig_decode
    const int2 e = reinterpret_cast<const int2*>(sel)[i];
    const uint32_t slot = (uint32_t)e.x;
    const int32_t v = e.y;
    const unsigned long long key = sigkey::decode(slot, (uint32_t)t_sig[slot], bbits);
    if (lane < N) s_coord[lane] = (int32_t)((key >> s_shift[lane]) & ((1ull << s_bitw[lane]) - 1));
    __syncwarp();
    // 3. the row's T8 rows and cube corners, lanes in parallel
    expand::stage_row(k, tables4, cubes, s_coord, s_t8, s_cube, lane);
    __syncwarp();

    // 4. the parent: h from the k = 0 cells and corner 0; the table holds f
    const int par = v & ((1 << nb) - 1);
    long long h_row = expand::parent_h(k, s_t8, s_cube);
    const int32_t* h3_row = nullptr;
    if constexpr (kSharded)
      if (sh.h3 != nullptr) {
        h3_row = sh.h3 + i * (M + 1);
        h_row += h3_row[M];
      }
    const long long g = (long long)(v >> nb) + f0 - h_row;

    // 5. a lane a mask, 32 masks a pass
    for (int m0 = 1; m0 <= M; m0 += 32) {
      const int m = m0 + lane;
      long long cost, h;
      expand::child_cost_h(k, m, par, E, GG, gap_oe, s_t8, s_cube, cost, h);
      if constexpr (kSharded)
        if (h3_row != nullptr && m <= M) h += h3_row[m - 1];
      bool valid = m <= M, goal = m <= M;
      unsigned long long ckey = 0;
      int32_t child[kSharded ? kMaxN : 1];
      for (int d = 0; d < N; ++d) {
        const int c = s_coord[d] + ((m >> d) & 1);
        valid &= c <= s_final[d];
        goal &= c == s_final[d];
        ckey |= (unsigned long long)c << s_shift[d];
        if constexpr (kSharded) child[d] = c;
      }
      const long long gc = g + cost, fc = gc + h;
      if (goal) atomicMin(&counters[step::cGoal], gc);  // before the prune
      valid &= fc <= ub;
      n_valid += valid;
      bool pending = false;
      uint32_t home = 0, sigb = 0;
      int32_t packed = 0;
      int dest = 0;
      if constexpr (kSharded) dest = sh.ndev;
      if (valid) {
        sigkey::encode(ckey, bbits, home, sigb);
        packed = (int32_t)(((fc - f0) << nb) | m);
        if constexpr (kSharded) {
          const int o = owner::of(sh.hash, child, N);
          if (o != sh.me) dest = o;
        }
      }
      if constexpr (kSharded)
        if (m <= M)
          reinterpret_cast<int4*>(sh.cand)[i * M + (m - 1)] =
              dest < sh.ndev ? make_int4(dest, packed, (int)home, (int)sigb)
                             : make_int4(sh.ndev, (int)step::kInfp, 0, -1);
      bool stays = true;  // self-owned: the round-0 match here
      if constexpr (kSharded) stays = dest >= sh.ndev;
      if (valid && stays) {
        // round 0: the home bucket row, 8 ways in 32 bytes
        const int4* row4 = reinterpret_cast<const int4*>(t_sig + (size_t)home * 8);
        const int4 a = row4[0], c = row4[1];
        const int32_t ways[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
        int way = -1;
        for (int w = 7; w >= 0; --w)
          if (ways[w] == (int32_t)sigb) way = w;  // the first matching way
        if (way >= 0)
          atomicMin(&t_best[(size_t)home * 8 + way], packed);
        else
          pending = true;
      }
      const unsigned ballot = __ballot_sync(kFull, pending);
      int base = 0;
      if (lane == 0 && ballot != 0)
        base = (int)atomicAdd((unsigned long long*)&state[step::kNPend],
                              (unsigned long long)__popc(ballot));
      base = __shfl_sync(kFull, base, 0);
      if (pending) {
        const int at = base + __popc(ballot & ((1u << lane) - 1u));
        pend[3 * at] = (int32_t)home;
        pend[3 * at + 1] = (int32_t)sigb;
        pend[3 * at + 2] = packed;
      }
    }
    __syncwarp();  // the next row rewrites this warp's staging
  }
  // 6. the surviving lanes: one atomic a block
  n_valid = __reduce_add_sync(kFull, n_valid);
  if (lane == 0 && n_valid != 0) atomicAdd(&s_valid, (unsigned long long)n_valid);
  __syncthreads();
  if (tid == 0 && s_valid != 0)
    atomicAdd((unsigned long long*)&state[step::kNValid], s_valid);
}

// ---- K4s's rows form: the sharded step at M <= 31 (N <= 5)

constexpr int kRowsMaxN = 5;        // the widest row: 31 masks, a lane each
constexpr int kRowsMaxP = 10;       // its pairs
constexpr int kRowsMaxT = 10;       // its cubes
constexpr int kRowsCorners = 3;     // cube corners a lane (8 kRowsMaxT <= 3 x 32)
constexpr int kRowsMaxWarps = 8;    // rows a block

// A warp's shared memory in the rows form: its row's term tables (4
// kRowsMaxP longlong2, the pairs past P zero), then its cube corners (8
// kRowsMaxT, the cubes past T zero).
__host__ __device__ __forceinline__ size_t rows_warp_bytes() {
  return 16 * (size_t)(4 * kRowsMaxP) + 4 * (size_t)(8 * kRowsMaxT);
}

// v[d] of at most kRowsMaxN registers, d known only at run time (selects,
// not a local-memory array).
__device__ __forceinline__ int pick(const int32_t (&v)[kRowsMaxN], int d) {
  return d == 0 ? v[0] : d == 1 ? v[1] : d == 2 ? v[2] : d == 3 ? v[3] : v[4];
}

// K4s at M <= 31: a warp a row, R = blockDim.x / 32 rows a block, row i =
// blockIdx.x R + warp (the grid covers the B rows the list may hold: no
// stride).  The chain of a row (above: "K4s's rows form"): params'
// loads before the edge, one round of the flag, kNSel, the list entry,
// h3 and the coordinate (sel, h3 and coords are B rows long: safe for any
// i < B), [the sig word and its decode, where coords is null], one round
// of the home bucket rows, T8 rows and corners, then the masks, the
// match, the place and the stores.  Every word it writes is the form
// above's.
__global__ void __launch_bounds__(32 * kRowsMaxWarps, 1) sig_expand_rows_kernel(
    const int32_t* __restrict__ t_sig, int32_t* __restrict__ t_best,
    const int32_t* __restrict__ sel, int B, const int32_t* __restrict__ tables4,
    const int32_t* __restrict__ cubes, const int32_t* __restrict__ params, int N, int P, int T,
    int S, int nb, long long f0, long long ub, int E, int GG, int gap_oe, int bbits,
    const int32_t* __restrict__ run, long long* __restrict__ counters,
    long long* __restrict__ state, int32_t* __restrict__ pend, Sharded sh) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int s_cnt[kRowsMaxWarps], s_val[kRowsMaxWarps];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, R = blockDim.x >> 5;
  const int M = (1 << N) - 1, m = lane + 1;
  const bool cubes_on = sh.h3 == nullptr && T > 0;  // else h3 stands in for the cubes
  K4S_EDGE(0, 0);
  K4S_MARK(2, 0);
  // 0. params, before the edge: the final coordinate, the key's bit
  // widths (its fields' shifts), the lane's pair, its corners' triangles
  // and its two mask codes (search/step.py::_kernel_params)
  const int32_t* p_final = params + 4 * P + 3 * T;
  int fin[kRowsMaxN], bw[kRowsMaxN];
#pragma unroll
  for (int d = 0; d < kRowsMaxN; ++d) {
    fin[d] = d < N ? __ldg(p_final + d) : 0;
    bw[d] = d < N ? __ldg(p_final + N + d) : 0;
  }
  int xs = 0, ys = 0;
  long long w = 0, wh = 0;
  if (lane < P) {
    xs = __ldg(params + lane);
    ys = __ldg(params + P + lane);
    w = __ldg(params + 2 * P + lane);
    wh = __ldg(params + 3 * P + lane);
  }
  int tri[kRowsCorners][3];
#pragma unroll
  for (int j = 0; j < kRowsCorners; ++j) {
    const int t = (lane + 32 * j) >> 3;
    const bool on = cubes_on && t < T;
#pragma unroll
    for (int a = 0; a < 3; ++a) tri[j][a] = on ? __ldg(params + 4 * P + 3 * t + a) : 0;
  }
  int32_t pcode = 0, ccode = 0;
  if (m <= M) {
    pcode = __ldg(params + 4 * P + 3 * T + 2 * N + 2 * lane);
    ccode = __ldg(params + 4 * P + 3 * T + 2 * N + 2 * lane + 1);
  }
  step::wait_predecessor();  // the programmatic edge from the step's kernel before
  K4S_MARK(3, 0);
  // 1. one round: the flag, the list's length, the row's entry, its h3
  // words (lane l column l: masks l + 1, the row itself at l = M) and its
  // coordinate
  const long long i = (long long)blockIdx.x * R + warp;
  const int32_t flag = *run;
  const long long n_rows = state[step::kNSel];
  int2 e = make_int2(0, 0);
  if (i < B) e = reinterpret_cast<const int2*>(sel)[i];
  int32_t h3v = 0;
  if (sh.h3 != nullptr && i < B && lane <= M) h3v = sh.h3[i * (M + 1) + lane];
  int32_t c[kRowsMaxN] = {0, 0, 0, 0, 0};
  if (sh.coords != nullptr && i < B) {
#pragma unroll
    for (int d = 0; d < kRowsMaxN; ++d)
      if (d < N) c[d] = sh.coords[i * N + d];
  }
  // the key's field offsets, once round 1 is in flight (nothing before
  // the edge waits for params)
  int shift[kRowsMaxN];
  int sft = 0;
#pragma unroll
  for (int d = 0; d < kRowsMaxN; ++d) {
    shift[d] = sft;
    sft += bw[d];
  }
  K4S_MARK(4, (uint32_t)flag ^ (uint32_t)n_rows ^ (uint32_t)e.y ^ (uint32_t)h3v ^ (uint32_t)c[0]);
  if (flag == 0 || (long long)blockIdx.x * R >= n_rows) return;  // the whole block
  const bool live = i < n_rows;
  if (sh.coords == nullptr && live) {  // _sig_decode of (slot, t_sig[slot])
    const uint32_t slot = (uint32_t)e.x;
    const unsigned long long key = sigkey::decode(slot, (uint32_t)t_sig[slot], bbits);
#pragma unroll
    for (int d = 0; d < kRowsMaxN; ++d)
      if (d < N) c[d] = (int)((key >> shift[d]) & ((1ull << bw[d]) - 1));
  }
  K4S_MARK(5, (uint32_t)c[0]);

  // 2. one round: the child's home bucket row (its key from the
  // coordinate; read before the prune and the owner), the T8 rows (lane p
  // < P) and the cube corners (lane r mod 32), all issued before the
  // owner and the room are worked out
  unsigned long long ckey = 0;
  uint32_t room = 0, short1 = 0;
  bool fits = true, near = true;
  int32_t cc[kRowsMaxN];
#pragma unroll
  for (int d = 0; d < kRowsMaxN; ++d) {
    cc[d] = c[d] + ((m >> d) & 1);
    if (d < N) {
      ckey |= (unsigned long long)(uint32_t)cc[d] << shift[d];
      fits &= c[d] <= fin[d];
      room |= (uint32_t)(c[d] < fin[d]) << d;
      short1 |= (uint32_t)(c[d] + 1 == fin[d]) << d;
      near &= c[d] == fin[d] || c[d] + 1 == fin[d];
    }
  }
  const bool can = live && m <= M && fits && (m & ~(int)room) == 0;
  uint32_t home = 0, sigb = 0;
  sigkey::encode(ckey, bbits, home, sigb);
  int4 ra = make_int4(0, 0, 0, 0), rb = ra;
  if (can) {
    const int4* row4 = reinterpret_cast<const int4*>(t_sig + (size_t)home * 8);
    ra = row4[0];
    rb = row4[1];
  }
  const auto clamp = [&](int d) { return min(max(pick(c, d), 0), S - 2); };
  const size_t SS = (size_t)S * S;
  int4 ta = make_int4(0, 0, 0, 0), tc = ta;
  if (live && lane < P) {
    const int4* t8 = reinterpret_cast<const int4*>(
        tables4 + ((size_t)lane * SS + (size_t)clamp(xs) * S + clamp(ys)) * 8);
    ta = __ldg(t8);
    tc = __ldg(t8 + 1);
  }
  int32_t corner[kRowsCorners];
#pragma unroll
  for (int j = 0; j < kRowsCorners; ++j) {
    const int r = lane + 32 * j, t = r >> 3;
    corner[j] = 0;
    if (live && cubes_on && r < 8 * T) {
      const int cx = clamp(tri[j][0]) + ((r >> 2) & 1);
      const int cy = clamp(tri[j][1]) + ((r >> 1) & 1);
      const int cz = clamp(tri[j][2]) + (r & 1);
      corner[j] = __ldg(cubes + (size_t)t * SS * S + ((size_t)cx * S + cy) * S + cz);
    }
  }
  const int goal_m = near ? (int)short1 : -1;
  int dest = sh.ndev;
  if (can) {
    const int o = owner::of<kRowsMaxN>(sh.hash, cc, N);
    if (o != sh.me) dest = o;
  }
  const bool self = can && dest == sh.ndev;
  const int par = e.y & ((1 << nb) - 1);
  longlong2* s_term = reinterpret_cast<longlong2*>(s_raw + warp * rows_warp_bytes());
  int32_t* s_cube = reinterpret_cast<int32_t*>(s_raw + warp * rows_warp_bytes() +
                                               16 * 4 * kRowsMaxP);
  if (lane < kRowsMaxP) {
    // pair_terms's four entries (2 bx + by), its sums multiplied out: w GG,
    // w E plus the gap's opening by the parent's move bit, w mm; h the
    // cell times w_h (the same integers)
    longlong2 t0 = make_longlong2(0, 0), t1 = t0, t2 = t0, t3 = t0;
    if (live && lane < P) {
      const long long go = (long long)gap_oe * w, we = w * E;
      t0 = make_longlong2(w * GG, (long long)ta.x * wh);
      t1 = make_longlong2(we + go * ((par >> xs) & 1), (long long)ta.y * wh);
      t2 = make_longlong2(we + go * ((par >> ys) & 1), (long long)ta.z * wh);
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
  // the first way of the home row that holds the child's sig base
  const int32_t ways[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
  int way = -1;
#pragma unroll
  for (int q = 7; q >= 0; --q)
    if (ways[q] == (int32_t)sigb) way = q;
  const int32_t h3par = __shfl_sync(kFull, h3v, M);  // the row's own column
  __syncwarp();
  K4S_MARK(6, (uint32_t)ta.x ^ (uint32_t)way ^ (uint32_t)corner[0]);

  // 3. the parent's h (mask 0: each pair's entry 0, each cube's corner 0)
  // and g, then the mask: cost and h from the term tables and corners,
  // the goal before the prune
  long long h_row = h3par;
#pragma unroll
  for (int p = 0; p < kRowsMaxP; ++p) h_row += s_term[4 * p].y;
  if (cubes_on) {
#pragma unroll
    for (int t = 0; t < kRowsMaxT; ++t) h_row += s_cube[8 * t];
  }
  const long long g = (long long)(e.y >> nb) + f0 - h_row;
  bool valid = can;
  long long fc = 0;
  if (valid) {
    long long cost = 0, h = h3v;
#pragma unroll
    for (int p = 0; p < kRowsMaxP; ++p) {
      const longlong2 v = s_term[4 * p + ((pcode >> (2 * p)) & 3)];
      cost += v.x;
      h += v.y;
    }
    if (cubes_on) {
#pragma unroll
      for (int t = 0; t < kRowsMaxT; ++t) h += s_cube[8 * t + ((ccode >> (3 * t)) & 7)];
    }
    const long long gc = g + cost;
    fc = gc + h;
    if (m == goal_m) atomicMin(&counters[step::cGoal], gc);  // before the prune
    valid = fc <= ub;
  }
  K4S_MARK(7, (uint32_t)fc);
  // 4. round 0 of the insert: a self-owned survivor whose home row holds
  // its sig base settles there
  const int32_t packed = (int32_t)(((fc - f0) << nb) | m);
  bool pending = valid && self;
  if (pending && way >= 0) {
    atomicMin(&t_best[(size_t)home * 8 + way], packed);
    pending = false;
  }
  K4S_MARK(8, pending);
  // 5. the places: one returning atomicAdd on kNPend a block (the warps'
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
    for (int q = 0; q < R; ++q) {
      total += s_cnt[q];
      n_valid += s_val[q];
    }
    if (total)
      base = atomicAdd((unsigned long long*)&state[step::kNPend], (unsigned long long)total);
  }
  // 6. the row's M candidate rows, a lane's one int4: (dest, packed,
  // home, sig base) for a survivor owned elsewhere, else the empty row
  if (live && m <= M)
    reinterpret_cast<int4*>(sh.cand)[i * M + (m - 1)] =
        valid && !self ? make_int4(dest, packed, (int)home, (int)sigb)
                       : make_int4(sh.ndev, (int)step::kInfp, 0, -1);
  K4S_MARK(9, 0);
  if (tid == 0) s_base = (int)base;
  __syncthreads();
  int place = s_base + __popc(ballot & ((1u << lane) - 1u));
  for (int q = 0; q < warp; ++q) place += s_cnt[q];
  K4S_MARK(10, place);
  if (pending) {
    pend[3 * place] = (int32_t)home;
    pend[3 * place + 1] = (int32_t)sigb;
    pend[3 * place + 2] = packed;
  }
  K4S_MARK(11, 0);
  if (n_valid != 0)
    atomicAdd((unsigned long long*)&state[step::kNValid], (unsigned long long)n_valid);
  K4S_MARK(12, 0);
  K4S_EDGE(1, 0);
}

// t_sig, t_best: the sig table; sel: K3's compact list of active rows
// (slot, packed word) as (>= B, 2) int32, its length in state[kNSel];
// params: int32 [xs P, ys P, w P, w_h P, triangles 3T, final N, bit widths
// N] (search/step.py::_kernel_params); run: int32 device flag; counters:
// the 14 int64 counters; state: step_state.cuh; pend: (B * (2^N - 1), 3)
// int32 pending list.  B sizes the grid (at most B rows are active).
// Every launch carries a programmatic edge from the kernel before it (K3
// in a chunk step, search/step.py): the kernel waits for it first thing.
// rows (the sharded instantiation): 0 the form above, else the rows form
// with `rows` rows a block (N <= kRowsMaxN).
template <bool kSharded>
int launch(const void* t_sig, void* t_best, const void* sel, const void* tables4,
           const void* cubes, const void* params, int N, int P, int T, int S, int nb,
           long long f0, long long ub, int E, int GG, int gap_oe, int bbits, int B,
           const void* run, void* counters, void* state, void* pend, Sharded sh, int rows,
           void* stream) {
  const bool h3 = kSharded && sh.h3 != nullptr;
  if (N < 2 || N > kMaxN || P != N * (N - 1) / 2 || T < 0 || (T > 0 && cubes == nullptr && !h3) ||
      S < 2 || nb != N || bbits < 1 || bbits > 28 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (kSharded && rows > 0) {  // K4s's rows form: a warp a row, `rows` rows a block
    if (N > kRowsMaxN || rows > kRowsMaxWarps) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((B + rows - 1) / rows));
    cfg.blockDim = dim3(32 * (unsigned)rows);
    cfg.dynamicSmemBytes = (size_t)rows * rows_warp_bytes();
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1] = {step::programmatic_edge()};
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, sig_expand_rows_kernel, (const int32_t*)t_sig, (int32_t*)t_best,
        (const int32_t*)sel, B, (const int32_t*)tables4, (const int32_t*)cubes,
        (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, bbits,
        (const int32_t*)run, (long long*)counters, (long long*)state, (int32_t*)pend, sh);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // shared words: the constants, then each warp's staging; as many warps
  // (up to kMaxWarps) as 48 KB hold
  const size_t shared_const = (size_t)expand::const_words(N, P, T) + 2 * (size_t)N;
  const size_t per_warp = (size_t)expand::warp_words(N, P, T);
  const size_t words = (48 * 1024) / sizeof(int32_t);
  if (shared_const + per_warp > words) return (int)cudaErrorInvalidValue;
  size_t warps = (words - shared_const) / per_warp;
  if (warps > kMaxWarps) warps = kMaxWarps;
  static int sms = 0;  // one card a process
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  long long blocks = ((long long)B + (long long)warps - 1) / (long long)warps;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  const size_t shared = sizeof(int32_t) * (shared_const + warps * per_warp);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(32 * (unsigned)warps);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1] = {step::programmatic_edge()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sig_expand_kernel<kSharded>, (const int32_t*)t_sig, (int32_t*)t_best,
      (const int32_t*)sel, (const int32_t*)tables4, (const int32_t*)cubes,
      (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, bbits, (const int32_t*)run,
      (long long*)counters, (long long*)state, (int32_t*)pend, sh);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sig_expand(const void* t_sig, void* t_best, const void* sel, const void* tables4,
                          const void* cubes, const void* params, int N, int P, int T, int S,
                          int nb, long long f0, long long ub, int E, int GG, int gap_oe,
                          int bbits, int B, const void* run, void* counters, void* state,
                          void* pend, void* stream) {
  return launch<false>(t_sig, t_best, sel, tables4, cubes, params, N, P, T, S, nb, f0, ub, E,
                       GG, gap_oe, bbits, B, run, counters, state, pend, Sharded{}, 0, stream);
}

// The sharded instantiation: sig_expand's arguments, then h3 ((B, M + 1)
// int32, or null: the shard reads its own cubes, cubes then non-null when
// T > 0), cand ((B M, 4) int32), the owner hash (kind, size, shift, zbits:
// parallel/partition.py::owner_params), ndev (= the hash's size), this
// shard's index me, coords (sig_coords' (B, N) int32 coordinates of the
// list's rows, or null: the rows form decodes each row's sig word; the
// form above decodes them whatever it is given) and rows: 0 the form
// above (a warp a row over a fixed grid; any N), else the rows form at N
// <= 5 with `rows` (1-8) rows a block, ceil(B / rows) blocks
// (search/step.py::K4S_ROWS); pend points where the self-owned pending
// lanes go.
extern "C" int sig_expand_sharded(const void* t_sig, void* t_best, const void* sel,
                                  const void* tables4, const void* cubes, const void* params,
                                  int N, int P, int T, int S, int nb, long long f0,
                                  long long ub, int E, int GG, int gap_oe, int bbits, int B,
                                  const void* run, void* counters, void* state, void* pend,
                                  const void* h3, void* cand, int hash_kind, int hash_size,
                                  int hash_shift, int zbits, int ndev, int me,
                                  const void* coords, int rows, void* stream) {
  if (cand == nullptr || ndev < 1 || me < 0 || me >= ndev || hash_size != ndev ||
      hash_kind < 0 || hash_kind > 3 || hash_shift < 0 || hash_shift > 31 || zbits < 1 ||
      zbits > 32 || rows < 0)
    return (int)cudaErrorInvalidValue;
  const Sharded sh{(const int32_t*)h3, (int32_t*)cand,
                   owner::Hash{hash_kind, hash_size, hash_shift, zbits}, ndev, me,
                   (const int32_t*)coords};
  return launch<true>(t_sig, t_best, sel, tables4, cubes, params, N, P, T, S, nb, f0, ub, E,
                      GG, gap_oe, bbits, B, run, counters, state, pend, sh, rows, stream);
}

#ifdef K4S_PHASES
// The %globaltimer readings of the rows form's launches since the last
// read (kK4sStamps uint64 into host memory; 0 where no block wrote one;
// waits for the card), then reset: the first block's start to the largest
// value, the rest to 0.
extern "C" int sig_expand_phases(unsigned long long* host, int n) {
  if (host == nullptr || n != kK4sStamps) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyFromSymbol(host, g_k4s, sizeof(unsigned long long) * kK4sStamps);
  if (e != cudaSuccess) return (int)e;
  unsigned long long fresh[kK4sStamps] = {};
  fresh[0] = ~0ull;
  return (int)cudaMemcpyToSymbol(g_k4s, fresh, sizeof(fresh));
}
#endif
