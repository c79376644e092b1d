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
};

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

// t_sig, t_best: the sig table; sel: K3's compact list of active rows
// (slot, packed word) as (>= B, 2) int32, its length in state[kNSel];
// params: int32 [xs P, ys P, w P, w_h P, triangles 3T, final N, bit widths
// N] (search/step.py::_kernel_params); run: int32 device flag; counters:
// the 14 int64 counters; state: step_state.cuh; pend: (B * (2^N - 1), 3)
// int32 pending list.  B sizes the grid (at most B rows are active).
// Every launch carries a programmatic edge from the kernel before it (K3
// in a chunk step, search/step.py): the kernel waits for it first thing.
template <bool kSharded>
int launch(const void* t_sig, void* t_best, const void* sel, const void* tables4,
           const void* cubes, const void* params, int N, int P, int T, int S, int nb,
           long long f0, long long ub, int E, int GG, int gap_oe, int bbits, int B,
           const void* run, void* counters, void* state, void* pend, Sharded sh, void* stream) {
  const bool h3 = kSharded && sh.h3 != nullptr;
  if (N < 2 || N > kMaxN || P != N * (N - 1) / 2 || T < 0 || (T > 0 && cubes == nullptr && !h3) ||
      S < 2 || nb != N || bbits < 1 || bbits > 28 || B < 1)
    return (int)cudaErrorInvalidValue;
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
                       GG, gap_oe, bbits, B, run, counters, state, pend, Sharded{}, stream);
}

// The sharded instantiation: sig_expand's arguments, then h3 ((B, M + 1)
// int32, or null: the shard reads its own cubes, cubes then non-null when
// T > 0), cand ((B M, 4) int32), the owner hash (kind, size, shift, zbits:
// parallel/partition.py::owner_params), ndev (= the hash's size) and this
// shard's index me; pend points where the self-owned pending lanes go.
extern "C" int sig_expand_sharded(const void* t_sig, void* t_best, const void* sel,
                                  const void* tables4, const void* cubes, const void* params,
                                  int N, int P, int T, int S, int nb, long long f0,
                                  long long ub, int E, int GG, int gap_oe, int bbits, int B,
                                  const void* run, void* counters, void* state, void* pend,
                                  const void* h3, void* cand, int hash_kind, int hash_size,
                                  int hash_shift, int zbits, int ndev, int me, void* stream) {
  if (cand == nullptr || ndev < 1 || me < 0 || me >= ndev || hash_size != ndev ||
      hash_kind < 0 || hash_kind > 3 || hash_shift < 0 || hash_shift > 31 || zbits < 1 ||
      zbits > 32)
    return (int)cudaErrorInvalidValue;
  const Sharded sh{(const int32_t*)h3, (int32_t*)cand,
                   owner::Hash{hash_kind, hash_size, hash_shift, zbits}, ndev, me};
  return launch<true>(t_sig, t_best, sel, tables4, cubes, params, N, P, T, S, nb, f0, ub, E,
                      GG, gap_oe, bbits, B, run, counters, state, pend, sh, stream);
}
