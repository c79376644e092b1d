// Expansion of the selected rows of a key-row table (the packed and the
// unpacked layouts): kernel K9.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :497 _expand with g
// given (packed) and with pathmax (unpacked), :1720 _candidates_packed,
// :348 _pack_keys and :360 _hash_keys (XLA inside the run loops :1819 and
// :1999).  The port's plain versions are search/engine.py::_select_packed's
// and _select's row reads, _expand, the prune, _candidates_packed /
// _candidates_unpacked, _pack_keys and _hash_keys.  For each active row of
// the selection (K3's compact list: slot, word) and each move mask m = 1 ..
// 2^N - 1, the edge cost and h of expand_row.cuh (shared with K4) and
//   packed:   coord from the row's key words, g = f(word) - h (column W)
//   unpacked: coord from the row's key words, g = t_g[slot], the parent
//             mask and the parent's f from t_fpar[slot]
//   g_child = g + cost, f_child = g_child + h, on the unpacked layout
//   raised to at least the parent's f (pathmax).
// valid = child <= final; the goal is found BEFORE the upper-bound prune
// (atomicMin on the counters' slot 0), then valid &= f_child <= ub.  Every
// surviving lane appends one entry to the pending list of the insert
// (keyrow_insert.cu, K10) through one atomicAdd per warp: its key words,
// their hash, its claim tag, then
//   packed:   h (= f - g, no pathmax) and the packed word ((f - f0) << n) | m
//   unpacked: g and f * 2^n + m (two words, low first).
// The claim tag is the lane's content tag row_rank * M + m - 1 (row_rank:
// the row's place in K3's list, which is group order): the plain step's
// tag (search/engine.py::_expand_insert), the same whatever order the
// lanes reach the list in.  The round-0 row match is not fused here: K10
// does every round, so counter slots 9-13 are the plain step's.
//
// What bounds it on an H100: a chain of dependent loads, not bytes.  Per
// active row: its list entry, its key row (and t_g, t_fpar), P T8 rows of 32
// B and T x 8 cube corners gathered at random, then per surviving lane its
// pending entry (W + 4 or W + 5 words) written: at globin6 (W = 3, P = 15,
// T = 6) about 2.7 kB a row and 28 B a lane.
//
// Design: K4's schedule.  A fixed grid whose warps stride over the list, a
// warp a row, a lane a mask in passes of 32 (synth10: 1023 masks, 32
// passes); the block stages the constants once and each warp its row's T8
// rows and cube corners (behind __syncwarp, no block barrier in the row
// loop).  kNValid is the list's length: every surviving lane is pending.

#include "expand_row.cuh"
#include "step_state.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxW = 8;  // key words of N <= 16 coordinates
constexpr unsigned kFull = 0xffffffffu;

template <bool kUnpacked>
__global__ void __launch_bounds__(32 * kMaxWarps, kBlocksPerSm) keyrow_expand_kernel(
    const int32_t* __restrict__ t_key, int KWs, const int32_t* __restrict__ t_g,
    const long long* __restrict__ t_fpar, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ tables4, const int32_t* __restrict__ cubes,
    const int32_t* __restrict__ params, int N, int P, int T, int S, int nb, long long f0,
    long long ub, int E, int GG, int gap_oe, const int32_t* __restrict__ run,
    long long* __restrict__ counters, long long* __restrict__ state, int32_t* __restrict__ pend) {
  extern __shared__ int32_t sm[];
  if (*run == 0) return;
  const int n_const = expand::const_words(N, P, T);
  const expand::Consts k = expand::consts_at(sm, N, P, T, S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* s_t8 = sm + n_const + warp * expand::warp_words(N, P, T);
  int32_t* s_cube = s_t8 + 5 * P;
  int32_t* s_coord = s_cube + 8 * T;
  for (int q = tid; q < n_const; q += blockDim.x) sm[q] = params[q];
  __syncthreads();

  const int W = (N + 1) / 2;
  const int PW = W + (kUnpacked ? 5 : 4);  // pending words a lane
  const int M = (1 << N) - 1;
  const long long n_rows = state[step::kNSel];
  const int nw = gridDim.x * (blockDim.x >> 5);
  for (long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp; i < n_rows; i += nw) {
    // 1. the row: its coordinate from the key words, g, the parent mask
    const int2 e = reinterpret_cast<const int2*>(sel)[i];
    const int32_t* row = t_key + (size_t)e.x * KWs;
    if (lane < N) s_coord[lane] = (int32_t)(((uint32_t)row[lane >> 1] >> (16 * (lane & 1))) & 0xFFFFu);
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
    __syncwarp();
    // 2. its T8 rows and cube corners, lanes in parallel
    expand::stage_row(k, tables4, cubes, s_coord, s_t8, s_cube, lane);
    __syncwarp();

    // 3. a lane a mask, 32 masks a pass
    for (int m0 = 1; m0 <= M; m0 += 32) {
      const int m = m0 + lane;
      long long cost, h;
      expand::child_cost_h(k, m, par, E, GG, gap_oe, s_t8, s_cube, cost, h);
      bool valid = m <= M, goal = m <= M;
      int32_t child[2 * kMaxW];
      for (int d = 0; d < N; ++d) {
        child[d] = s_coord[d] + ((m >> d) & 1);
        valid &= child[d] <= k.final_c[d];
        goal &= child[d] == k.final_c[d];
      }
      const long long gc = g + cost;
      long long fc = gc + h;
      if constexpr (kUnpacked) fc = fc > f_par ? fc : f_par;  // pathmax
      if (goal) atomicMin(&counters[step::cGoal], gc);         // before the prune
      valid &= fc <= ub;
      const unsigned ballot = __ballot_sync(kFull, valid);
      int base = 0;
      if (lane == 0 && ballot != 0)
        base = (int)atomicAdd((unsigned long long*)&state[step::kNValid],
                              (unsigned long long)__popc(ballot));
      base = __shfl_sync(kFull, base, 0);
      if (valid) {
        int32_t* out = pend + (size_t)(base + __popc(ballot & ((1u << lane) - 1u))) * PW;
        uint32_t words[kMaxW];
        for (int w = 0; w < W; ++w) {
          words[w] = step::key_word(child, w, N);
          out[w] = (int32_t)words[w];
        }
        out[W] = (int32_t)step::hash_keys(words, W);
        out[W + 1] = (int32_t)(i * M + m - 1);  // the content tag
        if constexpr (kUnpacked) {
          const long long fpar = fc * (1ll << nb) + m;
          out[W + 2] = (int32_t)gc;
          out[W + 3] = (int32_t)(uint32_t)(unsigned long long)fpar;
          out[W + 4] = (int32_t)(fpar >> 32);
        } else {
          out[W + 2] = (int32_t)h;
          out[W + 3] = (int32_t)(((fc - f0) << nb) | m);
        }
      }
    }
    __syncwarp();  // the next row rewrites this warp's staging
  }
}

template <bool kUnpacked>
int launch(const void* t_key, int KWs, const void* t_g, const void* t_fpar, const void* sel,
           const void* tables4, const void* cubes, const void* params, int N, int P, int T,
           int S, int nb, long long f0, long long ub, int E, int GG, int gap_oe, int B,
           const void* run, void* counters, void* state, void* pend, void* stream) {
  // shared words: the constants, then each warp's staging; as many warps
  // (up to kMaxWarps) as 48 KB hold
  const size_t shared_const = (size_t)expand::const_words(N, P, T);
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
  keyrow_expand_kernel<kUnpacked><<<(int)blocks, 32 * (int)warps, shared, (cudaStream_t)stream>>>(
      (const int32_t*)t_key, KWs, (const int32_t*)t_g, (const long long*)t_fpar,
      (const int32_t*)sel, (const int32_t*)tables4, (const int32_t*)cubes,
      (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, (const int32_t*)run,
      (long long*)counters, (long long*)state, (int32_t*)pend);
  return (int)cudaGetLastError();
}

}  // namespace

// t_key: (>= C, KWs) int32 key rows (packed: KWs = W + 1, the last column
// h; unpacked: KWs = W); t_g, t_fpar: the unpacked table's (null when
// packed); unpacked: 0 packed, 1 unpacked; sel: K3's compact list (slot,
// word) as (>= B, 2) int32, its length in state[kNSel]; params: as K4's
// (search/step.py::_kernel_params); run: int32 device flag; counters: the
// 14 int64 counters; state: step_state.cuh (kNValid counts the pending
// lanes); pend: (B * (2^N - 1), W + 4 or W + 5) int32 pending list.  B
// sizes the grid (at most B rows are active).
extern "C" int keyrow_expand(const void* t_key, int KWs, const void* t_g, const void* t_fpar,
                             int unpacked, const void* sel, const void* tables4,
                             const void* cubes, const void* params, int N, int P, int T, int S,
                             int nb, long long f0, long long ub, int E, int GG, int gap_oe,
                             int B, const void* run, void* counters, void* state, void* pend,
                             void* stream) {
  const int W = (N + 1) / 2;
  if (N < 2 || N > 2 * kMaxW || P != N * (N - 1) / 2 || T < 0 || (T > 0 && cubes == nullptr) ||
      S < 2 || nb != N || B < 1 || KWs != W + (unpacked ? 0 : 1) ||
      (unpacked && (t_g == nullptr || t_fpar == nullptr)) ||
      (long long)B * ((1ll << N) - 1) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return unpacked ? launch<true>(t_key, KWs, t_g, t_fpar, sel, tables4, cubes, params, N, P, T,
                                 S, nb, f0, ub, E, GG, gap_oe, B, run, counters, state, pend,
                                 stream)
                  : launch<false>(t_key, KWs, t_g, t_fpar, sel, tables4, cubes, params, N, P, T,
                                  S, nb, f0, ub, E, GG, gap_oe, B, run, counters, state, pend,
                                  stream);
}
