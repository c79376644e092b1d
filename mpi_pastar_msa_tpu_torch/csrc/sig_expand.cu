// Expansion of the selected rows, sig encoding and the round-0 row match of
// the insert: kernel K4.
//
// Replaces, in mpi_pastar_msa_tpu/search/engine.py, :442 _sig_decode, :497
// _expand, :1724 _candidates_sig -> :400 _sig_encode and the round-0
// lookup of :1441 _insert_core_sig (XLA inside the run loop).  The port's
// plain versions are search/engine.py::_sig_decode, _expand (g_is_f),
// _candidates_sig, _sig_encode and the round 0 of _insert_sig.  For each
// active row b of the selection and each move mask m = 1 .. 2^N - 1:
//   cost = sum_p w_p (GG + (E - GG)(bx + by) + bx by (mm_p + GG - 2E))
//          + (O - E) sum_p w_p (bx (1 - by) par_y + (1 - bx) by par_x)
//   h    = sum_p wh_p T8[p][2 bx + by] + sum_t cube_t[corner(t, m)]
//   g    = f(row) - h(row) + cost,  f = g + h,  child = coord + bits(m),
// summed in 64 bits as the plain version does (.long()).  This is the
// plain version's c0 + c1[m] + sum_p both w (mm + GG - 2E) written per pair:
// the same integers.  valid = child <= final; the goal is found BEFORE the
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
// What bounds it on an H100: bytes, and few of them.  Per active row: its
// slot's sig word, P T8 rows of 32 B (24.7 MB table at kinase, gathered at
// random) and T x 8 cube corners (343.8 MB stack); per surviving lane one
// 32 B bucket row and 4 or 12 B written.  About 6 MB at a kinase step.
//
// Design: one block per row of the batch (B blocks; an inactive row returns
// at once, so nothing is compacted on the host), one thread per mask
// (kinase: 31 masks, one warp).  The block decodes its coordinate from
// (slot, t_sig[slot]), stages the row's T8 rows and cube corners in shared
// memory once, and every mask reads them from there.  Sig words need u32
// arithmetic, which CUDA has: the child's key is one u64 (sig_bits <= 53),
// klo its low bbits, khi the next 32 bits.  Stored words are
// (khi << 6) | r < 2^31, because the sig layout is taken only where
// sig_bits - bbits <= 25 (engine.py::_Static.sig_ok).

#include "step_state.cuh"

namespace {

constexpr uint32_t kSigOdd = 0x9E3779B1u;     // engine.py::_SIG_ODD
constexpr uint32_t kSigOddInv = 0x0E8B2F51u;  // its inverse mod 2^32

__global__ void sig_expand_kernel(
    const int32_t* __restrict__ t_sig, int32_t* __restrict__ t_best,
    const long long* __restrict__ slots, const long long* __restrict__ vmin,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ tables4,
    const int32_t* __restrict__ cubes, const int32_t* __restrict__ params, int N, int P, int T,
    int S, int nb, long long f0, long long ub, int E, int GG, int gap_oe, int bbits,
    const int32_t* __restrict__ run, long long* __restrict__ counters,
    long long* __restrict__ state, int32_t* __restrict__ pend) {
  extern __shared__ int32_t sm[];
  __shared__ long long red[32];
  if (*run == 0) return;
  const int b = blockIdx.x;
  if (!active[b]) return;
  int32_t* s_xs = sm;
  int32_t* s_ys = s_xs + P;
  int32_t* s_w = s_ys + P;
  int32_t* s_wh = s_w + P;
  int32_t* s_tri = s_wh + P;
  int32_t* s_final = s_tri + 3 * T;
  int32_t* s_bitw = s_final + N;
  int32_t* s_shift = s_bitw + N;
  int32_t* s_coord = s_shift + N;
  int32_t* s_t8 = s_coord + N;
  int32_t* s_cube = s_t8 + 5 * P;
  const int tid = threadIdx.x;

  // 1. the constants: pairs, weights, triangles, final coordinate, widths
  for (int k = tid; k < 4 * P + 3 * T + 2 * N; k += blockDim.x) sm[k] = params[k];
  __syncthreads();
  // 2. the row's coordinate from (slot, stored sig word): _sig_decode
  const long long slot = slots[b];
  if (tid == 0) {
    const uint32_t Bmask = (1u << bbits) - 1u;
    const uint32_t sig = (uint32_t)t_sig[slot];
    const uint32_t r = sig & 63u, khi = sig >> 6;
    const uint32_t home = ((uint32_t)(slot >> 3) - r) & Bmask;
    const uint32_t klo = ((home ^ (step::mix32(khi) & Bmask)) * kSigOddInv) & Bmask;
    const unsigned long long key = (unsigned long long)klo | ((unsigned long long)khi << bbits);
    int sh = 0;
    for (int i = 0; i < N; ++i) {
      s_shift[i] = sh;
      s_coord[i] = (int32_t)((key >> sh) & ((1ull << s_bitw[i]) - 1));
      sh += s_bitw[i];
    }
  }
  __syncthreads();
  // 3. the row's T8 rows (4 pair-table cells and the residue cost) and the
  //    8 corners of each cube around it
  const size_t SS = (size_t)S * S;
  for (int p = tid; p < P; p += blockDim.x) {
    const int cx = min(max(s_coord[s_xs[p]], 0), S - 2);
    const int cy = min(max(s_coord[s_ys[p]], 0), S - 2);
    const int32_t* row = tables4 + ((size_t)p * SS + (size_t)cx * S + cy) * 8;
    for (int k = 0; k < 5; ++k) s_t8[5 * p + k] = row[k];
  }
  for (int q = tid; q < 8 * T; q += blockDim.x) {
    const int t = q >> 3;
    const int cx = min(max(s_coord[s_tri[3 * t]], 0), S - 2) + ((q >> 2) & 1);
    const int cy = min(max(s_coord[s_tri[3 * t + 1]], 0), S - 2) + ((q >> 1) & 1);
    const int cz = min(max(s_coord[s_tri[3 * t + 2]], 0), S - 2) + (q & 1);
    s_cube[q] = cubes[(size_t)t * SS * S + ((size_t)cx * S + cy) * S + cz];
  }
  __syncthreads();

  // 4. the parent: h from the k = 0 cells and corner 0; the table holds f
  long long h_par = 0;
  for (int p = 0; p < P; ++p) h_par += (long long)s_t8[5 * p] * s_wh[p];
  for (int t = 0; t < T; ++t) h_par += s_cube[8 * t];
  const long long v = vmin[b];
  const int par = (int)(v & ((1ll << nb) - 1));
  const long long g = (v >> nb) + f0 - h_par;

  // 5. one mask a thread
  const uint32_t Bmask = (1u << bbits) - 1u;
  const int M = (1 << N) - 1;
  const int lane = tid & 31;
  long long n_valid = 0;
  for (int m0 = 1; m0 <= M; m0 += blockDim.x) {
    const int m = m0 + tid;
    long long cost = 0, h = 0;
    for (int p = 0; p < P; ++p) {
      const int bx = (m >> s_xs[p]) & 1, by = (m >> s_ys[p]) & 1;
      const long long w = s_w[p];
      cost += w * (GG + (long long)(E - GG) * (bx + by) +
                   (long long)(bx & by) * ((long long)s_t8[5 * p + 4] + GG - 2 * E));
      if (gap_oe != 0)
        cost += (long long)gap_oe * w *
                (bx * (1 - by) * ((par >> s_ys[p]) & 1) + (1 - bx) * by * ((par >> s_xs[p]) & 1));
      h += (long long)s_t8[5 * p + 2 * bx + by] * s_wh[p];
    }
    for (int t = 0; t < T; ++t) {
      const int corner = 4 * ((m >> s_tri[3 * t]) & 1) + 2 * ((m >> s_tri[3 * t + 1]) & 1) +
                         ((m >> s_tri[3 * t + 2]) & 1);
      h += s_cube[8 * t + corner];
    }
    bool valid = m <= M, goal = m <= M;
    unsigned long long key = 0;
    for (int i = 0; i < N; ++i) {
      const int c = s_coord[i] + ((m >> i) & 1);
      valid &= c <= s_final[i];
      goal &= c == s_final[i];
      key |= (unsigned long long)c << s_shift[i];
    }
    const long long gc = g + cost, fc = gc + h;
    if (goal) atomicMin(&counters[step::cGoal], gc);  // before the prune
    valid &= fc <= ub;
    n_valid += valid;
    bool pending = false;
    uint32_t home = 0, sigb = 0;
    int32_t packed = 0;
    if (valid) {
      const uint32_t klo = (uint32_t)key & Bmask, khi = (uint32_t)(key >> bbits);
      home = ((klo * kSigOdd) & Bmask) ^ (step::mix32(khi) & Bmask);
      sigb = khi << 6;
      packed = (int32_t)(((fc - f0) << nb) | m);
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
    const unsigned ballot = __ballot_sync(0xffffffffu, pending);
    int base = 0;
    if (lane == 0 && ballot != 0)
      base = (int)atomicAdd((unsigned long long*)&state[step::kNPend],
                            (unsigned long long)__popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (pending) {
      const int at = base + __popc(ballot & ((1u << lane) - 1u));
      pend[3 * at] = (int32_t)home;
      pend[3 * at + 1] = (int32_t)sigb;
      pend[3 * at + 2] = packed;
    }
  }
  const long long total = step::block_sum(n_valid, red);
  if (tid == 0) atomicAdd((unsigned long long*)&state[step::kNValid], (unsigned long long)total);
}

}  // namespace

// params: int32 [xs P, ys P, w P, w_h P, triangles 3T, final N, bit widths
// N] (search/step.py::_kernel_params).  slots, vmin, active: the select's
// outputs; run: int32 device flag; counters: the 14 int64 counters; state:
// step_state.cuh; pend: (B * (2^N - 1), 3) int32 pending list.
extern "C" int sig_expand(const void* t_sig, void* t_best, const void* slots, const void* vmin,
                          const void* active, const void* tables4, const void* cubes,
                          const void* params, int N, int P, int T, int S, int nb, long long f0,
                          long long ub, int E, int GG, int gap_oe, int bbits, int B,
                          int threads, const void* run, void* counters, void* state, void* pend,
                          void* stream) {
  if (N < 2 || N > 24 || P != N * (N - 1) / 2 || T < 0 || (T > 0 && cubes == nullptr) ||
      S < 2 || nb != N || bbits < 1 || bbits > 28 || B < 1 || threads < 32 ||
      threads > 256 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(int32_t) * (9 * (size_t)P + 11 * (size_t)T + 4 * (size_t)N);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  sig_expand_kernel<<<B, threads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)t_sig, (int32_t*)t_best, (const long long*)slots, (const long long*)vmin,
      (const uint8_t*)active, (const int32_t*)tables4, (const int32_t*)cubes,
      (const int32_t*)params, N, P, T, S, nb, f0, ub, E, GG, gap_oe, bbits,
      (const int32_t*)run, (long long*)counters, (long long*)state, (int32_t*)pend);
  return (int)cudaGetLastError();
}
