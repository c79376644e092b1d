// Grouped-argmin selection of the three layouts: kernel K3.
//
// Replaces mpi_pastar_msa_tpu/search/engine.py:1620 _select_sig and :1668
// _select_packed (the grouped argmin they share, XLA inside the run loop);
// in the port it is search/engine.py::_select_best, whose plain version
// (_select_best_plain) computes the same thing.  A second instantiation
// (C entry select_best_unpacked) replaces :858 _select, the unpacked
// layout's: search/engine.py::_select_open, plain _select_open_plain; see
// "The unpacked layout" below.  The table (C,) of packed
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
// are B x 17 B and the compact list 8 B an active row.
//
// Design: ONE launch a step, no memset, no atomic on a shared word but the
// ticket.
//  - Read pass: a fixed grid (one 512-thread block a multiprocessor, or as
//    many as fit) whose warps stride over the groups.  For G a multiple of
//    128 a warp takes a group and each lane issues all its 128-bit loads of
//    t_best and t_closed (G / 128 of each, up to kVec) before it reduces
//    them; other G take L = min(32, pow2 <= G) lanes a group and 32 / L
//    groups a warp, with scalar loads.  A lane keeps its min word and, on
//    ties, its first index (it visits its slots in index order); a warp
//    merges the 64-bit keys (word << 32) | index with shuffles, so a plain
//    min is the first-index argmin.  The warp writes its groups' slot and
//    min; the block writes one partial (min, open count) to scratch.
//  - Finish, in the same launch: the last block to take a ticket
//    (__threadfence, then atomicAdd; it resets the ticket to 0) reduces the
//    partials, forms the cut, flags every group, scans the flags (group
//    order, so the same list every run), closes the active slots (read
//    before the write, for the reopen count) and writes the compact list of
//    active rows (slot, word) that K4 walks, the step's state slots and 0
//    in every slot of K4 and K5.
// A null `run` flag runs the selection; a flag that reads 0 (the search
// step loop of search/step.py has stopped) returns every block before it
// touches the ticket.
//
// The unpacked layout (kUnpacked): a slot is open when t_state == 1 and its
// f = t_fpar >> n (arithmetic: f may be negative on degenerate weights) is
// below goal_g.  The read pass keys an open slot by f biased to u32
// ((u32)(int32)f ^ 2^31, which orders negative f first; open f lies in
// int32, below goal_g <= INF = 2^30) and a slot that is not open by INF's
// bias, so the same 64-bit (key << 32) | index min is the first-index
// argmin.  The finish takes fmin = the min of the group mins (INF when
// nothing is open); a group is active when its min f <= fmin + thr; its
// slot gets t_state = 2.  A group that is not active reports index 0 and
// f INF, as the plain argmin over its all-INF row does.  The reopen count
// is 0 (this layout counts reopens in the insert, keyrow_insert.cu), and
// the list entry is (slot, f): K9 reads the row's g and t_fpar itself.  It
// reads 12 B a slot (int32 state, int64 (f, parent)) where the sig select
// reads 8: 100.7 MB at C = 2^23, 30.0 us at 3.35 TB/s.
//
// Built with -DK3_PHASES (a measurement build of chip_smoke.py, never the
// one the port loads), the kernel also leaves three %globaltimer readings
// in partial[0..2] when it ends: block 0's start, the last block's start of
// the finish, and its end.

#include <stdint.h>

#include "step_state.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;    // int4 loads of each table a lane keeps in flight
constexpr int kItems = 16; // groups a thread of the last block flags a round
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// min of 64-bit keys over segments of `width` lanes (a power of two <= 32)
__device__ __forceinline__ unsigned long long seg_min(unsigned long long k, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(kFull, k, o, width);
    k = x < k ? x : k;
  }
  return k;
}

// one slot into a lane's running (min word, its first index) and open count
__device__ __forceinline__ void visit(int32_t w, int32_t c, int nb, long long lim, int idx,
                                      uint32_t& bv, uint32_t& bi, uint32_t& n) {
  const bool open = w < c && (long long)(w >> nb) < lim;
  const uint32_t v = open ? (uint32_t)w : (uint32_t)step::kInfp;
  n += open;
  if (v < bv) {
    bv = v;
    bi = (uint32_t)idx;
  }
}

// the unpacked layout: one slot (state, f * 2^n + parent) into the same
// running min, keyed by f's u32 bias (kNoneOpen where it is not open)
constexpr uint32_t kBias = 0x80000000u;
constexpr uint32_t kNoneOpen = (uint32_t)step::kInf ^ kBias;
__device__ __forceinline__ void visit_open(int32_t s, long long fp, int nb, long long goal,
                                           int idx, uint32_t& bv, uint32_t& bi, uint32_t& n) {
  const long long f = fp >> nb;
  const bool open = s == 1 && f < goal;
  const uint32_t v = open ? (uint32_t)(int32_t)f ^ kBias : kNoneOpen;
  n += open;
  if (v < bv) {
    bv = v;
    bi = (uint32_t)idx;
  }
}

// exclusive scan of one int a thread over the block; returns the prefix,
// `total` gets the sum.  Syncs the block.
__device__ __forceinline__ int block_scan(int x, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kWarps ? wsum[lane] : 0;
    int si = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, si, o);
      if (lane >= o) si += y;
    }
    if (lane < kWarps) wsum[lane] = si - s;
    if (lane == 31) *total = si;
  }
  __syncthreads();
  return wsum[warp] + inc - x;
}

// best, closed: the sig and packed tables (null when kUnpacked); tstate,
// fpar: the unpacked table's t_state and t_fpar (null otherwise)
template <bool kUnpacked>
__global__ void __launch_bounds__(kThreads, 1) select_kernel(
    const int32_t* __restrict__ best, int32_t* __restrict__ closed, int32_t* __restrict__ tstate,
    const long long* __restrict__ fpar, int B, int G, int vec, int nb, long long f0,
    const long long* __restrict__ goal, const long long* __restrict__ thr,
    const int32_t* __restrict__ run, long long* __restrict__ slots, long long* __restrict__ vmin,
    uint8_t* __restrict__ active, int32_t* __restrict__ sel, long long* __restrict__ partial,
    unsigned* __restrict__ ticket, long long* __restrict__ state) {
  constexpr uint32_t kNone = kUnpacked ? kNoneOpen : (uint32_t)step::kInfp;
  __shared__ uint32_t s_min[kWarps];
  __shared__ uint32_t s_cnt[kWarps];
  __shared__ int s_off[kItems * kWarps];
  __shared__ int s_wsum[32];
  __shared__ int s_total;
  __shared__ int s_last;
  if (run != nullptr && *run == 0) return;
#ifdef K3_PHASES
  const long long t_start = globaltimer();
#endif
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long lim = kUnpacked ? *goal : *goal - f0;
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;
  uint32_t wmin = kNone, wopen = 0;

  // 1. read pass
  if (vec) {
    // a warp a group: all G / 128 int4 of each table a lane (up to kVec at
    // a time; the unpacked t_fpar is two int4 for 4 slots) in flight before
    // the reduction
    const int nq = G >> 2;
    for (int b = gw; b < B; b += nw) {
      uint32_t bv = kNone, bi = 0, n = 0;
      if constexpr (kUnpacked) {
        const int4* ps = reinterpret_cast<const int4*>(tstate + (size_t)b * G);
        const longlong2* pf = reinterpret_cast<const longlong2*>(fpar + (size_t)b * G);
        constexpr int kV = kVec / 2;
        for (int q0 = 0; q0 < nq; q0 += 32 * kV) {
          int4 ws[kV];
          longlong2 f0v[kV], f1v[kV];
#pragma unroll
          for (int i = 0; i < kV; ++i) {
            const int q = q0 + lane + 32 * i;
            if (q < nq) {
              ws[i] = ps[q];
              f0v[i] = pf[2 * q];
              f1v[i] = pf[2 * q + 1];
            }
          }
#pragma unroll
          for (int i = 0; i < kV; ++i) {
            const int q = q0 + lane + 32 * i;
            if (q < nq) {
              visit_open(ws[i].x, f0v[i].x, nb, lim, 4 * q, bv, bi, n);
              visit_open(ws[i].y, f0v[i].y, nb, lim, 4 * q + 1, bv, bi, n);
              visit_open(ws[i].z, f1v[i].x, nb, lim, 4 * q + 2, bv, bi, n);
              visit_open(ws[i].w, f1v[i].y, nb, lim, 4 * q + 3, bv, bi, n);
            }
          }
        }
      } else {
        const int4* pb = reinterpret_cast<const int4*>(best + (size_t)b * G);
        const int4* pc = reinterpret_cast<const int4*>(closed + (size_t)b * G);
        for (int q0 = 0; q0 < nq; q0 += 32 * kVec) {
          int4 wb[kVec], wc[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int q = q0 + lane + 32 * i;
            if (q < nq) {
              wb[i] = pb[q];
              wc[i] = pc[q];
            }
          }
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int q = q0 + lane + 32 * i;
            if (q < nq) {
              visit(wb[i].x, wc[i].x, nb, lim, 4 * q, bv, bi, n);
              visit(wb[i].y, wc[i].y, nb, lim, 4 * q + 1, bv, bi, n);
              visit(wb[i].z, wc[i].z, nb, lim, 4 * q + 2, bv, bi, n);
              visit(wb[i].w, wc[i].w, nb, lim, 4 * q + 3, bv, bi, n);
            }
          }
        }
      }
      const unsigned long long key = seg_min(((unsigned long long)bv << 32) | bi, 32);
      wopen += n;
      if (lane == 0) {
        slots[b] = (long long)b * G + (long long)(key & 0xffffffffu);
        vmin[b] = (long long)(key >> 32);
      }
      wmin = min(wmin, (uint32_t)(key >> 32));
    }
  } else {
    // L lanes a group, 32 / L groups a warp
    const int L = G >= 32 ? 32 : 1 << (31 - __clz(G));
    const int gpw = 32 / L, seg = lane / L, sl = lane % L;
    for (long long t = gw; t * gpw < B; t += nw) {
      const long long b = t * gpw + seg;
      uint32_t bv = kNone, bi = 0, n = 0;
      if (b < B) {
        if constexpr (kUnpacked) {
          const int32_t* ps = tstate + b * G;
          const long long* pf = fpar + b * G;
          for (int j = sl; j < G; j += L) visit_open(ps[j], pf[j], nb, lim, j, bv, bi, n);
        } else {
          const int32_t* pb = best + b * G;
          const int32_t* pc = closed + b * G;
          for (int j = sl; j < G; j += L) visit(pb[j], pc[j], nb, lim, j, bv, bi, n);
        }
      }
      const unsigned long long key = seg_min(((unsigned long long)bv << 32) | bi, L);
      wopen += n;
      if (b < B) {
        if (sl == 0) {
          slots[b] = b * G + (long long)(key & 0xffffffffu);
          vmin[b] = (long long)(key >> 32);
        }
        wmin = min(wmin, (uint32_t)(key >> 32));
      }
    }
  }
  wmin = __reduce_min_sync(kFull, wmin);
  wopen = __reduce_add_sync(kFull, wopen);
  if (lane == 0) {
    s_min[warp] = wmin;
    s_cnt[warp] = wopen;
  }
  __threadfence();  // this block's slots and mins before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m = kNone;
    long long c = 0;
    for (int w = 0; w < kWarps; ++w) {
      m = min(m, s_min[w]);
      c += s_cnt[w];
    }
    partial[2 * blockIdx.x] = m;
    partial[2 * blockIdx.x + 1] = c;
#ifdef K3_PHASES
    if (blockIdx.x == 0) partial[2 * gridDim.x] = t_start;
#endif
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // 2. finish: the last block.  Reads of what other blocks wrote in this
  // launch go to L2 (__ldcg).
  __threadfence();
#ifdef K3_PHASES
  const long long t_finish = globaltimer();
  const long long t_first = __ldcg(&partial[2 * gridDim.x]);
#endif
  uint32_t m = kNone;
  long long c = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    m = min(m, (uint32_t)__ldcg(&partial[2 * i]));
    c += __ldcg(&partial[2 * i + 1]);
  }
  m = __reduce_min_sync(kFull, m);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  __syncthreads();
  if (lane == 0) {
    s_min[warp] = m;
    s_cnt[warp] = (uint32_t)c;  // open words <= C <= 2^31
  }
  __syncthreads();
  long long n_open = 0;
  for (int w = 0; w < kWarps; ++w) {
    m = min(m, s_min[w]);
    n_open += s_cnt[w];
  }
  // sig and packed: the cut on packed words; unpacked: fmin (INF when
  // nothing is open) and the cut on f
  const long long fmin_r = kUnpacked ? (long long)(int32_t)(m ^ kBias) : (long long)m >> nb;
  long long cut;
  if constexpr (kUnpacked) {
    cut = fmin_r + *thr;
  } else {
    long long lim_f = fmin_r + *thr + 1;
    if (lim_f > (step::kInfp >> nb)) lim_f = step::kInfp >> nb;
    cut = (lim_f << nb) - 1;
  }

  // rounds of kItems groups a thread: b = r0 + k * kThreads + thread
  const int32_t* vmin32 = reinterpret_cast<const int32_t*>(vmin);  // low words
  const int32_t* slots32 = reinterpret_cast<const int32_t*>(slots);  // slots < 2^31
  int base = 0;
  uint32_t n_re = 0;
  for (int r0 = 0; r0 < B; r0 += kItems * kThreads) {
    int32_t v[kItems], s[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int b = r0 + k * kThreads + threadIdx.x;
      v[k] = b < B ? __ldcg(&vmin32[2 * b]) : (int32_t)kNone;
      s[k] = b < B ? __ldcg(&slots32[2 * b]) : 0;
    }
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int b = r0 + k * kThreads + threadIdx.x;
      bool act;
      if constexpr (kUnpacked) {
        // the key back to f; a group with nothing open holds kNoneOpen
        v[k] = (int32_t)((uint32_t)v[k] ^ kBias);
        act = (uint32_t)v[k] != (uint32_t)step::kInf && (long long)v[k] <= cut;
      } else {
        act = v[k] <= cut;  // an empty group holds INFP > cut
      }
      if (b < B) {
        active[b] = act;
        if constexpr (kUnpacked) {
          vmin[b] = act ? (long long)v[k] : step::kInf;
          if (!act) slots[b] = (long long)b * G;
        } else if (!act) {
          vmin[b] = step::kInfp;
        }
      }
      bits |= (uint32_t)act << k;
      const unsigned bal = __ballot_sync(kFull, act);
      if (lane == 0) s_off[k * kWarps + warp] = __popc(bal);
    }
    __syncthreads();
    // the list position of each (k, warp) run, in group order
    const int e = threadIdx.x;
    const int cnt = e < kItems * kWarps ? s_off[e] : 0;
    const int pre = block_scan(cnt, s_wsum, &s_total);
    if (e < kItems * kWarps) s_off[e] = base + pre;
    __syncthreads();
    base += s_total;
    int32_t old[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      old[k] = (!kUnpacked && (bits >> k & 1)) ? closed[s[k]] : (int32_t)step::kInfp;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool act = bits >> k & 1;
      const unsigned bal = __ballot_sync(kFull, act);
      if (act) {
        const int at = s_off[k * kWarps + warp] + __popc(bal & ((1u << lane) - 1u));
        n_re += old[k] < step::kInfp;
        if constexpr (kUnpacked)
          tstate[s[k]] = 2;
        else
          closed[s[k]] = v[k];
        reinterpret_cast<int2*>(sel)[at] = make_int2(s[k], v[k]);
      }
    }
    __syncthreads();  // s_off and s_total are rewritten by the next round
  }
  n_re = __reduce_add_sync(kFull, n_re);
  if (lane == 0) s_cnt[warp] = n_re;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long re = 0;
    for (int w = 0; w < kWarps; ++w) re += s_cnt[w];
    state[step::kGmax] = kNone - (long long)m;
    state[step::kNOpen] = n_open;
    state[step::kNSel] = base;
    state[step::kReopen] = re;
    state[step::kFmin] = fmin_r + f0;
    *ticket = 0;
#ifdef K3_PHASES
    partial[0] = t_first;
    partial[1] = t_finish;
    partial[2] = globaltimer();
#endif
  }
  for (int k = step::kNValid + threadIdx.x; k < step::kWords; k += kThreads) state[k] = 0;
}

// co-resident blocks of an instantiation on the card (one card a process)
template <bool kUnpacked>
cudaError_t resident_blocks(int* most) {
  if (*most != 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select_kernel<kUnpacked>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  *most = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// The launch shared by both C entries: a and b are best and closed, or
// t_state and t_fpar.
template <bool kUnpacked>
int launch(const void* a, void* b, int C, int B, int nb, long long f0, const void* goal,
           const void* thr, const void* run, void* slots, void* vmin, void* active, void* sel,
           void* partial, int max_blocks, void* ticket, void* state, void* stream) {
  if (B < 1 || C < B || C % B != 0 || nb < 1 || nb > 30 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  static int most = 0;
  const cudaError_t e = resident_blocks<kUnpacked>(&most);
  if (e != cudaSuccess) return (int)e;
  const int G = C / B;
  const int vec = G % 128 == 0 && (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
  const int L = G >= 32 ? 32 : 1 << (31 - __builtin_clz((unsigned)G));
  const long long tasks = vec ? B : (B + 32 / L - 1) / (32 / L);
  long long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > most) blocks = most;
#ifdef K3_PHASES
  if (blocks > max_blocks - 1) blocks = max_blocks - 1;  // room for block 0's start
#else
  if (blocks > max_blocks) blocks = max_blocks;
#endif
  select_kernel<kUnpacked><<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      kUnpacked ? nullptr : (const int32_t*)a, kUnpacked ? nullptr : (int32_t*)b,
      kUnpacked ? (int32_t*)a : nullptr, kUnpacked ? (const long long*)b : nullptr, B, G, vec,
      nb, f0, (const long long*)goal, (const long long*)thr, (const int32_t*)run,
      (long long*)slots, (long long*)vmin, (uint8_t*)active, (int32_t*)sel, (long long*)partial,
      (unsigned*)ticket, (long long*)state);
  return (int)cudaGetLastError();
}

}  // namespace

// best, closed: (>= C,) int32 tables; goal, thr: int64 device scalars;
// run: int32 device flag or null; slots, vmin: (B,) int64 and active: (B,)
// uint8 outputs; sel: (B, 2) int32 compact list of the active rows (slot,
// word), its length in state[kNSel]; partial: (max_blocks, 2) int64
// scratch; ticket: one uint32, 0 before the launch and after it; state:
// (step::kWords,) int64, every slot written here.
extern "C" int select_best(const void* best, void* closed, int C, int B, int nb, long long f0,
                           const void* goal, const void* thr, const void* run, void* slots,
                           void* vmin, void* active, void* sel, void* partial, int max_blocks,
                           void* ticket, void* state, void* stream) {
  return launch<false>(best, closed, C, B, nb, f0, goal, thr, run, slots, vmin, active, sel,
                       partial, max_blocks, ticket, state, stream);
}

// The unpacked layout: t_state (>= C,) int32, closed in place; t_fpar (>=
// C,) int64; vmin gets the picked f (INF where inactive); sel (B, 2) int32
// (slot, f); the rest as select_best.
extern "C" int select_best_unpacked(void* t_state, const void* t_fpar, int C, int B, int nb,
                                    const void* goal, const void* thr, const void* run,
                                    void* slots, void* vmin, void* active, void* sel,
                                    void* partial, int max_blocks, void* ticket, void* state,
                                    void* stream) {
  return launch<true>(t_state, const_cast<void*>(t_fpar), C, B, nb, 0, goal, thr, run, slots,
                      vmin, active, sel, partial, max_blocks, ticket, state, stream);
}
