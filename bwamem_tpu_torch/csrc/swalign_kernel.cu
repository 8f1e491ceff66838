// Batched local Smith-Waterman with start positions (ksw_align2
// semantics), for Hopper (sm_90a). The mate-rescue DP of paired-end
// alignment and the per-seed SW filter of long reads.
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/pallas/swalign_kernel.py
// (_make_sw_kernel, launched twice by _sw_pallas_impl from
// sw_align_batch_pallas_stacked, with the score2 window and the reverse
// gathers in XLA between the launches; here one launch does all of it).
// The contract is bwamem_tpu/ops/swalign.py:sw_align_batch: affine gaps,
// 5x5 score matrix, E from the previous row's H, F closed along the row.
// Per job it reports
//   score  the best cell; qe, te its 0-based column and row. A row's max
//          goes to its EARLIEST column; best moves only on a strict
//          improvement, so the EARLIEST row wins a tie. qe = te = -1 when
//          score is 0;
//   score2 the largest row max >= minsc over rows outside
//          te +- ceil(score / a), 0 when there is none (rows past tlen
//          count 0);
//   qb, tb from a reverse sweep over q[qe..0] and t[te..0]: qe - rqe and
//          te - rte when the reverse best equals score, else -1. With
//          rev_skip > 0, jobs whose score is below rev_skip skip the
//          reverse sweep and report qb = tb = -1.
//
// What bounds it: integer work along a serial chain of target rows; a job
// reads QMAX + TMAX bytes and writes 24, so bytes are no limit. The
// floor is the instructions a live cell needs (about 8 on 32-bit cells,
// half that on 16-bit pairs); above it sit the per-row chain (the
// diagonal's shuffle, F's carry scan, the row max's reduction) and the
// lanes a job leaves idle.
//
// Design (K1's moves, csrc/extend_kernel.cu, carried over):
//   * Work follows each job's qlen. Three small kernels bin the jobs on
//     the device (job_bins.cuh: width class, 16-bit or not, rows); a job
//     of qlen columns takes a group of G lanes of S columns each, the
//     smallest class that holds it ((4, 8) .. (32, 32) for 32 .. 1024
//     columns). Lane r holds columns r*S .. r*S + S - 1. Persistent warps
//     walk the units of a strip width widest first, one kernel per strip
//     width, in turn on the caller's stream (the main paths' jobs sit in
//     the S = 8 classes: 100-200 columns). G is a compile-time constant
//     of each unit's code: with G known only at run time the compiler
//     guarded every shuffle of the row loop (BSSY/WARPSYNC), about 110
//     of its 333 SASS instructions.
//   * 16-bit cells, two jobs a group, on strips of up to 8 columns when
//     every job of the warp's unit passes fits_i16 (the wrapper's
//     predicate, built again on the device): job A in the low halves of
//     the lanes' words, job B in the high halves. A cell is a few DPX
//     int16x2 instructions: E' = max(E - e_del, H - oe_del, 0), H' =
//     max(hd + s, E', 0) in one __viaddmax_s16x2_relu, F's step x' =
//     max(x - e_ins, max(H' - oe_ins, 0)), H = max(H', x). Other jobs
//     take int32 cells, one job a group, in the same launch.
//   * The score comes from a byte profile of the lane's query columns,
//     one 32-bit shared-memory word per four columns and target base,
//     read once per row. Columns past qlen score -128: they feed no live
//     column and stay below the live ones, and they stay out of the row
//     max (a mask).
//   * The row max and its earliest column are one key, value << 11 |
//     (2047 - column), reduced by __reduce_max_sync for a whole-warp
//     group, else in log2(G) xor shuffles. The lane that leads the group
//     keeps each row max in the warp's slice of dynamic shared memory for
//     score2: 16 bits for a 16-bit job. A block holds as many warps as
//     those slices fit; past 14528 target rows the wrapper gives a global
//     buffer instead.
//   * The reverse sweep runs only for jobs past rev_skip, on the job's own
//     class, and stops at the first row whose max reaches score: no
//     reverse cell can exceed it (a reverse local alignment is a forward
//     one), so that row is the reverse best's earliest.
//   * A matrix outside int8 runs the int32 cells with the score from the
//     shared 5x5 matrix and a 64-bit key.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/kernels/build.py).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "job_bins.cuh"

namespace {

using jobbins::kFits16;
using jobbins::kRegClasses;

constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // warps per block, at most
constexpr int kPairMaxS = 8;  // strips up to this take two jobs a group
constexpr int kKeyBits = 11;
constexpr int kColMask = (1 << kKeyBits) - 1;
constexpr int kDeadScore = -128;  // a column past qlen
constexpr int kMaxSmemBytes = 232448;  // 227 KB a block may use on sm_90
constexpr uint32_t kMinW = 0x80008000u;  // -32768 in both halves
constexpr int kNeg16 = -(1 << 14);

template <int S>
constexpr int kPerGroup = S <= kPairMaxS ? 2 : 1;

// (S, G) of K2's width classes (job_bins.cuh's classes of at most 32, 64,
// 128, 256, 512 and 1024 columns)
__host__ __device__ constexpr int class_S(int c) {
  return c == 0 ? 4 : c <= 3 ? 8 : c == 4 ? 16 : 32;
}
__host__ __device__ constexpr int class_G(int c) {
  return c <= 1 ? 8 : c == 2 ? 16 : 32;
}

// the least G of the classes of strip width S: it sets the groups a warp
// holds, and so the row-max slices it needs
__host__ __device__ constexpr int min_G(int S) {
  int g = 32;
  for (int c = 0; c < jobbins::kRegClasses; ++c)
    if (class_S(c) == S && class_G(c) < g) g = class_G(c);
  return g;
}

struct Params {
  const int8_t* q;
  const int8_t* t;
  const int* qlen;
  const int* tlen;
  const int* minsc;
  const int* mat;
  const int* order;
  const int* counts;
  int* rowmax;  // null: row maxima in shared memory; else TMAX ints a job
  int* out;
  int N, QMAX, TMAX;
  int o_del, e_del, o_ins, e_ins, a, rev_skip;
};

__device__ __forceinline__ int clamp04(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

// signed byte k of w
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  return (int)(int8_t)(w >> (8 * k));
}

__device__ __forceinline__ uint32_t pk16(int lo, int hi) {
  return (uint32_t)(lo & 0xffff) | ((uint32_t)hi << 16);
}
__device__ __forceinline__ int lo16(uint32_t w) { return (int16_t)(w & 0xffff); }
__device__ __forceinline__ int hi16(uint32_t w) { return (int16_t)(w >> 16); }

// byte j of a and byte j of b, each sign-extended to 16 bits, as a pair
template <int j>
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = j | ((8 | j) << 4) | ((4 + j) << 8) |
                           ((8 | (4 + j)) << 12);
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "n"(sel));
  return d;
}

// one sweep of one job: query column j at qp[qstep * j] (j < qcol), target
// row i at tp[tstep * i] (i < rows); the sweep stops early once best
// reaches `stop`
struct Sweep {
  const int8_t* qp;
  const int8_t* tp;
  int qstep, tstep, qcol, rows, stop;
  int best, qe, te;
};

__device__ __forceinline__ void sweep_init(Sweep& w, const int8_t* qp,
                                           int qstep, int qcol,
                                           const int8_t* tp, int tstep,
                                           int rows, int stop) {
  w.qp = qp;
  w.qstep = qstep;
  w.qcol = qcol;
  w.tp = tp;
  w.tstep = tstep;
  w.rows = rows;
  w.stop = stop;
  w.best = 0;
  w.qe = w.te = -1;
}

__device__ __forceinline__ int trow_code(const Sweep& w, int i) {
  // the load stays inside the job's target row (TMAX >= 1) either way
  const int c = w.tp[(ptrdiff_t)w.tstep * min(i, max(w.rows - 1, 0))];
  return i < w.rows ? clamp04(c) : 4;
}

// the score profile of a lane's S columns (from j0) for one job into
// region `reg` of the warp's profile: word k of base b holds the scores of
// columns j0 + 4k .. j0 + 4k + 3 against base b
template <int S>
__device__ __forceinline__ void build_prof(uint32_t* prof, int reg,
                                           const Sweep& w, const int* smat,
                                           int j0, int lane) {
  constexpr int S4 = S / 4;
#pragma unroll
  for (int k = 0; k < S4; ++k) {
    int code[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + 4 * k + jj;
      code[jj] = j < w.qcol ? clamp04(w.qp[(ptrdiff_t)w.qstep * j]) : -1;
    }
#pragma unroll 1
    for (int b = 0; b < 5; ++b) {
      uint32_t wd = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int sc = code[jj] < 0 ? kDeadScore : smat[b * 5 + code[jj]];
        wd |= (uint32_t)(sc & 0xff) << (8 * jj);
      }
      prof[((reg * 5 + b) * S4 + k) * 32 + lane] = wd;
    }
  }
}

// the max key over a group of G lanes
template <int G, typename T>
__device__ __forceinline__ T group_max(T k) {
  if constexpr (G == 32 && std::is_same<T, int>::value) {
    return __reduce_max_sync(kFull, k);
  } else {
#pragma unroll
    for (int d = G / 2; d >= 1; d >>= 1) {
      const T o = __shfl_xor_sync(kFull, k, d);
      k = o > k ? o : k;
    }
    return k;
  }
}

// the trackers' update for row i from the row max and its column; a row
// max past the job's rows is not the job's
template <typename RM>
__device__ __forceinline__ void track(Sweep& w, int i, int rowmax, int col,
                                      RM* rm, bool lead) {
  const bool act = i < w.rows && w.best < w.stop;
  if (rm != nullptr && lead && act) rm[i] = (RM)rowmax;
  const bool upd = act && rowmax > w.best;
  w.best = upd ? rowmax : w.best;
  w.qe = upd ? col : w.qe;
  w.te = upd ? i : w.te;
}

// One sweep of two jobs on 16-bit cells: A in the low halves of a group's
// words, B in the high halves. Row maxima go to rmA / rmB (lane r == 0)
// unless they are null.
template <int S, int G>
__device__ __forceinline__ void sweep16(const Params& p, const int* smat,
                                        uint32_t* prof, Sweep& A,
                                        Sweep& B, int16_t* rmA,
                                        int16_t* rmB) {
  constexpr int S4 = S / 4;
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  const bool first = r == 0;
  const int j0 = r * S;
  const int e_ins = p.e_ins, e_del = p.e_del;
  const uint32_t m_oe_ins = pk16(-(p.o_ins + e_ins), -(p.o_ins + e_ins));
  const uint32_t m_oe_del = pk16(-(p.o_del + e_del), -(p.o_del + e_del));
  const uint32_t m_e_ins = pk16(-e_ins, -e_ins);
  const uint32_t m_e_del = pk16(-e_del, -e_del);
  const uint32_t neg16w = pk16(kNeg16, kNeg16);
  build_prof<S>(prof, 0, A, smat, j0, lane);
  build_prof<S>(prof, 1, B, smat, j0, lane);

  uint32_t H[S], E[S], Hp[S], Gs[S], LM[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    H[s] = E[s] = 0;
    LM[s] = (j0 + s < A.qcol ? 0xffffu : 0u) |
            (j0 + s < B.qcol ? 0xffff0000u : 0u);
  }
  const int cu = e_ins * (j0 + S - 1), cx = -e_ins * (j0 - 1);
  int tA = trow_code(A, 0), tB = trow_code(B, 0);
  for (int i = 0;; ++i) {
    const bool act = (i < A.rows && A.best < A.stop) ||
                     (i < B.rows && B.best < B.stop);
    if (!__any_sync(kFull, act)) break;
    uint32_t pa[S4], pb[S4];
#pragma unroll
    for (int k = 0; k < S4; ++k) {
      pa[k] = prof[(tA * S4 + k) * 32 + lane];
      pb[k] = prof[((5 + tB) * S4 + k) * 32 + lane];
    }
    tA = trow_code(A, i + 1);  // the next row's bases, ahead of their use
    tB = trow_code(B, i + 1);
    // H(i-1, j-1) of the strip's first column: the previous lane's last
    uint32_t hleft = __shfl_up_sync(kFull, H[S - 1], 1, G);
    if (first) hleft = 0;
    uint32_t y = neg16w;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t hd = (s == 0) ? hleft : H[s - 1];
      uint32_t sc;
      switch (s & 3) {
        case 0: sc = pair_bytes<0>(pa[s >> 2], pb[s >> 2]); break;
        case 1: sc = pair_bytes<1>(pa[s >> 2], pb[s >> 2]); break;
        case 2: sc = pair_bytes<2>(pa[s >> 2], pb[s >> 2]); break;
        default: sc = pair_bytes<3>(pa[s >> 2], pb[s >> 2]); break;
      }
      const uint32_t e = __viaddmax_s16x2_relu(
          H[s], m_oe_del, __viaddmax_s16x2(E[s], m_e_del, kMinW));
      E[s] = e;
      const uint32_t hp = __viaddmax_s16x2_relu(hd, sc, e);
      Hp[s] = hp;
      const uint32_t g = __viaddmax_s16x2_relu(hp, m_oe_ins, kMinW);
      Gs[s] = g;
      y = __viaddmax_s16x2(y, m_e_ins, g);
    }
    // F's carry: exclusive max-scan of g(j) + e_ins*j over the group
    uint32_t incl = __viaddmax_s16x2(y, pk16(cu, cu), kMinW);
    incl = __shfl_up_sync(kFull, incl, 1, G);
    if (first) incl = neg16w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      if (d < G) {
        const uint32_t v = __shfl_up_sync(kFull, incl, d, G);
        if (r >= d) incl = __vimax3_s16x2(incl, v, v);
      }
    uint32_t x = first ? neg16w : __viaddmax_s16x2(incl, pk16(cx, cx), kMinW);
    // each half's max over live columns and the earliest cell holding it
    uint32_t vmax = 0;
    int cA = 0, cB = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t h = __vimax_s16x2_relu(Hp[s], x);
      x = __viaddmax_s16x2(x, m_e_ins, Gs[s]);
      H[s] = h;
      bool keep_hi, keep_lo;
      vmax = __vibmax_s16x2(vmax, h & LM[s], &keep_hi, &keep_lo);
      cA = keep_lo ? cA : s;
      cB = keep_hi ? cB : s;
    }
    int kA = (lo16(vmax) << kKeyBits) | (kColMask - (j0 + cA));
    int kB = (hi16(vmax) << kKeyBits) | (kColMask - (j0 + cB));
    kA = group_max<G>(kA);
    kB = group_max<G>(kB);
    track(A, i, kA >> kKeyBits, kColMask - (kA & kColMask), rmA, first);
    track(B, i, kB >> kKeyBits, kColMask - (kB & kColMask), rmB, first);
  }
}

// the int32 route's row-max key: 32-bit, or 64-bit for a matrix outside
// int8 (BIG)
template <bool BIG>
struct Key {
  using T = typename std::conditional<BIG, long long, int>::type;
  __device__ static T make(int h, int j) {
    if constexpr (BIG)
      return ((long long)h << 32) | (unsigned)(kColMask - j);
    else
      return (h << kKeyBits) | (kColMask - j);
  }
  __device__ static int value(T k) {
    if constexpr (BIG) return (int)(k >> 32);
    else return k >> kKeyBits;
  }
  __device__ static int column(T k) {
    if constexpr (BIG) return kColMask - (int)(k & 0xffffffffLL);
    else return kColMask - (k & kColMask);
  }
};

// One sweep of one job a group on int32 cells (BIG: the score from the
// shared matrix, a 64-bit key). Row maxima go to rm (lane r == 0) unless
// it is null.
template <int S, int G, bool BIG>
__device__ __forceinline__ void sweep32(const Params& p, const int* smat,
                                        uint32_t* prof, Sweep& A,
                                        int* rm) {
  using K = Key<BIG>;
  constexpr int S4 = S / 4;
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  const bool first = r == 0;
  const int j0 = r * S;
  const int e_ins = p.e_ins, e_del = p.e_del;
  const int oe_ins = p.o_ins + e_ins, oe_del = p.o_del + e_del;
  uint32_t cw[S4];  // BIG: the columns' codes, 4 a word (255: past qcol)
  if (BIG) {
#pragma unroll
    for (int k = 0; k < S4; ++k) {
      cw[k] = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + 4 * k + jj;
        const int c = j < A.qcol ? clamp04(A.qp[(ptrdiff_t)A.qstep * j])
                                 : 255;
        cw[k] |= (uint32_t)c << (8 * jj);
      }
    }
  } else {
    build_prof<S>(prof, 0, A, smat, j0, lane);
  }
  int H[S], E[S], Hp[S], Gs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) H[s] = E[s] = 0;
  const int cu = e_ins * (j0 + S - 1), cx = -e_ins * (j0 - 1);
  int tc = trow_code(A, 0);
  for (int i = 0;; ++i) {
    if (!__any_sync(kFull, i < A.rows && A.best < A.stop)) break;
    uint32_t pw[S4];
    if (!BIG) {
#pragma unroll
      for (int k = 0; k < S4; ++k) pw[k] = prof[(tc * S4 + k) * 32 + lane];
    }
    const int* mrow = smat + tc * 5;
    tc = trow_code(A, i + 1);
    int hleft = __shfl_up_sync(kFull, H[S - 1], 1, G);
    if (first) hleft = 0;
    int y = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int hd = (s == 0) ? hleft : H[s - 1];
      int sc;
      if (BIG) {
        const int c = (cw[s >> 2] >> (8 * (s & 3))) & 0xff;
        sc = c == 255 ? kDeadScore : mrow[c];
      } else {
        sc = sbyte(pw[s >> 2], s & 3);
      }
      const int e = __viaddmax_s32_relu(H[s], -oe_del, E[s] - e_del);
      E[s] = e;
      const int hp = __viaddmax_s32_relu(hd, sc, e);
      Hp[s] = hp;
      const int g = __viaddmax_s32_relu(hp, -oe_ins, 0);
      Gs[s] = g;
      y = __viaddmax_s32(y, -e_ins, g);
    }
    int incl = y + cu;
    incl = __shfl_up_sync(kFull, incl, 1, G);
    if (first) incl = kNeg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      if (d < G) {
        const int v = __shfl_up_sync(kFull, incl, d, G);
        if (r >= d) incl = max(incl, v);
      }
    int x = first ? kNeg : incl + cx;
    typename K::T key = K::make(0, j0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int h = __vimax_s32_relu(Hp[s], x);
      x = __viaddmax_s32(x, -e_ins, Gs[s]);
      H[s] = h;
      const typename K::T kv = K::make(j0 + s < A.qcol ? h : 0, j0 + s);
      key = kv > key ? kv : key;
    }
    key = group_max<G>(key);
    track(A, i, K::value(key), K::column(key), rm, first);
  }
}

// score2 of one job from its row maxima (rows 0..rows-1), reduced over the
// group
template <int G, typename RM>
__device__ __forceinline__ int score2_of(const RM* rm, int rows, int best,
                                         int te, int a, int minsc, int r) {
  const int halfw = (best + a - 1) / a;
  int s2 = 0;
  for (int x = r; x < rows; x += G) {
    const int v = rm[x];
    if ((x < te - halfw || x > te + halfw) && v >= minsc) s2 = max(s2, v);
  }
  return group_max<G>(s2);
}

// a job of the order (entry `ent`, -1 for none): its forward sweep
__device__ __forceinline__ void fwd_init(const Params& p, int ent, int& job,
                                         Sweep& w) {
  job = ent >= 0 ? ent & (kFits16 - 1) : -1;
  const int j = max(job, 0);
  const int qcol = job >= 0 ? min(max(p.qlen[j], 0), p.QMAX) : 0;
  const int rows = job >= 0 ? min(max(p.tlen[j], 0), p.TMAX) : 0;
  sweep_init(w, p.q + (size_t)j * p.QMAX, 1, qcol, p.t + (size_t)j * p.TMAX,
             1, rows, INT_MAX);
}

// the reverse sweep of a job whose forward sweep was f: over q[qe..0] and
// t[te..0], stopping at the first row that reaches f.best; no rows for a
// job below rev_skip
__device__ __forceinline__ void rev_init(const Params& p, int job,
                                         const Sweep& f, Sweep& w) {
  const int j = max(job, 0);
  const bool run = job >= 0 && (p.rev_skip <= 0 || f.best >= p.rev_skip);
  sweep_init(w, p.q + (size_t)j * p.QMAX + max(f.qe, 0), -1,
             run ? max(f.qe + 1, 0) : 0, p.t + (size_t)j * p.TMAX +
             max(f.te, 0), -1, run ? max(f.te + 1, 0) : 0, f.best);
}

// a job's (6, N) outputs in SW_KEYS order (the group's lane 0)
__device__ __forceinline__ void job_out(const Params& p, int job,
                                        const Sweep& f, const Sweep& rv,
                                        int score2, bool lead) {
  if (job < 0 || !lead) return;
  const bool run = p.rev_skip <= 0 || f.best >= p.rev_skip;
  const bool found = run && rv.best == f.best;
  const size_t N = p.N;
  p.out[job] = f.best;
  p.out[N + job] = found ? f.qe - rv.qe : -1;
  p.out[2 * N + job] = f.qe;
  p.out[3 * N + job] = found ? f.te - rv.te : -1;
  p.out[4 * N + job] = f.te;
  p.out[5 * N + job] = score2;
}

// the int32 route of one job a group: forward sweep, score2, reverse
template <int S, int G>
__device__ __forceinline__ void run_job32(const Params& p, const int* smat,
                                          uint32_t* prof, int ent, int* rm,
                                          bool big) {
  const int r = threadIdx.x & (G - 1);
  int job;
  Sweep f, rv;
  fwd_init(p, ent, job, f);
  if (big) sweep32<S, G, true>(p, smat, prof, f, rm);
  else sweep32<S, G, false>(p, smat, prof, f, rm);
  __syncwarp();
  const int s2 = score2_of<G>(rm, f.rows, f.best, f.te, p.a,
                              job >= 0 ? p.minsc[job] : 0, r);
  __syncwarp();  // the slice is the next job's after this
  rev_init(p, job, f, rv);
  if (big) sweep32<S, G, true>(p, smat, prof, rv, nullptr);
  else sweep32<S, G, false>(p, smat, prof, rv, nullptr);
  job_out(p, job, f, rv, s2, r == 0);
}

// one unit of the order from slot `first` (jobs end at slot `end`):
// 32 / G groups of per_group jobs each
template <int S, int G>
__device__ __forceinline__ void run_unit(const Params& p, const int* smat,
                                         uint32_t* prof, uint32_t* slice,
                                         int first, int end, bool big) {
  constexpr int per_group = kPerGroup<S>;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int r = lane & (G - 1);
  const int pos = first + grp * per_group;
  const int entA = pos < end ? p.order[pos] : -1;
  const int entB = per_group == 2 && pos + 1 < end ? p.order[pos + 1] : -1;
  const bool f16A = entA < 0 || (entA & kFits16) != 0;
  const bool f16B = entB < 0 || (entB & kFits16) != 0;
  // a job's row maxima: a row of the group's slice of shared memory, or
  // the job's own row of the global buffer (a missing job stores none)
  int* grow = reinterpret_cast<int*>(slice) + (size_t)grp * p.TMAX;
  auto row_of = [&](int ent) {
    return p.rowmax + (size_t)(ent >= 0 ? ent & (kFits16 - 1) : 0) * p.TMAX;
  };
  if constexpr (per_group == 2) {
    if (__all_sync(kFull, f16A && f16B)) {
      // 16-bit pairs: two rows of TMAX halves in the group's row
      int16_t* rmA = p.rowmax != nullptr
                         ? reinterpret_cast<int16_t*>(row_of(entA))
                         : reinterpret_cast<int16_t*>(grow);
      int16_t* rmB = p.rowmax != nullptr
                         ? reinterpret_cast<int16_t*>(row_of(entB))
                         : rmA + p.TMAX;
      int jobA, jobB;
      Sweep A, B, RA, RB;
      fwd_init(p, entA, jobA, A);
      fwd_init(p, entB, jobB, B);
      sweep16<S, G>(p, smat, prof, A, B, rmA, rmB);
      __syncwarp();
      const int s2A = score2_of<G>(rmA, A.rows, A.best, A.te, p.a,
                                   jobA >= 0 ? p.minsc[jobA] : 0, r);
      const int s2B = score2_of<G>(rmB, B.rows, B.best, B.te, p.a,
                                   jobB >= 0 ? p.minsc[jobB] : 0, r);
      rev_init(p, jobA, A, RA);
      rev_init(p, jobB, B, RB);
      sweep16<S, G>(p, smat, prof, RA, RB, nullptr, nullptr);
      job_out(p, jobA, A, RA, s2A, r == 0);
      job_out(p, jobB, B, RB, s2B, r == 0);
      return;
    }
  }
  run_job32<S, G>(p, smat, prof, entA,
                  p.rowmax != nullptr ? row_of(entA) : grow, big);
  if (per_group == 2)
    run_job32<S, G>(p, smat, prof, entB,
                    p.rowmax != nullptr ? row_of(entB) : grow, big);
}

// does a class of strip width S have groups of G lanes?
__host__ __device__ constexpr bool has_G(int S, int G) {
  for (int c = 0; c < jobbins::kRegClasses; ++c)
    if (class_S(c) == S && class_G(c) == G) return true;
  return false;
}

// the kernel for the classes of strip width S
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
sw_groups_kernel(Params p, int slice_words) {
  extern __shared__ uint32_t smem_rowmax[];  // slice_words per warp
  __shared__ int smat[25];
  __shared__ uint32_t sprof[kWarps][kPerGroup<S> * 5 * (S / 4) * 32];
  if (threadIdx.x < 25) smat[threadIdx.x] = p.mat[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  uint32_t* prof = sprof[warp];
  uint32_t* slice = smem_rowmax + (size_t)warp * slice_words;
  int amax = 0, amin = 0;
  for (int x = 0; x < 25; ++x) {
    amax = max(amax, smat[x]);
    amin = min(amin, smat[x]);
  }
  const bool big = amax > 127 || amin < -128;
  constexpr int per_group = kPerGroup<S>;

  // units: this kernel's classes widest first; a unit of class c is
  // per_group * 32 / G_c consecutive jobs of the order
  int total = 0;
#pragma unroll
  for (int c = kRegClasses - 1; c >= 0; --c)
    if (class_S(c) == S) {
      const int per = per_group * 32 / class_G(c);
      total += (p.counts[c] + per - 1) / per;
    }
  for (int unit = blockIdx.x * wpb + warp; unit < total;
       unit += gridDim.x * wpb) {
    int k = unit, start = 0, n = 0, G = 32;
    {
      int off = p.counts[kRegClasses];  // K1's wide class: none here
      bool found = false;
#pragma unroll
      for (int cc = kRegClasses - 1; cc >= 0; --cc) {
        const int nc = p.counts[cc];
        if (!found && class_S(cc) == S) {
          const int per = per_group * 32 / class_G(cc);
          const int uc = (nc + per - 1) / per;
          if (k < uc) {
            found = true;
            start = off;
            n = nc;
            G = class_G(cc);
          } else {
            k -= uc;
          }
        }
        if (!found) off += nc;
      }
    }
    if constexpr (has_G(S, 8))
      if (G == 8) run_unit<S, 8>(p, smat, prof, slice, start + k * 4 *
                                 per_group, start + n, big);
    if constexpr (has_G(S, 16))
      if (G == 16) run_unit<S, 16>(p, smat, prof, slice, start + k * 2 *
                                   per_group, start + n, big);
    if constexpr (has_G(S, 32))
      if (G == 32) run_unit<S, 32>(p, smat, prof, slice, start + k *
                                   per_group, start + n, big);
    __syncwarp();  // the slice and profile are the next unit's
  }
}

// may a class of strip width S hold a job (one of at most QMAX columns)?
bool s_in_use(int QMAX, int S) {
  for (int c = 0; c < kRegClasses; ++c) {
    const int lo = c == 0 ? 0 : jobbins::class_cols(c - 1);
    if (class_S(c) == S && lo < QMAX) return true;
  }
  return false;
}

template <int S>
cudaError_t launch_s(const Params& p, cudaStream_t st) {
  // a warp's row-max slices: one row of TMAX 32-bit words a group (two
  // rows of 16-bit halves for a 16-bit pair, one of int32 otherwise);
  // none when they live in the global buffer
  const int slice_words = p.rowmax != nullptr ? 0 : (32 / min_G(S)) * p.TMAX;
  const size_t per_warp = (size_t)slice_words * 4;
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > (size_t)kMaxSmemBytes) --warps;
  const size_t smem = warps * per_warp;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  // the static arrays count against the same 48 KB default, so the
  // dynamic limit is always raised
  cudaError_t err = cudaFuncSetAttribute(
      sw_groups_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int g = jobbins::grid_for(sw_groups_kernel<S>, warps * 32, smem,
                                  p.N, warps);
  sw_groups_kernel<S><<<g, warps * 32, smem, st>>>(p, slice_words);
  return cudaGetLastError();
}

// K2's binner (job_bins.cuh): a job's width class by its qlen, and
// whether it takes 16-bit cells: the wrapper's fits_i16
struct Binner {
  const int* qlen;
  const int* tlen;
  const int* mat;
  int N, QMAX, TMAX, e_ins, oe;
  bool gaps_ok;
  int amax, amin;
  __device__ void prepare() {
    amax = amin = 0;
    for (int x = 0; x < 25; ++x) {
      amax = max(amax, mat[x]);
      amin = min(amin, mat[x]);
    }
  }
  __device__ int bin(int j, bool& fits) const {
    const int cols = min(max(qlen[j], 0), QMAX);
    const int rows = min(max(tlen[j], 0), TMAX);
    const int c = jobbins::class_of(cols);
    const long long top = (long long)amax * min(cols, rows) +
                          (long long)e_ins * (jobbins::class_cols(c) + 1) +
                          oe;
    fits = gaps_ok && amax <= 127 && amin >= -128 && top < (1LL << 14);
    return jobbins::bin_of(c, fits, rows);
  }
};

}  // namespace

extern "C" {

// Launch on `stream`; out is (6, N) int32 in the order score, qb, qe, tb,
// te, score2. `work` is a device buffer of N + 1024 int32 for the job
// order. QMAX <= 1023. The row maxima for score2 live in shared memory
// (4 * TMAX bytes a group of lanes, up to 4 groups a warp) when `rowmax`
// is null, else in `rowmax`, N * TMAX int32. Returns a cudaError_t code.
int bm_sw_local(const void* q, const void* t, const void* qlen,
                const void* tlen, const void* minsc, const void* mat,
                void* work, void* rowmax, void* out, int N, int QMAX,
                int TMAX, int o_del,
                int e_del, int o_ins, int e_ins, int a, int rev_skip,
                void* stream) {
  if (N <= 0) return 0;
  if (QMAX < 1 || QMAX > 1023 || TMAX < 1 || a < 1 || N >= kFits16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.t = static_cast<const int8_t*>(t);
  p.qlen = static_cast<const int*>(qlen);
  p.tlen = static_cast<const int*>(tlen);
  p.minsc = static_cast<const int*>(minsc);
  p.mat = static_cast<const int*>(mat);
  p.rowmax = static_cast<int*>(rowmax);
  p.out = static_cast<int*>(out);
  p.N = N;
  p.QMAX = QMAX;
  p.TMAX = TMAX;
  p.o_del = o_del;
  p.e_del = e_del;
  p.o_ins = o_ins;
  p.e_ins = e_ins;
  p.a = a;
  p.rev_skip = rev_skip;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  Binner bn;
  bn.qlen = p.qlen;
  bn.tlen = p.tlen;
  bn.mat = p.mat;
  bn.N = N;
  bn.QMAX = QMAX;
  bn.TMAX = TMAX;
  bn.e_ins = e_ins;
  bn.oe = o_del + e_del > o_ins + e_ins ? o_del + e_del : o_ins + e_ins;
  bn.gaps_ok = o_del >= 0 && e_del >= 0 && o_ins >= 0 && e_ins >= 0;
  int *counts, *order;
  cudaError_t err = jobbins::build_order(bn, static_cast<int*>(work), st,
                                         &counts, &order);
  if (err != cudaSuccess) return (int)err;
  p.counts = counts;
  p.order = order;
  // one kernel per strip width, widest first
  if (err == cudaSuccess && s_in_use(QMAX, 32)) err = launch_s<32>(p, st);
  if (err == cudaSuccess && s_in_use(QMAX, 16)) err = launch_s<16>(p, st);
  if (err == cudaSuccess && s_in_use(QMAX, 8)) err = launch_s<8>(p, st);
  if (err == cudaSuccess && s_in_use(QMAX, 4)) err = launch_s<4>(p, st);
  return (int)err;
}

const char* bm_sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
