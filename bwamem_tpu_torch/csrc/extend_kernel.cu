// Dense one-sided ksw_extend2 over a batch of seed extensions, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/pallas/extend_kernel.py
// (_make_kernel, launched by _extend_pallas_impl). The contract is the
// row loop of bwamem_tpu/ops/extend.py:extend_batch: affine gaps, DP
// seeded with h0, 5x5 score matrix; per alignment it reports the best
// local cell (score, qle, tle), the best to-query-end cell (gscore, gtle)
// and max_off. Tie rules: a row's max goes to its LAST column; `best`
// moves only on a strict improvement (the EARLIEST row wins); gscore moves
// on >= (the LATEST row wins). An alignment stops when its row max is 0,
// when z-drop fires on a row that did not improve, or after its last
// target row.
//
// What bounds it: the work is integer and each alignment is a serial chain
// of target rows; an alignment reads about QMAX + TMAX bytes and writes 24.
// So the kernel is bound by the instructions it issues per live cell and
// per row, and by the latency of each row's chain of warp shuffles, not by
// memory bandwidth.
//
// Design (three small kernels first bin the jobs by width class, then
// 16-bit jobs first, then by rows, into a job order whose entries carry
// kFits16 where the wrapper's fits_i16 admits the job; see Binner):
//   * Work follows each job's own width. A job of qcol = min(qlen, QMAX)
//     query columns takes a group of G lanes, each holding a strip of S
//     columns in registers, with (S, G) the smallest class that covers
//     it: (4, 8), (8, 8), (8, 16), (8, 32), (16, 32), (32, 32) for qcol
//     <= 32, 64, 128, 256, 512, 1024 (short strips keep registers few and
//     warps many; measured against strips of up to 32 columns on 8 lanes,
//     PERF.md). Lane r of a group holds columns 1 + r*S .. (r+1)*S; column
//     0 is no lane's: H(i, 0) = max(h0 - o_del - e_del*(i+1), 0) is a
//     closed form, lane 0's diagonal for the next row, and it feeds no F.
//     A warp runs the groups of 32 / G jobs (or pairs of jobs) of one
//     class side by side; persistent warps walk the classes' units widest
//     first, one kernel per strip width on its own stream, so short jobs
//     fill in behind long ones. A group whose job is done stops updating;
//     the warp leaves a unit when all its groups are done.
//   * Columns past qcol are never masked: no live column depends on them.
//     They only stay out of the row max. Under opt_ext the band masks the
//     cells as the plain version does.
//   * The per-row chain is short: one shuffle brings the left neighbour's
//     previous-row H (the diagonal), F's carry is a max-scan over the
//     group in log2(G) steps plus one shift, and the row max with its
//     column is one packed key (value << 11 | column, so that a larger key
//     is the larger value and, at equal value, the later column) reduced
//     in log2(G) xor shuffles, or one __reduce_max_sync for a whole-warp
//     group. h_end is picked by the lane that holds column qcol, which
//     alone keeps gscore/gtle: no broadcast.
//   * 16-bit cells, two jobs a group, on strips of up to kPairMaxS = 8
//     columns (classes 0-3, qcol <= 256: on strips of 16 and 32 the pair
//     measured no faster than int32 cells, PERF.md): when every job of a
//     unit carries kFits16 (and there is no band), job A of each group
//     lives in the low halves of its lanes' 32-bit words and job B in the
//     high halves, and each cell is a handful of Hopper DPX int16x2
//     instructions:
//     M = min(hd + score, 2*hd) (__viaddmin_s16x2; <= 0 when hd == 0,
//     which every use treats as 0), F's step x' = max(x - e_ins, max(M -
//     oe_ins, 0)) (__viaddmax_s16x2 and its _relu form), H = max(M, E, x,
//     0) (__vimax3_s16x2_relu), E' = max(E - e_del, M - oe_del, 0), and
//     the row max of each half with its last column (__vibmax_s16x2).
//     Otherwise the int32 route runs one job a group at a time with the
//     same steps on 32-bit cells.
//   * The score comes from a packed byte profile of the lane's query
//     columns, one 32-bit shared-memory word per four columns and target
//     base, read once per row; `mat` stays a general 5x5 input.
//   * A job whose scores can reach 2^20 (h0 + amax * rows), or a matrix
//     with an entry outside int8, runs the int32 rows with a 64-bit key,
//     the plain M select and the score from the shared 5x5 matrix; a warp
//     takes that form for a unit when any of its jobs needs it.
// Jobs of more than 1024 columns take the wide route: one warp per job
// walks each row in chunks of kChunk = 512 columns (a strip of 16 per
// lane; chunk c holds columns 1 + c*512 .. (c+1)*512) with the row's H
// and E in dynamic shared memory, 8 bytes a column, laid out so that lane
// l's s-th column of a chunk sits at s*32 + l (no bank conflicts; a lane
// only ever reads what it wrote), or, past 28672 columns, in a global
// scratch buffer that the wrapper allocates. It walks only the chunks up
// to qcol, with one shuffle for the diagonal and the next chunk's, F's
// carry folded into the scan, and the row max reduced once a row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/kernels/extend_kernel.py).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "job_bins.cuh"

namespace {

using jobbins::class_G;
using jobbins::class_S;
using jobbins::kFits16;

constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
// Strips of up to kPairMaxS columns take two jobs a group on 16-bit cells;
// wider ones one job a group
constexpr int kPairMaxS = 8;

constexpr int kWarps = 4;  // warps per block
constexpr int kWide = 6;  // the wide route's class
constexpr int kKeyBits = 11;  // column bits of the packed row-max key
constexpr long long kBigScore = 1LL << 20;

// (S, G) of width classes 0..5 (G * S is the most query columns, qcol,
// a job of the class has): job_bins.cuh's class_S, class_G
__host__ __device__ constexpr int class_min_blocks(int S) {  // registers: 65536 / (128 * this)
  return S <= 4 ? 8 : S <= 8 ? 6 : S <= 16 ? 4 : 3;
}

// floor division for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp04(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

// the lane of a group that holds column qcol (column 0, which no strip
// holds, is lane 0's to report)
__device__ __forceinline__ int end_lane(int qcol, int S) {
  return qcol > 0 ? (qcol - 1) / S : 0;
}

// signed byte k of w
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  return (int)(int8_t)(w >> (8 * k));
}

// H[k] for a runtime k < S, as a tree of selects (no local memory)
template <int S, typename T>
__device__ __forceinline__ T pick(const T (&H)[S], int k) {
  T v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) v[s] = H[s];
#pragma unroll
  for (int w = S / 2, b = 0; w >= 1; w >>= 1, ++b) {
    const bool bit = (k >> b) & 1;
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = bit ? v[2 * j + 1] : v[2 * j];
  }
  return v[0];
}

struct Params {
  const int8_t* q;
  const int8_t* t;
  const int* qlen;
  const int* tlen;
  const int* h0;
  const int* mat;
  const int* order;
  const int* counts;
  int* out;
  int* scratch;
  int N, QMAX, TMAX, ncols;
  int o_del, e_del, o_ins, e_ins, w, zdrop, end_bonus, a;
};

// jobs a group of a strip-width-S kernel takes in one unit: two (one a
// word half) or one
template <int S>
constexpr int kPerGroup = S <= kPairMaxS ? 2 : 1;

// per-alignment state and trackers (each lane of a group holds a copy)
struct Job {
  int job, qlen, qcol, nrows, h0, w_lane;
  int best, qle, tle, gscore, gtle, max_off;
  bool dead, fits16;
};

// an entry of the job order: the job's index, with kFits16 set
// when the job may run on 16-bit cells (fits_i16); -1 for no job

__device__ __forceinline__ void job_init(const Params& p, int ent, Job& J) {
  const bool has = ent >= 0;
  const int job = has ? ent & (kFits16 - 1) : -1;
  J.job = job;
  J.fits16 = !has || (ent & kFits16) != 0;
  J.qlen = has ? p.qlen[job] : 0;
  const int tlen = has ? p.tlen[job] : 0;
  J.h0 = has ? p.h0[job] : 0;
  J.qcol = min(max(J.qlen, 0), p.QMAX);
  J.nrows = has ? min(max(tlen, 0), p.TMAX) : 0;
  int max_ins = floor_div(J.qlen * p.a + p.end_bonus - p.o_ins, p.e_ins) + 1;
  int max_del = floor_div(J.qlen * p.a + p.end_bonus - p.o_del, p.e_del) + 1;
  max_ins = max_ins < 1 ? 1 : max_ins;
  max_del = max_del < 1 ? 1 : max_del;
  J.w_lane = min(min(max_ins, max_del), p.w);
  J.best = J.h0;
  J.qle = J.tle = J.gtle = J.max_off = 0;
  J.gscore = -1;
  J.dead = J.nrows <= 0;
}

// the trackers' update for row i from the row max and its column
__device__ __forceinline__ void job_row(const Params& p, Job& J, int i,
                                        int rowmax, int mj) {
  const bool b_upd = rowmax > J.best;
  if (b_upd) {
    J.best = rowmax;
    J.qle = mj;
    J.tle = i + 1;
    J.max_off = max(J.max_off, abs(mj - 1 - i));
  }
  bool dead = rowmax == 0;
  if (p.zdrop > 0 && !b_upd) {
    const int di = i - (J.tle - 1);
    const int dj = (mj - 1) - (J.qle - 1);
    const int gap = di > dj ? (di - dj) * p.e_del : (dj - di) * p.e_ins;
    dead = dead || (J.best - rowmax - gap > p.zdrop);
  }
  J.dead = dead || i + 1 >= J.nrows;
}

// the row-max key: value and column packed so that max picks the larger
// value, then the later column (32-bit when the job's scores stay below
// 2^20, else 64-bit)
template <bool BIG>
struct Key {
  using T = typename std::conditional<BIG, long long, int>::type;
  __host__ __device__ static constexpr T dead() {
    if constexpr (BIG) return LLONG_MIN;
    else return INT_MIN;
  }
  __device__ static T make(int h, int u) {
    if constexpr (BIG)
      return ((long long)h << 32) | (unsigned)u;
    else
      return (h << kKeyBits) | u;
  }
  __device__ static int value(T k) {
    if constexpr (BIG) return (int)(k >> 32);
    else return k >> kKeyBits;
  }
  __device__ static int column(T k) {
    if constexpr (BIG) return (int)(k & 0xffffffffLL);
    else return k & ((1 << kKeyBits) - 1);
  }
  __device__ static T reduce(T k, int G) {
    if constexpr (!BIG) {
      if (G == 32) return __reduce_max_sync(kFull, k);
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
      if (d < G) {
        const T o = __shfl_xor_sync(kFull, k, d);
        k = o > k ? o : k;
      }
    return k;
  }
};

// One unit of the register route: 32 / G jobs side by side, a group of G
// lanes each, lane r of a group holding columns [1 + r*S, 1 + r*S + S).
// Column 0 is no lane's: H(i, 0) = max(h0 - o_del - e_del*(i+1), 0) is
// lane 0's diagonal for the next row, and column 0 feeds no F.
template <int S, bool OPT, bool BIG>
__device__ __forceinline__ void run_unit(const Params& p, const int* smat,
                                         uint32_t* prof, int G, Job& J) {
  using K = Key<BIG>;
  constexpr int S4 = S / 4;
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  const bool first = r == 0;
  const int u0 = 1 + r * S;
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int e_ins = p.e_ins, e_del = p.e_del;

  // the score profile of this lane's columns: word k of base b holds the
  // scores of columns u0 + 4k .. u0 + 4k + 3 against target base b (BIG:
  // cw[k] holds their codes instead)
  int amax = 0;
#pragma unroll 1
  for (int x = 0; x < 25; ++x) amax = max(amax, smat[x]);
  const int kk = amax + 1;
  const int8_t* qrow = p.q + (size_t)max(J.job, 0) * p.QMAX;
  uint32_t cw[S4];
#pragma unroll
  for (int k = 0; k < S4; ++k) {
    int code[4];
    cw[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + 4 * k + j;
      code[j] = (J.job >= 0 && u <= J.qcol) ? clamp04(qrow[u - 1]) : 4;
      cw[k] |= (uint32_t)code[j] << (8 * j);
    }
    if (!BIG) {
#pragma unroll 1
      for (int b = 0; b < 5; ++b) {
        uint32_t wd = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wd |= (uint32_t)(smat[b * 5 + code[j]] & 0xff) << (8 * j);
        prof[(b * S4 + k) * 32 + lane] = wd;
      }
    }
  }

  int H[S], E[S], M[S];
  // cells s in [0, shi] are real columns 1..qcol (the row max's)
  const int shi = min(J.qcol - u0, S - 1);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    H[s] = max(J.h0 - p.o_ins - e_ins * (u0 + s), 0);
    E[s] = 0;
  }
  const int r_end = end_lane(J.qcol, S), s_end = (J.qcol + S - 1) % S;
  int hcol0 = J.h0;  // H(i-1, 0)
  const int8_t* trow = p.t + (size_t)max(J.job, 0) * p.TMAX;

  for (int i = 0;; ++i) {
    const bool active = !J.dead;
    if (!__any_sync(kFull, active)) break;
    const int tc = active ? clamp04(trow[i]) : 4;
    uint32_t pw[S4];
    if (!BIG) {
#pragma unroll
      for (int k = 0; k < S4; ++k) pw[k] = prof[(tc * S4 + k) * 32 + lane];
    }
    const int* mrow = smat + tc * 5;
    // band (opt_ext): live cells are [a_row, b_row]
    int a_row = 0, b_row = shi;
    if (OPT) {
      a_row = max(0, i - J.w_lane + 1 - u0);
      b_row = min(shi, i + J.w_lane + 1 - u0);
    }
    // H(i-1, u-1) of the strip's first column: the previous lane's last
    int hleft = __shfl_up_sync(kFull, H[S - 1], 1, G);
    if (first) hleft = hcol0;
    // max over the strip of t(s) - e_ins*(S-1-s)
    int y = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int hd = (s == 0) ? hleft : H[s - 1];
      int m;
      if (BIG)
        m = hd > 0 ? hd + mrow[(cw[s >> 2] >> (8 * (s & 3))) & 0xff] : 0;
      else  // <= 0 when hd == 0
        m = __viaddmin_s32(hd, sbyte(pw[s >> 2], s & 3), hd * kk);
      if (OPT) {
        const bool live = s >= a_row && s <= b_row;
        m = live ? m : 0;
        E[s] = live ? E[s] : 0;
      }
      M[s] = m;
      y = __viaddmax_s32(y, -e_ins, __viaddmax_s32_relu(m, -oe_ins, 0));
    }
    // F's carry: exclusive max-scan of G(u) = t(u) + e_ins*u over the group
    int incl = y + e_ins * (u0 + S - 1);
    incl = __shfl_up_sync(kFull, incl, 1, G);
    if (first) incl = kNeg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      if (d < G) {
        const int v = __shfl_up_sync(kFull, incl, d, G);
        if (r >= d) incl = max(incl, v);
      }
    int x = first ? kNeg : incl - e_ins * (u0 - 1);

    typename K::T key = K::dead();
    const int b0 = max(J.h0 - (p.o_del + e_del * (i + 1)), 0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int m = M[s];
      const bool live = s >= a_row && s <= b_row;
      const int hn = __vimax3_s32_relu(m, E[s], OPT ? (live ? x : 0) : x);
      x = __viaddmax_s32(x, -e_ins, __viaddmax_s32_relu(m, -oe_ins, 0));
      int en = __viaddmax_s32_relu(E[s], -e_del, m - oe_del);
      if (OPT) en = live ? en : 0;
      E[s] = en;
      H[s] = hn;
      const typename K::T kv = live ? K::make(hn, u0 + s) : K::dead();
      key = kv > key ? kv : key;
    }
    key = K::reduce(key, G);
    const int rowmax = key < 0 ? -1 : K::value(key);
    const int mj = key < 0 ? p.QMAX : K::column(key);
    if (active) {
      if (r == r_end) {
        const int h_end = J.qcol > 0 ? pick<S>(H, s_end) : b0;
        if (h_end >= J.gscore && (!OPT || i + J.w_lane + 1 >= J.qlen)) {
          J.gscore = h_end;
          J.gtle = i + 1;
        }
      }
      job_row(p, J, i, rowmax, mj);
    }
    hcol0 = b0;
  }
}

// ---- 16-bit cells: two jobs in the halves of every 32-bit word ----

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

// One unit on 16-bit cells (no band): 2 * 32 / G jobs, job A of a group
// in the low halves of its lanes' words, job B in the high halves. The
// cells run on Hopper's DPX int16x2 instructions; the row max of each
// half keeps its last column through __vibmax_s16x2's predicates.
template <int S>
__device__ __forceinline__ void run_unit16(const Params& p, const int* smat,
                                           uint32_t* prof, int G, Job& JA,
                                           Job& JB) {
  constexpr int S4 = S / 4;
  constexpr uint32_t kMinW = 0x80008000u;  // -32768 in both halves
  constexpr int kNeg16 = -(1 << 14);
  const uint32_t neg16w = pk16(kNeg16, kNeg16);
  const int lane = threadIdx.x & 31;
  const int r = lane & (G - 1);
  const bool first = r == 0;
  const int u0 = 1 + r * S;
  const int e_ins = p.e_ins, e_del = p.e_del;
  const uint32_t m_oe_ins = pk16(-(p.o_ins + e_ins), -(p.o_ins + e_ins));
  const uint32_t m_oe_del = pk16(-(p.o_del + e_del), -(p.o_del + e_del));
  const uint32_t m_e_ins = pk16(-e_ins, -e_ins);
  const uint32_t m_e_del = pk16(-e_del, -e_del);

  // the profiles of both jobs (job B's at region 5 * S4)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Job& J = h == 0 ? JA : JB;
    const int8_t* qrow = p.q + (size_t)max(J.job, 0) * p.QMAX;
#pragma unroll
    for (int k = 0; k < S4; ++k) {
      int code[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = u0 + 4 * k + j;
        code[j] = (J.job >= 0 && u <= J.qcol) ? clamp04(qrow[u - 1]) : 4;
      }
#pragma unroll 1
      for (int b = 0; b < 5; ++b) {
        uint32_t wd = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wd |= (uint32_t)(smat[b * 5 + code[j]] & 0xff) << (8 * j);
        prof[((h * 5 + b) * S4 + k) * 32 + lane] = wd;
      }
    }
  }

  uint32_t H[S], E[S], M[S], LM[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int u = u0 + s;
    H[s] = pk16(max(JA.h0 - p.o_ins - e_ins * u, 0),
                max(JB.h0 - p.o_ins - e_ins * u, 0));
    E[s] = 0;
    // which halves of cell s are real columns 1..qcol (the row max's)
    LM[s] = (u <= JA.qcol ? 0xffffu : 0u) | (u <= JB.qcol ? 0xffff0000u : 0u);
  }
  const int8_t* trA = p.t + (size_t)max(JA.job, 0) * p.TMAX;
  const int8_t* trB = p.t + (size_t)max(JB.job, 0) * p.TMAX;
  const int rA = end_lane(JA.qcol, S), sA = (JA.qcol + S - 1) % S;
  const int rB = end_lane(JB.qcol, S), sB = (JB.qcol + S - 1) % S;
  uint32_t hcol0 = pk16(JA.h0, JB.h0);  // H(i-1, 0) of both jobs

  for (int i = 0;; ++i) {
    const bool actA = !JA.dead, actB = !JB.dead;
    if (!__any_sync(kFull, actA || actB)) break;
    const int tA = actA ? clamp04(trA[i]) : 4;
    const int tB = actB ? clamp04(trB[i]) : 4;
    uint32_t pa[S4], pb[S4];
#pragma unroll
    for (int k = 0; k < S4; ++k) {
      pa[k] = prof[(tA * S4 + k) * 32 + lane];
      pb[k] = prof[((5 + tB) * S4 + k) * 32 + lane];
    }
    uint32_t hleft = __shfl_up_sync(kFull, H[S - 1], 1, G);
    if (first) hleft = hcol0;
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
      // halves are in [0, 2^14): hd << 1 doubles each without a carry
      const uint32_t m = __viaddmin_s16x2(hd, sc, hd << 1);  // <= 0 if hd == 0
      M[s] = m;
      y = __viaddmax_s16x2(y, m_e_ins, __viaddmax_s16x2_relu(m, m_oe_ins, 0u));
    }
    // F's carry: exclusive max-scan of G(u) = t(u) + e_ins*u, both halves
    const int cu = e_ins * (u0 + S - 1);
    uint32_t incl = __viaddmax_s16x2(y, pk16(cu, cu), kMinW);
    incl = __shfl_up_sync(kFull, incl, 1, G);
    if (first) incl = neg16w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      if (d < G) {
        const uint32_t v = __shfl_up_sync(kFull, incl, d, G);
        if (r >= d) incl = __vimax3_s16x2(incl, v, v);
      }
    const int cx = -e_ins * (u0 - 1);
    uint32_t x = first ? neg16w : __viaddmax_s16x2(incl, pk16(cx, cx), kMinW);

    const uint32_t b0 =
        pk16(max(JA.h0 - (p.o_del + e_del * (i + 1)), 0),
             max(JB.h0 - (p.o_del + e_del * (i + 1)), 0));
    // each half's max and the strip's last cell holding it
    uint32_t vmax = kMinW;
    int cA = 0, cB = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t m = M[s];
      const uint32_t hn = __vimax3_s16x2_relu(m, E[s], x);
      x = __viaddmax_s16x2(x, m_e_ins, __viaddmax_s16x2_relu(m, m_oe_ins, 0u));
      E[s] = __viaddmax_s16x2_relu(E[s], m_e_del,
                                   __viaddmax_s16x2(m, m_oe_del, kMinW));
      H[s] = hn;
      // hn where the half is a real column, else -32768
      const uint32_t hm = (hn & LM[s]) | (kMinW & ~LM[s]);
      bool ge_hi, ge_lo;
      vmax = __vibmax_s16x2(hm, vmax, &ge_hi, &ge_lo);
      cA = ge_lo ? s : cA;
      cB = ge_hi ? s : cB;
    }
    // each half's row max and its last column, as 32-bit keys
    int kA = lo16(vmax), kB = hi16(vmax);
    kA = kA < 0 ? INT_MIN : (kA << kKeyBits) | (u0 + cA);
    kB = kB < 0 ? INT_MIN : (kB << kKeyBits) | (u0 + cB);
    kA = Key<false>::reduce(kA, G);
    kB = Key<false>::reduce(kB, G);
    if (actA) {
      if (r == rA) {
        const int h_end = JA.qcol > 0 ? lo16(pick<S>(H, sA)) : lo16(b0);
        if (h_end >= JA.gscore) {
          JA.gscore = h_end;
          JA.gtle = i + 1;
        }
      }
      job_row(p, JA, i, kA < 0 ? -1 : kA >> kKeyBits,
              kA < 0 ? p.QMAX : kA & ((1 << kKeyBits) - 1));
    }
    if (actB) {
      if (r == rB) {
        const int h_end = JB.qcol > 0 ? hi16(pick<S>(H, sB)) : hi16(b0);
        if (h_end >= JB.gscore) {
          JB.gscore = h_end;
          JB.gtle = i + 1;
        }
      }
      job_row(p, JB, i, kB < 0 ? -1 : kB >> kKeyBits,
              kB < 0 ? p.QMAX : kB & ((1 << kKeyBits) - 1));
    }
    hcol0 = b0;
  }
}

// the int32 route of one unit: 64-bit keys for a warp in which any job's
// scores can reach 2^20 or the matrix leaves int8
template <int S, bool OPT>
__device__ __forceinline__ void run_unit32(const Params& p, const int* smat,
                                           uint32_t* prof, int G, Job& J,
                                           int amax, int amin) {
  const bool big = J.job >= 0 &&
                   ((long long)J.h0 + (long long)amax * J.nrows >= kBigScore ||
                    amax > 127 || amin < -128);
  if (__any_sync(kFull, big))
    run_unit<S, OPT, true>(p, smat, prof, G, J);
  else
    run_unit<S, OPT, false>(p, smat, prof, G, J);
}

// one unit's jobs (JA, and JB when a group takes two): on 16-bit cells
// when every job of the warp fits, else on the int32 route
template <int S, bool OPT>
__device__ __forceinline__ void run_jobs(const Params& p, const int* smat,
                                         uint32_t* prof, int G, Job& JA,
                                         Job& JB, int amax, int amin) {
  if constexpr (kPerGroup<S> == 2) {
    if (!OPT && __all_sync(kFull, JA.fits16 && JB.fits16)) {
      run_unit16<S>(p, smat, prof, G, JA, JB);
      return;
    }
  }
  // the int32 route, one job a group at a time
  run_unit32<S, OPT>(p, smat, prof, G, JA, amax, amin);
  if (kPerGroup<S> == 2) run_unit32<S, OPT>(p, smat, prof, G, JB, amax, amin);
}

// the trackers of job J into its output row (lane 0 of the group and the
// lane holding column qcol)
__device__ __forceinline__ void job_out(const Params& p, const Job& J, int G,
                                        int S) {
  if (J.job < 0) return;
  int* o = p.out + (size_t)J.job * 6;
  const int r = threadIdx.x & (G - 1);
  if (r == 0) {
    o[0] = J.best;
    o[1] = J.qle;
    o[2] = J.tle;
    o[5] = J.max_off;
  }
  if (r == end_lane(J.qcol, S)) {
    o[3] = J.gscore;
    o[4] = J.gtle;
  }
}

// the register route's kernel for the classes of strip width S
template <int S, bool OPT>
__global__ void __launch_bounds__(kWarps * 32, class_min_blocks(S))
extend_groups_kernel(Params p) {
  __shared__ int smat[25];
  __shared__ uint32_t sprof[kWarps][kPerGroup<S> * 5 * (S / 4) * 32];
  if (threadIdx.x < 25) smat[threadIdx.x] = p.mat[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* prof = sprof[warp];
  int amax = 0, amin = 0;
  for (int x = 0; x < 25; ++x) {
    amax = max(amax, smat[x]);
    amin = min(amin, smat[x]);
  }
  constexpr int per_group = kPerGroup<S>;

  // units: this kernel's classes widest first; a unit of class c is
  // per_group * 32 / G_c consecutive jobs of the sorted order
  int total = 0;
#pragma unroll
  for (int c = kWide - 1; c >= 0; --c)
    if (class_S(c) == S) {
      const int per = per_group * 32 / class_G(c);
      total += (p.counts[c] + per - 1) / per;
    }
  const int nwarps = gridDim.x * kWarps;
  for (int unit = blockIdx.x * kWarps + warp; unit < total; unit += nwarps) {
    int k = unit, start = 0, n = 0, G = 32;
    {
      int off = p.counts[kWide];
      bool found = false;
#pragma unroll
      for (int cc = kWide - 1; cc >= 0; --cc) {
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
    const int pos = start + (k * (32 / G) + lane / G) * per_group;
    Job JA, JB;
    job_init(p, pos < start + n ? p.order[pos] : -1, JA);
    job_init(p, per_group == 2 && pos + 1 < start + n ? p.order[pos + 1] : -1,
             JB);
    run_jobs<S, OPT>(p, smat, prof, G, JA, JB, amax, amin);
    job_out(p, JA, G, S);
    job_out(p, JB, G, S);
  }
}

constexpr int kWideS = 16;              // columns per lane per chunk
constexpr int kChunk = 32 * kWideS;     // columns per chunk
constexpr int kMaxSmemBytes = 232448;   // 227 KB a block may use on sm_90

// The wide route: the same recurrence, one warp per job, walked in chunks
// of kChunk columns with the row in `row` (H at [0, ncols), E at
// [ncols, 2*ncols)): one warp's slice of dynamic shared memory, or of the
// global `scratch` buffer when that is given.
template <bool OPT>
__global__ void __launch_bounds__(kWarps * 32)
extend_wide_kernel(Params p) {
  extern __shared__ int smem_row[];
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = p.mat[threadIdx.x];
  __syncthreads();
  constexpr int S = kWideS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int n = p.counts[kWide];
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int e_ins = p.e_ins, e_del = p.e_del;
  const int ncols = p.ncols;

  for (int k = blockIdx.x * wpb + warp; k < n; k += gridDim.x * wpb) {
    const int job = p.order[k] & (kFits16 - 1);  // class 6 comes first
    Job J;
    job_init(p, job, J);
    int* Hrow = p.scratch != nullptr ? p.scratch + (size_t)job * 2 * ncols
                                     : smem_row + (size_t)warp * 2 * ncols;
    int* Erow = Hrow + ncols;
    // chunk c holds columns 1 + c*kChunk .. (c+1)*kChunk; column 0 is
    // no lane's, as on the register route
    const int nch = (J.qcol + kChunk - 1) / kChunk;  // those of 1..qcol
    const int8_t* qrow = p.q + (size_t)job * p.QMAX;
    const int8_t* trow = p.t + (size_t)job * p.TMAX;
    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int u = 1 + c * kChunk + lane * S + s;
        const int x = c * kChunk + s * 32 + lane;
        Hrow[x] = max(J.h0 - p.o_ins - e_ins * u, 0);
        Erow[x] = 0;
      }
    }
    int hcol0 = J.h0;  // H(i-1, 0)
    for (int i = 0; !J.dead; ++i) {
      const int* mrow = smat + clamp04(trow[i]) * 5;
      const int b0 = max(J.h0 - (p.o_del + e_del * (i + 1)), 0);
      int hdiag = hcol0;  // H(i-1, first column - 1) of this chunk (lane 0)
      int run_g = kNeg;   // F's running max of G(u) over earlier chunks
      int rmax = -1, rcol = -1, h_end = b0;
      for (int c = 0; c < nch; ++c) {
        const int base = c * kChunk;
        const int u0 = 1 + base + lane * S;
        int H[S], E[S], M[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          H[s] = Hrow[base + s * 32 + lane];
          E[s] = Erow[base + s * 32 + lane];
        }
        // one rotation: lanes 1..31 get the diagonal, lane 0 the next
        // chunk's (lane 31's last column, before it is overwritten)
        const int rot = __shfl_sync(kFull, H[S - 1], (lane + 31) & 31);
        const int hleft = lane == 0 ? hdiag : rot;
        hdiag = rot;
        int a_row = 0, b_row = min(J.qcol - u0, S - 1);
        if (OPT) {
          a_row = max(0, i - J.w_lane + 1 - u0);
          b_row = min(b_row, i + J.w_lane + 1 - u0);
        }
        int y = kNeg;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int u = u0 + s;
          const int hd = (s == 0) ? hleft : H[s - 1];
          const int qc = u <= J.qcol ? clamp04(qrow[u - 1]) : 4;
          int m = hd > 0 ? hd + mrow[qc] : 0;
          const bool live = s >= a_row && s <= b_row;
          if (OPT) {
            m = live ? m : 0;
            E[s] = live ? E[s] : 0;
          }
          M[s] = m;
          y = max(y - e_ins, max(m - oe_ins, 0));
        }
        // exclusive max-scan with the earlier chunks folded into lane 0
        int incl = y + e_ins * (u0 + S - 1);
        if (lane == 0) incl = max(incl, run_g);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl = max(incl, v);
        }
        const int shift = __shfl_sync(kFull, incl, (lane + 31) & 31);
        const int excl = lane == 0 ? run_g : shift;
        run_g = shift;  // lane 0 keeps the total for the next chunk
        int x = excl - e_ins * (u0 - 1);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int u = u0 + s;
          const int m = M[s];
          const bool live = s >= a_row && s <= b_row;
          const int hn = max(max(m, E[s]), max(OPT ? (live ? x : 0) : x, 0));
          x = max(x - e_ins, max(m - oe_ins, 0));
          int en = max(max(E[s] - e_del, m - oe_del), 0);
          if (OPT) en = live ? en : 0;
          Hrow[base + s * 32 + lane] = hn;
          Erow[base + s * 32 + lane] = en;
          if (live && hn >= rmax) {  // later column wins a tie
            rmax = hn;
            rcol = u;
          }
          if (u == J.qcol) h_end = hn;
        }
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        const int ov = __shfl_xor_sync(kFull, rmax, d);
        const int oc = __shfl_xor_sync(kFull, rcol, d);
        if (ov > rmax || (ov == rmax && oc > rcol)) {
          rmax = ov;
          rcol = oc;
        }
      }
      const int mj = rmax < 0 ? p.QMAX : rcol;
      const int end = end_lane((J.qcol - 1) % kChunk + 1, S);
      if (lane == end) {
        if (h_end >= J.gscore && (!OPT || i + J.w_lane + 1 >= J.qlen)) {
          J.gscore = h_end;
          J.gtle = i + 1;
        }
      }
      job_row(p, J, i, rmax, mj);
      hcol0 = b0;
    }
    int* o = p.out + (size_t)job * 6;
    if (lane == 0) {
      o[0] = J.best;
      o[1] = J.qle;
      o[2] = J.tle;
      o[5] = J.max_off;
    }
    if (lane == end_lane((J.qcol - 1) % kChunk + 1, S)) {
      o[3] = J.gscore;
      o[4] = J.gtle;
    }
  }
}

// ---- the job order, built on the device before the DP kernels ----
// (job_bins.cuh): the persistent warps take the jobs in bin order, so
// that the jobs a warp runs side by side are alike and the longest start
// first.
static_assert(kWide == jobbins::kRegClasses, "K1's wide route is class 6");

// the most columns a strip group of a launch of width QMAX spans: the
// width class that holds QMAX (1024 past it)
__host__ __device__ constexpr int strip_cols(int QMAX) {
  int c = 0;
  while (c < kWide - 1 && class_S(c) * class_G(c) < QMAX) ++c;
  return class_S(c) * class_G(c);
}

// the matrix's extremes (its largest entry at least 0, its least at most
// 0) and the launch's margin of fits_i16
struct Prep {
  int amax, amin, margin;
};

__device__ Prep prep_of(const int* mat, int margin) {
  Prep r{0, 0, margin};
  for (int x = 0; x < 25; ++x) {
    r.amax = max(r.amax, mat[x]);
    r.amin = min(r.amin, mat[x]);
  }
  return r;
}

// K1's binner (job_bins.cuh): a job's width class by its qcol, and
// whether it takes 16-bit cells: the wrapper's fits_i16
struct Binner {
  Params p;
  int margin;
  Prep pr;
  int N;
  __device__ void prepare() { pr = prep_of(p.mat, margin); }
  __device__ int bin(int j, bool& fits) const {
    const int qcol = min(max(p.qlen[j], 0), p.QMAX);
    const int rows = min(max(p.tlen[j], 0), p.TMAX);
    const int h0 = p.h0[j];
    fits = h0 >= 0 && pr.amax <= 1 && pr.amin >= -128 &&
           (long long)h0 + (long long)pr.amax * rows + pr.margin <
               (1LL << 14);
    return jobbins::bin_of(jobbins::class_of(qcol), fits, rows);
  }
};

using jobbins::grid_for;

template <int S, bool OPT>
cudaError_t launch_s(const Params& p, cudaStream_t st) {
  const int threads = kWarps * 32;
  const int g = grid_for(extend_groups_kernel<S, OPT>, threads, 0, p.N,
                         kWarps);
  extend_groups_kernel<S, OPT><<<g, threads, 0, st>>>(p);
  return cudaGetLastError();
}

// may a class of strip width S hold a job (one of at most QMAX columns)?
bool s_in_use(const Params& p, int S) {
  for (int c = 0; c < kWide; ++c) {
    const int lo = c == 0 ? 0 : class_S(c - 1) * class_G(c - 1);
    if (class_S(c) == S && lo < p.QMAX) return true;
  }
  return false;
}

template <bool OPT>
cudaError_t launch_wide_t(const Params& p, cudaStream_t st) {
  const size_t per_warp = (size_t)p.ncols * 2 * sizeof(int);
  int warps = kWarps;
  size_t smem = 0;
  if (p.scratch == nullptr) {
    // as many warps per block as their rows fit in shared memory
    while (warps > 1 && warps * per_warp > (size_t)kMaxSmemBytes) --warps;
    smem = warps * per_warp;
    if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
    // the static smat counts against the same 48 KB default, so the
    // dynamic limit is raised for every launch that uses shared rows
    const cudaError_t err = cudaFuncSetAttribute(
        extend_wide_kernel<OPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int g = grid_for(extend_wide_kernel<OPT>, warps * 32, smem, p.N,
                         warps);
  extend_wide_kernel<OPT><<<g, warps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

constexpr int kSide = 5;  // the wide route and four strip widths

// side streams and events of one device, made once
struct Fork {
  bool ok = false;
  cudaStream_t side[kSide];
  cudaEvent_t fork, join[kSide];
};

Fork& fork_for_device() {
  static Fork forks[64];
  static bool made[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  Fork& f = forks[dev & 63];
  if (!made[dev & 63]) {
    made[dev & 63] = true;
    bool ok = cudaEventCreateWithFlags(&f.fork, cudaEventDisableTiming)
              == cudaSuccess;
    for (int k = 0; k < kSide && ok; ++k)
      ok = cudaStreamCreateWithFlags(&f.side[k], cudaStreamNonBlocking)
               == cudaSuccess &&
           cudaEventCreateWithFlags(&f.join[k], cudaEventDisableTiming)
               == cudaSuccess;
    f.ok = ok;
  }
  return f;
}

}  // namespace

extern "C" {

// Launch on `stream`; out is (N, 6) int32 rows
// [score, qle, tle, gscore, gtle, max_off], written in job order. `work`
// is a device buffer of N + 1024 int32 that holds the job order (the jobs'
// bins, their counts and each width class's jobs: qcol <= 32, 64, 128,
// 256, 512, 1024, more). When QMAX > 1024 the wide route runs class 6;
// `scratch` is null there when one warp's row (8 bytes a column, QMAX
// rounded up to 512 columns) fits in shared memory, else a buffer of
// N * 2 * ncols ints. N < 2^30. Returns a cudaError_t code.
int bm_extend_dense(const void* q, const void* t, const void* qlen,
                    const void* tlen, const void* h0, const void* mat,
                    void* work, void* out, void* scratch, int N, int QMAX,
                    int TMAX, int o_del, int e_del, int o_ins, int e_ins,
                    int w, int zdrop, int end_bonus, int opt_ext, int a,
                    void* stream) {
  if (N <= 0) return 0;
  if (QMAX < 1 || e_del < 1 || e_ins < 1 || N >= kFits16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.t = static_cast<const int8_t*>(t);
  p.qlen = static_cast<const int*>(qlen);
  p.tlen = static_cast<const int*>(tlen);
  p.h0 = static_cast<const int*>(h0);
  p.mat = static_cast<const int*>(mat);
  p.out = static_cast<int*>(out);
  p.scratch = static_cast<int*>(scratch);
  p.N = N;
  p.QMAX = QMAX;
  p.TMAX = TMAX;
  p.ncols = (QMAX + kChunk - 1) / kChunk * kChunk;
  p.o_del = o_del;
  p.e_del = e_del;
  p.o_ins = o_ins;
  p.e_ins = e_ins;
  p.w = w;
  p.zdrop = zdrop;
  p.end_bonus = end_bonus;
  p.a = a;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // the job order (job_bins.cuh); fits_i16's margin, one past 2^14
  // admitting no job
  const int oe = o_del + e_del > o_ins + e_ins ? o_del + e_del : o_ins + e_ins;
  const long long m_ll =
      (long long)e_ins * (strip_cols(QMAX) + 1) + oe + end_bonus;
  Binner bn;
  bn.p = p;
  bn.margin = m_ll < 0 ? 0 : m_ll > (1 << 14) ? (1 << 14) : (int)m_ll;
  bn.N = N;
  int *counts, *order;
  cudaError_t err = jobbins::build_order(bn, static_cast<int*>(work), st,
                                         &counts, &order);
  if (err != cudaSuccess) return (int)err;
  p.order = order;
  p.counts = counts;
  // one kernel per strip width and the wide route's, widest first, each
  // on its own stream forked from and joined back into `st`, so that the
  // narrow classes fill the card while the wide ones finish
  static std::mutex mu;  // one fork/join sequence at a time
  std::lock_guard<std::mutex> lock(mu);
  Fork& f = fork_for_device();
  if (!f.ok) return (int)cudaErrorInitializationError;
  err = cudaEventRecord(f.fork, st);
  int used = 0;
  auto run = [&](cudaError_t (*fn)(const Params&, cudaStream_t)) {
    if (err != cudaSuccess) return;
    cudaStream_t s2 = f.side[used];
    err = cudaStreamWaitEvent(s2, f.fork, 0);
    if (err == cudaSuccess) err = fn(p, s2);
    if (err == cudaSuccess) err = cudaEventRecord(f.join[used], s2);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(st, f.join[used], 0);
    ++used;
  };
  const bool o = opt_ext != 0;
  if (QMAX > 1024)  // class 6 jobs exist only here
    run(o ? launch_wide_t<true> : launch_wide_t<false>);
  if (s_in_use(p, 32)) run(o ? launch_s<32, true> : launch_s<32, false>);
  if (s_in_use(p, 16)) run(o ? launch_s<16, true> : launch_s<16, false>);
  if (s_in_use(p, 8)) run(o ? launch_s<8, true> : launch_s<8, false>);
  if (s_in_use(p, 4)) run(o ? launch_s<4, true> : launch_s<4, false>);
  return (int)err;
}

const char* bm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
