// Banded one-sided ksw_extend2 over a batch of seed extensions, for Hopper
// (sm_90a): the DP row lives in a sliding window of WP = round128(2w+3)
// lanes anchored to the band diagonal instead of spanning the query.
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/pallas/extend_banded.py
// (_make_banded_kernel, launched by _banded_pallas_impl). The contract is
// the dense kernel's (csrc/extend_kernel.cu, the row loop of
// bwamem_tpu/ops/extend.py:extend_batch with opt_ext): affine gaps, DP
// seeded with h0, 5x5 score matrix, band u - 1 in [i - w', i + w' + 1)
// with w' the per-alignment clamped band; it reports score, qle, tle,
// gscore, gtle and max_off. Window rules, as the Pallas kernel has them:
//   * lane v of row i is DP column u = i + v - w;
//   * the window before row 0 is the virtual row -1: lane v holds the
//     first row's H at u = v - w - 1 (0 outside 0..qlen);
//   * a lane is live when 1 <= u <= qlen and w - w' + 1 <= v <= w + w' + 1;
//   * diagonal H(i-1, u-1) is the SAME lane of the previous window,
//     vertical E(i-1, u) the lane to its right, F a running max along
//     the window;
//   * the row max goes to its LARGEST column, and mj = -1 when no lane is
//     live; best moves on a strict improvement, gscore on >=;
//   * H(i, 0) = max(h0 - o_del - e_del*(i+1), 0);
//   * h_end is the window's value at u = qlen: 0 where that lane is
//     outside the band (a stored 0), and 0 once the band has passed the
//     query end (i - w > qlen). The window keeps WP lanes, so h_end and
//     gscore/gtle are the Pallas kernel's exactly.
//
// What bounds it: integer work along a serial chain of target rows over a
// window of WP lanes, whatever the read length; an alignment reads about
// QMAX + TMAX bytes and writes 24, so bytes are no limit. The floor is
// the instructions a window cell needs (about 8 on 32-bit cells, half on
// 16-bit pairs), then the per-row chain: E's shift, F's carry scan, the
// row max's reduction.
//
// Design:
//   * Three small kernels first order the jobs on the device
//     (job_bins.cuh): 16-bit jobs first, then by rows, so that the two
//     alignments a warp pairs end at about the same row.
//   * 16-bit cells, two alignments a warp, where both pass fits_i16 (K1's
//     predicate on the window's WP lanes, built again on the device):
//     alignment A in the low halves of each lane's words, B in the high
//     halves; each cell is a few DPX int16x2 instructions, K1's forms:
//     M = min(hd + s, 2*hd) (amax <= 1), F's step, H = max(M, E, F, 0),
//     E' = max(E - e_del, M - oe_del, 0). Other alignments take int32
//     cells, one a warp, in the same launch; a job whose scores can reach
//     2^20, or a matrix outside int8, a 64-bit row-max key and the score
//     from the shared matrix.
//   * Lane l holds window lanes l*S .. l*S + S - 1 (S = WP / 32) of H and
//     E in registers. E's one-lane shift is a renaming plus one shuffle.
//     The query window does not move: each job's score profile by column
//     (one byte per column and target base, columns past the query and
//     before it scored -128) sits in shared memory, and a lane reads its
//     S scores of row i at column i + l*S - w with S/4 + 1 word loads and
//     funnel shifts.
//   * Lanes outside the band are masked once per job (their H and E stay
//     0); a column u < 1 needs no mask (it stays 0 by the recurrence),
//     and H(i, 0) comes out of it as the vertical gap from h0 that it is
//     (the window's E at u = 0 starts at h0 - o_del - e_del). The live
//     range of the row max, 1 <= u <= qlen, is two compares per row and
//     lane, turned into a byte mask per four cells.
//   * The row max and its largest lane are one key, value << 11 | lane,
//     reduced by __reduce_max_sync. h_end is picked by the lane holding
//     u = qlen, on the rows that can move gscore.
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

constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps per block, at most
constexpr int kKeyBits = 11;
constexpr int kDeadScore = -128;  // a column outside 1..qlen
constexpr long long kBigScore = 1LL << 20;
constexpr int kMaxSmemBytes = 232448;  // 227 KB a block may use on sm_90
constexpr uint32_t kMinW = 0x80008000u;  // -32768 in both halves
constexpr int kNeg16 = -(1 << 14);

struct Params {
  const int8_t* q;
  const int8_t* t;
  const int* qlen;
  const int* tlen;
  const int* h0;
  const int* mat;
  const int* order;
  int* out;
  int N, QMAX, TMAX, PW;  // PW: profile columns a base row (a multiple of 4)
  int o_del, e_del, o_ins, e_ins, w, zdrop, end_bonus, a;
};

// floor division for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp04(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
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

__device__ __forceinline__ uint32_t pair_byte(int j, uint32_t a, uint32_t b) {
  switch (j & 3) {
    case 0: return pair_bytes<0>(a, b);
    case 1: return pair_bytes<1>(a, b);
    case 2: return pair_bytes<2>(a, b);
    default: return pair_bytes<3>(a, b);
  }
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
  for (int span = 1; span < S; span <<= 1) {
    const bool bit = (k & span) != 0;
#pragma unroll
    for (int j = 0; j + span < S; j += 2 * span) v[j] = bit ? v[j + span] : v[j];
  }
  return v[0];
}

// the bytes of four cells (4k .. 4k+3 of a lane) that lie in [a, b],
// 0xff each, else 0
__device__ __forceinline__ uint32_t range_bytes(int a, int b, int k) {
  // the clamping funnel shifts give 0 for a shift of 32 or more
  const uint32_t m_lo = __funnelshift_lc(0u, 0xffffffffu, 8 * max(a - 4 * k, 0));
  const uint32_t m_hi =
      __funnelshift_rc(0xffffffffu, 0u, 8 * max(3 - (b - 4 * k), 0));
  return m_lo & m_hi;
}

// per-alignment state and trackers (every lane of the warp holds a copy)
struct Job {
  int job, qlen, nrows, h0, w_lane, lo_v, hi_v;
  int best, qle, tle, gscore, gtle, max_off;
  bool dead;
  uint32_t* prof;  // the job's score profile: 5 rows of PW / 4 words
  const int8_t* trow;
};

__device__ __forceinline__ void job_init(const Params& p, int ent, Job& J) {
  const bool has = ent >= 0;
  const int job = has ? ent & (kFits16 - 1) : -1;
  const int j = max(job, 0);
  J.job = job;
  J.qlen = has ? p.qlen[j] : 0;
  J.h0 = has ? p.h0[j] : 0;
  J.nrows = has ? min(max(p.tlen[j], 0), p.TMAX) : 0;
  int max_ins = floor_div(J.qlen * p.a + p.end_bonus - p.o_ins, p.e_ins) + 1;
  int max_del = floor_div(J.qlen * p.a + p.end_bonus - p.o_del, p.e_del) + 1;
  max_ins = max_ins < 1 ? 1 : max_ins;
  max_del = max_del < 1 ? 1 : max_del;
  J.w_lane = min(min(max_ins, max_del), p.w);
  J.lo_v = p.w - J.w_lane + 1;
  J.hi_v = p.w + J.w_lane + 1;
  J.best = J.h0;
  J.qle = J.tle = J.gtle = J.max_off = 0;
  J.gscore = -1;
  J.dead = J.nrows <= 0;
  J.trow = p.t + (size_t)j * p.TMAX;
}

// job J's score profile into `prof` (5 rows of PW bytes): byte x of row b
// is the score of column u = x - w - 1 against base b, kDeadScore outside
// 1..qlen (BIG: the column's code, 255 outside)
template <bool BIG>
__device__ __forceinline__ void build_prof(const Params& p, const int* smat,
                                           uint32_t* prof, const Job& J) {
  const int lane = threadIdx.x & 31;
  const int8_t* qrow = p.q + (size_t)max(J.job, 0) * p.QMAX;
  const int qcol = J.job >= 0 ? min(max(J.qlen, 0), p.QMAX) : 0;
  const int nw = p.PW / 4;
  for (int x4 = lane; x4 < nw; x4 += 32) {
    int code[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int u = 4 * x4 + jj - p.w - 1;
      code[jj] = (u >= 1 && u <= qcol) ? clamp04(qrow[u - 1]) : -1;
    }
#pragma unroll 1
    for (int b = 0; b < (BIG ? 1 : 5); ++b) {
      uint32_t wd = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int v = BIG ? (code[jj] < 0 ? 255 : code[jj])
                          : (code[jj] < 0 ? kDeadScore
                                          : smat[b * 5 + code[jj]]);
        wd |= (uint32_t)(v & 0xff) << (8 * jj);
      }
      prof[b * nw + x4] = wd;
    }
  }
}

// the S profile bytes of a lane's cells in row i (columns from
// x0 = i + v0 + 1), as S/4 words
template <int S>
__device__ __forceinline__ void row_scores(const uint32_t* prow, int x0,
                                           int PW, uint32_t (&out)[S / 4]) {
  constexpr int S4 = S / 4;
  // a lane whose cells all lie past PW - S - 4 holds no column <= QMAX:
  // its scores are never read by a live cell, so it may read any
  x0 = min(x0, PW - S - 4);
  const int wb = x0 >> 2, sh = (x0 & 3) * 8;
  uint32_t wd[S4 + 1];
#pragma unroll
  for (int k = 0; k <= S4; ++k) wd[k] = prow[wb + k];
#pragma unroll
  for (int k = 0; k < S4; ++k) out[k] = __funnelshift_r(wd[k], wd[k + 1], sh);
}

// the trackers' update for row i; rowmax -1 (mj -1) when no lane is live
__device__ __forceinline__ void job_row(const Params& p, Job& J, int i,
                                        int rowmax, int mj, int h_end,
                                        bool want_end) {
  if (want_end && h_end >= J.gscore) {
    J.gscore = h_end;
    J.gtle = i + 1;
  }
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

// the first row of lane v (the virtual row -1): H(0, v - w - 1)
__device__ __forceinline__ int virt_h(const Params& p, const Job& J, int v) {
  const int u0 = v - p.w - 1;
  if (u0 < 0 || u0 > J.qlen) return 0;
  return u0 == 0 ? J.h0 : max(J.h0 - p.o_ins - p.e_ins * u0, 0);
}

// the window's E before row 0 at lane v: the vertical gap from h0 at
// u = 0, so that H(i, 0) follows from the recurrence
__device__ __forceinline__ int virt_e(const Params& p, const Job& J, int v) {
  return v == p.w + 1 ? max(J.h0 - p.o_del - p.e_del, 0) : 0;
}

// the live range of row i's row max in window lanes, [L, R] (empty when
// L > R): the band and 1 <= u <= qlen
__device__ __forceinline__ void live_range(const Params& p, const Job& J,
                                           int i, int& L, int& R) {
  L = max(J.lo_v, p.w + 1 - i);
  R = min(J.hi_v, J.qlen + p.w - i);
}

// h_end's row: the window's value at u = qlen (lane v_end), kNeg when
// that lane is outside the window, 0 once the band has passed the query
__device__ __forceinline__ int h_end_of(const Params& p, const Job& J, int i,
                                        int picked, int WP) {
  if (i - p.w > J.qlen) return 0;
  const int v_end = J.qlen - i + p.w;
  return (v_end >= 0 && v_end < WP) ? picked : kNeg;
}

// the trackers into job J's output row
__device__ __forceinline__ void job_out(const Params& p, const Job& J) {
  if (J.job < 0 || (threadIdx.x & 31) != 0) return;
  int* o = p.out + (size_t)J.job * 6;
  o[0] = J.best;
  o[1] = J.qle;
  o[2] = J.tle;
  o[3] = J.gscore;
  o[4] = J.gtle;
  o[5] = J.max_off;
}

// Two alignments on 16-bit cells, A in the low halves, B in the high.
template <int S>
__device__ __forceinline__ void run_pair16(const Params& p, Job& A, Job& B) {
  constexpr int S4 = S / 4;
  constexpr int WP = 32 * S;
  const int lane = threadIdx.x & 31;
  const int v0 = lane * S;
  const int e_ins = p.e_ins, e_del = p.e_del, nw = p.PW / 4;
  const uint32_t m_oe_ins = pk16(-(p.o_ins + e_ins), -(p.o_ins + e_ins));
  const uint32_t m_oe_del = pk16(-(p.o_del + e_del), -(p.o_del + e_del));
  const uint32_t m_e_ins = pk16(-e_ins, -e_ins);
  const uint32_t m_e_del = pk16(-e_del, -e_del);
  const uint32_t neg16w = pk16(kNeg16, kNeg16);

  uint32_t H[S], E[S], M[S], Gs[S], BM[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int v = v0 + s;
    // the band's lanes of each half
    BM[s] = (v >= A.lo_v && v <= A.hi_v ? 0xffffu : 0u) |
            (v >= B.lo_v && v <= B.hi_v ? 0xffff0000u : 0u);
    H[s] = pk16(virt_h(p, A, v), virt_h(p, B, v)) & BM[s];
    E[s] = pk16(virt_e(p, A, v), virt_e(p, B, v)) & BM[s];
  }
  const int cu = e_ins * (v0 + S - 1), cx = -e_ins * (v0 - 1);
  int tA = A.dead ? 4 : clamp04(A.trow[0]);
  int tB = B.dead ? 4 : clamp04(B.trow[0]);
  for (int i = 0;; ++i) {
    if (A.dead && B.dead) break;  // warp-uniform: every lane holds both
    uint32_t sA[S4], sB[S4];
    row_scores<S>(A.prof + tA * nw, i + v0 + 1, p.PW, sA);
    row_scores<S>(B.prof + tB * nw, i + v0 + 1, p.PW, sB);
    tA = !A.dead && i + 1 < A.nrows ? clamp04(A.trow[i + 1]) : 4;
    tB = !B.dead && i + 1 < B.nrows ? clamp04(B.trow[i + 1]) : 4;
    // E(i-1, u) sits one lane to the right in the previous window
    uint32_t e_in = __shfl_down_sync(kFull, E[0], 1);
    if (lane == 31) e_in = 0;
    uint32_t y = neg16w;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t hd = H[s];
      const uint32_t sc = pair_byte(s, sA[s >> 2], sB[s >> 2]);
      // halves are in [0, 2^14): hd << 1 doubles each without a carry
      const uint32_t m = __viaddmin_s16x2(hd, sc, hd << 1);  // <= 0 if hd == 0
      M[s] = m;
      const uint32_t g = __viaddmax_s16x2_relu(m, m_oe_ins, kMinW);
      Gs[s] = g;
      y = __viaddmax_s16x2(y, m_e_ins, g);
    }
    // F's carry: exclusive max-scan of g(v) + e_ins*v over the warp
    uint32_t incl = __viaddmax_s16x2(y, pk16(cu, cu), kMinW);
    incl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) incl = neg16w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = __vimax3_s16x2(incl, v, v);
    }
    uint32_t x = lane == 0 ? neg16w
                           : __viaddmax_s16x2(incl, pk16(cx, cx), kMinW);
    // the row max's live cells of each half: [LA, RA] and [LB, RB]
    int LA, RA, LB, RB;
    live_range(p, A, i, LA, RA);
    live_range(p, B, i, LB, RB);
    uint32_t lmA[S4], lmB[S4];
#pragma unroll
    for (int k = 0; k < S4; ++k) {
      lmA[k] = range_bytes(LA - v0, RA - v0, k);
      lmB[k] = range_bytes(LB - v0, RB - v0, k);
    }
    uint32_t vmax = 0;
    int cA = 0, cB = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t m = M[s];
      // E(i-1, u): the next cell's E of the previous row, not yet written
      const uint32_t xe = (s + 1 < S) ? E[s + 1] : e_in;
      const uint32_t hn = __vimax3_s16x2_relu(m, xe, x) & BM[s];
      x = __viaddmax_s16x2(x, m_e_ins, Gs[s]);
      E[s] = __viaddmax_s16x2_relu(xe, m_e_del,
                                   __viaddmax_s16x2(m, m_oe_del, kMinW)) &
             BM[s];
      H[s] = hn;
      bool ge_hi, ge_lo;
      vmax = __vibmax_s16x2(hn & pair_byte(s, lmA[s >> 2], lmB[s >> 2]),
                            vmax, &ge_hi, &ge_lo);
      cA = ge_lo ? s : cA;  // ties: the later lane
      cB = ge_hi ? s : cB;
    }
    int kA = (lo16(vmax) << kKeyBits) | (v0 + cA);
    int kB = (hi16(vmax) << kKeyBits) | (v0 + cB);
    kA = __reduce_max_sync(kFull, kA);
    kB = __reduce_max_sync(kFull, kB);
    // h_end on the rows that can move gscore
    const bool wantA = !A.dead && i + A.w_lane + 1 >= A.qlen;
    const bool wantB = !B.dead && i + B.w_lane + 1 >= B.qlen;
    int heA = kNeg, heB = kNeg;
    if (wantA || wantB) {
      const int veA = A.qlen - i + p.w, veB = B.qlen - i + p.w;
      const uint32_t pa = pick<S>(H, veA - v0), pb = pick<S>(H, veB - v0);
      heA = lo16(__shfl_sync(kFull, pa, min(max(veA, 0), WP - 1) / S));
      heB = hi16(__shfl_sync(kFull, pb, min(max(veB, 0), WP - 1) / S));
      heA = h_end_of(p, A, i, heA, WP);
      heB = h_end_of(p, B, i, heB, WP);
    }
    if (!A.dead) {
      const bool live = LA <= RA;
      job_row(p, A, i, live ? kA >> kKeyBits : -1,
              live ? (kA & ((1 << kKeyBits) - 1)) + i - p.w : -1, heA, wantA);
    }
    if (!B.dead) {
      const bool live = LB <= RB;
      job_row(p, B, i, live ? kB >> kKeyBits : -1,
              live ? (kB & ((1 << kKeyBits) - 1)) + i - p.w : -1, heB, wantB);
    }
  }
}

// the int32 row-max key: value << 11 | lane, 64-bit for BIG
template <bool BIG>
struct Key {
  using T = typename std::conditional<BIG, long long, int>::type;
  __device__ static T make(int h, int v) {
    if constexpr (BIG) return ((long long)h << 32) | (unsigned)v;
    else return (h << kKeyBits) | v;
  }
  __device__ static int value(T k) {
    if constexpr (BIG) return (int)(k >> 32);
    else return k >> kKeyBits;
  }
  __device__ static int lane(T k) {
    if constexpr (BIG) return (int)(k & 0xffffffffLL);
    else return k & ((1 << kKeyBits) - 1);
  }
  __device__ static T reduce(T k) {
    if constexpr (!BIG) {
      return __reduce_max_sync(kFull, k);
    } else {
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        const T o = __shfl_xor_sync(kFull, k, d);
        k = o > k ? o : k;
      }
      return k;
    }
  }
};

// One alignment a warp on int32 cells (BIG: the score from the shared
// matrix by the column's code, and a 64-bit key).
template <int S, bool BIG>
__device__ __forceinline__ void run_one32(const Params& p, const int* smat,
                                          Job& A) {
  using K = Key<BIG>;
  constexpr int S4 = S / 4;
  constexpr int WP = 32 * S;
  const int lane = threadIdx.x & 31;
  const int v0 = lane * S;
  const int e_ins = p.e_ins, e_del = p.e_del, nw = p.PW / 4;
  const int oe_ins = p.o_ins + e_ins, oe_del = p.o_del + e_del;

  int H[S], E[S], M[S], Gs[S];
  bool band[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int v = v0 + s;
    band[s] = v >= A.lo_v && v <= A.hi_v;
    H[s] = band[s] ? virt_h(p, A, v) : 0;
    E[s] = band[s] ? virt_e(p, A, v) : 0;
  }
  const int cu = e_ins * (v0 + S - 1), cx = -e_ins * (v0 - 1);
  int tc = A.dead ? 4 : clamp04(A.trow[0]);
  for (int i = 0; !A.dead; ++i) {
    uint32_t sw[S4];
    row_scores<S>(A.prof + (BIG ? 0 : tc) * nw, i + v0 + 1, p.PW, sw);
    const int* mrow = smat + tc * 5;
    tc = i + 1 < A.nrows ? clamp04(A.trow[i + 1]) : 4;
    int e_in = __shfl_down_sync(kFull, E[0], 1);
    if (lane == 31) e_in = 0;
    int y = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int hd = H[s];
      int m;
      if (BIG) {
        const int c = (sw[s >> 2] >> (8 * (s & 3))) & 0xff;
        m = hd > 0 ? hd + (c == 255 ? kDeadScore : mrow[c]) : 0;
      } else {
        m = hd > 0 ? hd + sbyte(sw[s >> 2], s & 3) : 0;
      }
      M[s] = m;
      const int g = __viaddmax_s32_relu(m, -oe_ins, 0);
      Gs[s] = g;
      y = __viaddmax_s32(y, -e_ins, g);
    }
    int incl = y + cu;
    incl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) incl = kNeg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    int x = lane == 0 ? kNeg : incl + cx;
    int L, R;
    live_range(p, A, i, L, R);
    const int a = L - v0, b = R - v0;
    typename K::T key = K::make(0, v0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int m = M[s];
      const int xe = (s + 1 < S) ? E[s + 1] : e_in;  // E(i-1, u)
      int hn = __vimax3_s32_relu(m, xe, x);
      x = __viaddmax_s32(x, -e_ins, Gs[s]);
      int en = __viaddmax_s32_relu(xe, -e_del, m - oe_del);
      hn = band[s] ? hn : 0;
      E[s] = band[s] ? en : 0;
      H[s] = hn;
      const typename K::T kv = K::make(s >= a && s <= b ? hn : 0, v0 + s);
      key = kv >= key ? kv : key;
    }
    key = K::reduce(key);
    const bool want = i + A.w_lane + 1 >= A.qlen;
    int he = kNeg;
    if (want) {
      const int ve = A.qlen - i + p.w;
      he = __shfl_sync(kFull, pick<S>(H, ve - v0), min(max(ve, 0), WP - 1) / S);
      he = h_end_of(p, A, i, he, WP);
    }
    const bool live = L <= R;
    job_row(p, A, i, live ? K::value(key) : -1,
            live ? K::lane(key) + i - p.w : -1, he, want);
  }
}

// one alignment on int32 cells: its profile, the rows, its output
template <int S>
__device__ __forceinline__ void run_int32(const Params& p, const int* smat,
                                          Job& J, int amax, bool big_mat) {
  if (J.job < 0) return;
  const bool big =
      big_mat || (long long)J.h0 + (long long)amax * J.nrows >= kBigScore;
  if (big) build_prof<true>(p, smat, J.prof, J);
  else build_prof<false>(p, smat, J.prof, J);
  __syncwarp();
  if (big) run_one32<S, true>(p, smat, J);
  else run_one32<S, false>(p, smat, J);
  job_out(p, J);
  __syncwarp();  // the profile is the next alignment's
}

// the kernel for a window of WP = 32 * S lanes: persistent warps over
// units of two consecutive jobs of the order, on 16-bit pairs where both
// fit, else one a warp on int32 cells
template <int S>
__global__ void __launch_bounds__(kWarps * 32)
extend_banded_kernel(Params p) {
  extern __shared__ uint32_t smem_prof[];  // two profiles a warp
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = p.mat[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int nw = p.PW / 4;
  uint32_t* profA = smem_prof + (size_t)warp * 2 * 5 * nw;
  uint32_t* profB = profA + 5 * nw;
  int amax = 0, amin = 0;
  for (int x = 0; x < 25; ++x) {
    amax = max(amax, smat[x]);
    amin = min(amin, smat[x]);
  }
  const bool big_mat = amax > 127 || amin < -128;
  const int units = (p.N + 1) / 2;
  for (int unit = blockIdx.x * wpb + warp; unit < units;
       unit += gridDim.x * wpb) {
    const int pos = 2 * unit;
    const int entA = p.order[pos];
    const int entB = pos + 1 < p.N ? p.order[pos + 1] : -1;
    Job A, B;
    job_init(p, entA, A);
    job_init(p, entB, B);
    A.prof = profA;
    B.prof = profB;
    const bool f16 = (entA & kFits16) != 0 && (entB < 0 || (entB & kFits16));
    if (f16) {
      build_prof<false>(p, smat, profA, A);
      build_prof<false>(p, smat, profB, B);
      __syncwarp();
      run_pair16<S>(p, A, B);
      job_out(p, A);
      job_out(p, B);
    } else {
      run_int32<S>(p, smat, A, amax, big_mat);
      run_int32<S>(p, smat, B, amax, big_mat);
    }
    __syncwarp();  // the profiles are the next unit's
  }
}

template <int S>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t per_warp = (size_t)2 * 5 * p.PW;
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > (size_t)kMaxSmemBytes) --warps;
  const size_t smem = warps * per_warp;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      extend_banded_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int g = jobbins::grid_for(extend_banded_kernel<S>, warps * 32, smem,
                                  (p.N + 1) / 2, warps);
  extend_banded_kernel<S><<<g, warps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

// K3's binner (job_bins.cuh): one width class; whether the alignment
// takes 16-bit cells (the wrapper's fits_i16), then its rows
struct Binner {
  const int* tlen;
  const int* h0;
  const int* mat;
  int N, TMAX, margin;
  int amax, amin;
  __device__ void prepare() {
    amax = amin = 0;
    for (int x = 0; x < 25; ++x) {
      amax = max(amax, mat[x]);
      amin = min(amin, mat[x]);
    }
  }
  __device__ int bin(int j, bool& fits) const {
    const int rows = min(max(tlen[j], 0), TMAX);
    const int h = h0[j];
    fits = h >= 0 && amax <= 1 && amin >= -128 &&
           (long long)h + (long long)amax * rows + margin < (1LL << 14);
    return jobbins::bin_of(0, fits, rows);
  }
};

}  // namespace

extern "C" {

// Launch on `stream`; out is (N, 6) int32 rows
// [score, qle, tle, gscore, gtle, max_off]. The window is
// WP = round128(2w + 3) lanes, at most 1024. `work` is a device buffer of
// N + 1024 int32 for the job order; two profiles of 5 * round4(QMAX + w +
// WP/32 + 8) bytes a warp must fit a block's shared memory. Returns a
// cudaError_t code.
int bm_extend_banded(const void* q, const void* t, const void* qlen,
                     const void* tlen, const void* h0, const void* mat,
                     void* work, void* out, int N, int QMAX, int TMAX,
                     int o_del, int e_del, int o_ins, int e_ins, int w,
                     int zdrop, int end_bonus, int a, void* stream) {
  if (N <= 0) return 0;
  if (QMAX < 1 || w < 0 || e_del < 1 || e_ins < 1 || N >= kFits16)
    return (int)cudaErrorInvalidValue;
  const int WP = (2 * w + 3 + 127) / 128 * 128;
  const int S = WP / 32;
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.t = static_cast<const int8_t*>(t);
  p.qlen = static_cast<const int*>(qlen);
  p.tlen = static_cast<const int*>(tlen);
  p.h0 = static_cast<const int*>(h0);
  p.mat = static_cast<const int*>(mat);
  p.out = static_cast<int*>(out);
  p.N = N;
  p.QMAX = QMAX;
  p.TMAX = TMAX;
  p.PW = (QMAX + w + S + 8 + 3) / 4 * 4;
  p.o_del = o_del;
  p.e_del = e_del;
  p.o_ins = o_ins;
  p.e_ins = e_ins;
  p.w = w;
  p.zdrop = zdrop;
  p.end_bonus = end_bonus;
  p.a = a;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // fits_i16's margin; one past 2^14 admits no job
  const int oe = o_del + e_del > o_ins + e_ins ? o_del + e_del : o_ins + e_ins;
  const long long m_ll = (long long)e_ins * (WP + 1) + oe + end_bonus;
  Binner bn;
  bn.tlen = p.tlen;
  bn.h0 = p.h0;
  bn.mat = p.mat;
  bn.N = N;
  bn.TMAX = TMAX;
  bn.margin = m_ll < 0 ? 0 : m_ll > (1 << 14) ? (1 << 14) : (int)m_ll;
  int *counts, *order;
  cudaError_t err = jobbins::build_order(bn, static_cast<int*>(work), st,
                                         &counts, &order);
  if (err != cudaSuccess) return (int)err;
  p.order = order;
  switch (S) {
    case 4: return (int)launch<4>(p, st);
    case 8: return (int)launch<8>(p, st);
    case 12: return (int)launch<12>(p, st);
    case 16: return (int)launch<16>(p, st);
    case 20: return (int)launch<20>(p, st);
    case 24: return (int)launch<24>(p, st);
    case 28: return (int)launch<28>(p, st);
    case 32: return (int)launch<32>(p, st);
  }
  return (int)cudaErrorInvalidValue;  // WP > 1024: not supported
}

const char* bm_banded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
