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
//   * once the band has passed the query end (i - w > qlen) h_end reads
//     0, the dense row's stored value there;
//   * the query window shifts one lane per row whether or not the
//     alignment is still live.
//
// Design: one warp per alignment, as K1. Lane l holds the strip of
// S = WP/32 window lanes [l*S, l*S + S) of H, E and the query codes in
// registers (S = 8 at w = 100, 20 at w = 300). Per target row:
//   * E's one-lane shift is a register shift plus one __shfl_down_sync;
//   * F is closed by a strip max, a warp-shuffle exclusive max-scan and
//     an in-lane running max;
//   * the row max and its largest lane come from one warp reduction on
//     (value, lane); h_end is one shuffle from the lane that holds u = qlen;
//   * the query window shifts the same way, and lane 31 reads the one new
//     right-edge code from global memory.
// The TPU kernel's workarounds are gone: no masked full-width reductions
// for the target byte and the new query code, no packed-key argmax, no
// sort by tlen (each warp runs to its own tlen and exits when its
// alignment dies).
//
// What bounds it: integer work along a serial chain of target rows, each
// row a few shuffle rounds over a window of WP lanes, whatever the read
// length; an alignment reads about QMAX + TMAX bytes and writes 24. So it
// is bound by the latency of that chain and the warps in flight, not by
// memory bandwidth.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// floor division for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp04(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

template <int S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
extend_banded_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ t,
                     const int* __restrict__ qlen_,
                     const int* __restrict__ tlen_,
                     const int* __restrict__ h0_, const int* __restrict__ mat,
                     int* __restrict__ out, int N, int QMAX, int TMAX,
                     int o_del, int e_del, int o_ins, int e_ins, int w,
                     int zdrop, int end_bonus, int a) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  constexpr int WP = 32 * S;
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (job >= N) return;  // whole warp: one alignment per warp

  const int qlen = qlen_[job];
  const int tlen = tlen_[job];
  const int h0 = h0_[job];
  const int oe_del = o_del + e_del;
  const int oe_ins = o_ins + e_ins;
  int max_ins = floor_div(qlen * a + end_bonus - o_ins, e_ins) + 1;
  int max_del = floor_div(qlen * a + end_bonus - o_del, e_del) + 1;
  max_ins = max_ins < 1 ? 1 : max_ins;
  max_del = max_del < 1 ? 1 : max_del;
  const int w_lane = min(min(max_ins, max_del), w);
  const int lo_v = w - w_lane + 1, hi_v = w + w_lane + 1;
  const int v0 = lane * S;
  const int8_t* qrow = q + (size_t)job * QMAX;

  // the virtual row -1: lane v holds H(0, v - w - 1); query code q[v-w-1]
  int H[S], E[S], qw[S], M[S], X[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int u0 = v0 + s - w - 1;
    H[s] = (u0 < 0 || u0 > qlen) ? 0
                                 : (u0 == 0 ? h0
                                            : max(h0 - o_ins - e_ins * u0, 0));
    E[s] = 0;
    qw[s] = (u0 >= 0 && u0 < QMAX) ? clamp04(qrow[u0]) : 4;
  }

  int best = h0, qle = 0, tle = 0, gscore = -1, gtle = 0, max_off = 0;
  const int8_t* trow = t + (size_t)job * TMAX;
  const int nrows = min(tlen, TMAX);
  for (int i = 0; i < nrows; ++i) {
    const int* mrow = smat + clamp04(trow[i]) * 5;
    // E(i-1, u) sits one lane to the right in the previous window
    int e_in = __shfl_down_sync(kFull, E[0], 1);
    if (lane == 31) e_in = 0;
    unsigned live_bits = 0;
    int gmax = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = v0 + s;
      const int u = i + v - w;
      const bool live = u >= 1 && u <= qlen && v >= lo_v && v <= hi_v;
      live_bits |= (unsigned)live << s;
      const int ex = (s + 1 < S) ? E[s + 1] : e_in;
      const int m = H[s] > 0 ? H[s] + mrow[qw[s]] : 0;
      M[s] = live ? m : 0;
      X[s] = live ? ex : 0;
      const int g = (u <= 0) ? kNeg : max(M[s] - oe_ins, 0) + e_ins * v;
      gmax = max(gmax, g);
    }
    // exclusive max-scan of the strips' G maxima across the warp
    int incl = gmax;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    int run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = kNeg;

    const int b0 = max(h0 - (o_del + e_del * (i + 1)), 0);
    const int v_end = qlen - i + w;  // the lane holding u = qlen
    int rmax = -2, rlane = -1, hend = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = v0 + s;
      const int u = i + v - w;
      const bool live = (live_bits >> s) & 1u;
      const int f = live ? max(run - e_ins * v + e_ins, 0) : 0;
      if (u > 0) run = max(run, max(M[s] - oe_ins, 0) + e_ins * v);
      const int hn = (u == 0) ? b0 : max(max(M[s], X[s]), f);
      E[s] = max(X[s] - e_del, max(M[s] - oe_del, 0));
      H[s] = hn;
      // row max over live lanes; ties -> the later lane (larger u)
      const int ht = live ? hn : -1;
      if (ht >= rmax) {
        rmax = ht;
        rlane = v;
      }
      if (v == v_end) hend = hn;
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int ov = __shfl_xor_sync(kFull, rmax, d);
      const int ol = __shfl_xor_sync(kFull, rlane, d);
      if (ov > rmax || (ov == rmax && ol > rlane)) {
        rmax = ov;
        rlane = ol;
      }
    }
    const int rowmax = rmax;
    const int mj = rowmax >= 0 ? rlane + i - w : -1;
    int h_end = kNeg;
    if (v_end >= 0 && v_end < WP) h_end = __shfl_sync(kFull, hend, v_end / S);
    if (i - w > qlen) h_end = 0;  // the band has passed the query end

    if (h_end >= gscore && i + w_lane + 1 >= qlen) {
      gscore = h_end;
      gtle = i + 1;
    }
    const bool b_upd = rowmax > best;
    if (b_upd) {
      best = rowmax;
      qle = mj;
      tle = i + 1;
      max_off = max(max_off, abs(mj - 1 - i));
    }
    bool dead = rowmax == 0;
    if (zdrop > 0 && !b_upd) {
      const int di = i - (tle - 1);
      const int dj = (mj - 1) - (qle - 1);
      const int gap = di > dj ? (di - dj) * e_del : (dj - di) * e_ins;
      dead = dead || (best - rowmax - gap > zdrop);
    }
    if (dead) break;

    // slide the query window one lane: lane 31 fetches q[i + WP - w - 1]
    int q_in = __shfl_down_sync(kFull, qw[0], 1);
    if (lane == 31) {
      const int qi = i + WP - w - 1;
      q_in = (qi >= 0 && qi < QMAX) ? clamp04(qrow[qi]) : 4;
    }
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) qw[s] = qw[s + 1];
    qw[S - 1] = q_in;
  }
  if (lane == 0) {
    int* o = out + (size_t)job * 6;
    o[0] = best;
    o[1] = qle;
    o[2] = tle;
    o[3] = gscore;
    o[4] = gtle;
    o[5] = max_off;
  }
}

template <int S>
cudaError_t launch(const void* q, const void* t, const void* qlen,
                   const void* tlen, const void* h0, const void* mat, void* out,
                   int N, int QMAX, int TMAX, int o_del, int e_del, int o_ins,
                   int e_ins, int w, int zdrop, int end_bonus, int a,
                   cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  extend_banded_kernel<S><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(h0), static_cast<const int*>(mat),
      static_cast<int*>(out), N, QMAX, TMAX, o_del, e_del, o_ins, e_ins, w,
      zdrop, end_bonus, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; out is (N, 6) int32 rows
// [score, qle, tle, gscore, gtle, max_off]. The window is
// WP = round128(2w + 3) lanes, at most 1024. Returns a cudaError_t code.
int bm_extend_banded(const void* q, const void* t, const void* qlen,
                     const void* tlen, const void* h0, const void* mat,
                     void* out, int N, int QMAX, int TMAX, int o_del,
                     int e_del, int o_ins, int e_ins, int w, int zdrop,
                     int end_bonus, int a, void* stream) {
  if (N <= 0) return 0;
  if (QMAX < 1 || w < 0 || e_del < 1 || e_ins < 1)
    return (int)cudaErrorInvalidValue;
  const int WP = (2 * w + 3 + 127) / 128 * 128;
  const int S = WP / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BM_LAUNCH(SS)                                                      \
  return (int)launch<SS>(q, t, qlen, tlen, h0, mat, out, N, QMAX, TMAX,    \
                         o_del, e_del, o_ins, e_ins, w, zdrop, end_bonus, a, \
                         st)
  switch (S) {
    case 4: BM_LAUNCH(4);
    case 8: BM_LAUNCH(8);
    case 12: BM_LAUNCH(12);
    case 16: BM_LAUNCH(16);
    case 20: BM_LAUNCH(20);
    case 24: BM_LAUNCH(24);
    case 28: BM_LAUNCH(28);
    case 32: BM_LAUNCH(32);
  }
#undef BM_LAUNCH
  return (int)cudaErrorInvalidValue;  // WP > 1024: not supported
}

const char* bm_banded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
