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
// Design: one warp per alignment. Lane l holds the contiguous strip of S
// columns [l*S, l*S + S) of H and E in registers (column u = query bases
// consumed, u = 0 .. QMAX). Per target row:
//   * the diagonal H(i-1, u-1) at a strip's left edge comes from the
//     previous lane by __shfl_up_sync;
//   * the intra-row F recurrence is closed as a running max of
//     G(u) = max(M(u) - oe_ins, 0) + e_ins*u: each lane reduces its strip,
//     a warp-shuffle exclusive max-scan gives every strip its carry-in, and
//     an in-lane running max finishes the strip;
//   * the row max and its last column come from one warp reduction on
//     (value, column).
// The target byte is read once per row; the loop exits when the
// alignment dies.
//
// Rows wider than 1023 columns (long reads) take a second route: one warp
// walks each row in chunks of kChunk = 512 columns (a strip of 16 per
// lane) and keeps the row's H and E in dynamic shared memory, 8 bytes a
// column, laid out so that lane l's s-th column of a chunk sits at
// s*32 + l (no bank conflicts; a lane only ever reads what it wrote).
// Across a chunk edge it carries the previous row's H at the chunk's last
// column (the next chunk's diagonal), F's running max and the row's
// (max, column) pair, merged so that a later chunk wins a tie. Chunks past
// the one holding column qlen are never run: their columns cannot reach
// columns <= qlen, and when no column is live the row max's column is
// QMAX, as the dense row gives. A row too wide for one warp's slice of
// shared memory (more than 28671 columns) keeps H and E in a global
// scratch buffer that the wrapper allocates instead.
//
// What bounds it: the work is integer and each alignment is a serial chain
// of target rows; an alignment reads about QMAX + TMAX bytes and writes 24.
// So the kernel is bound by the latency of that chain and by how many
// warps the card keeps in flight, not by memory bandwidth. The wide route
// adds a shared-memory load and store of 8 bytes per cell and per row,
// and wide rows hold fewer warps per SM. Faster versions
// (DPX min/max, 16-bit pairs, gathering the Q/T windows inside the kernel)
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/kernels/extend_kernel.py).

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
extend_dense_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                    const int* __restrict__ qlen_, const int* __restrict__ tlen_,
                    const int* __restrict__ h0_, const int* __restrict__ mat,
                    int* __restrict__ out, int N, int QMAX, int TMAX,
                    int o_del, int e_del, int o_ins, int e_ins, int w,
                    int zdrop, int end_bonus, int opt_ext, int a) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
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
  const int qcol = min(max(qlen, 0), QMAX);
  const int u0 = lane * S;

  int H[S], E[S], qc[S], M[S];
  const int8_t* qrow = q + (size_t)job * QMAX;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int u = u0 + s;
    qc[s] = (u >= 1 && u <= QMAX) ? clamp04(qrow[u - 1]) : 4;
    H[s] = (u == 0) ? h0 : max(h0 - o_ins - e_ins * u, 0);
    E[s] = 0;
  }

  int best = h0, qle = 0, tle = 0, gscore = -1, gtle = 0, max_off = 0;
  const int8_t* trow = t + (size_t)job * TMAX;
  const int nrows = min(tlen, TMAX);
  for (int i = 0; i < nrows; ++i) {
    const int* mrow = smat + clamp04(trow[i]) * 5;
    const int lo = i - w_lane, hi = i + w_lane + 1;
    // H(i-1, u-1) for the strip's first column: previous lane's last
    const int hleft = __shfl_up_sync(kFull, H[S - 1], 1);
    unsigned live_bits = 0;
    int gmax = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int u = u0 + s;
      const int hd = (s == 0) ? hleft : H[s - 1];
      const bool live = u <= qlen && u <= QMAX &&
                        (!opt_ext || u == 0 || (u - 1 >= lo && u - 1 < hi));
      live_bits |= (unsigned)live << s;
      const int m = (u >= 1 && hd > 0) ? hd + mrow[qc[s]] : 0;
      M[s] = live ? m : 0;
      E[s] = live ? E[s] : 0;
      const int g = (u == 0) ? kNeg : max(M[s] - oe_ins, 0) + e_ins * u;
      gmax = max(gmax, g);
    }
    // exclusive max-scan of the strips' G maxima across the warp
    int incl = gmax;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    int run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = kNeg;

    int rmax = -2, rcol = -1, hend = 0;
    const int b0 = max(h0 - (o_del + e_del * (i + 1)), 0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int u = u0 + s;
      const bool live = (live_bits >> s) & 1u;
      const int f = live ? max(run - e_ins * (u - 1), 0) : 0;
      if (u >= 1) run = max(run, max(M[s] - oe_ins, 0) + e_ins * u);
      const int hn = (u == 0) ? b0 : max(max(M[s], E[s]), f);
      E[s] = live ? max(E[s] - e_del, max(M[s] - oe_del, 0)) : 0;
      H[s] = hn;
      // row max over real columns; ties -> the later column
      const int ht = (u > QMAX) ? -2 : ((live && u >= 1) ? hn : -1);
      if (ht >= rmax) {
        rmax = ht;
        rcol = u;
      }
      if (u == qcol) hend = hn;
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
    const int rowmax = rmax, mj = rcol;
    const int h_end = __shfl_sync(kFull, hend, qcol / S);

    if (h_end >= gscore && (!opt_ext || i + w_lane + 1 >= qlen)) {
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

constexpr int kWideS = 16;              // columns per lane per chunk
constexpr int kChunk = 32 * kWideS;     // columns per chunk
constexpr int kMaxSmemBytes = 232448;   // 227 KB a block may use on sm_90

// The wide route: the same recurrence as extend_dense_kernel, walked in
// chunks of kChunk columns with the row in `row` (H at [0, ncols), E at
// [ncols, 2*ncols)): one warp's slice of dynamic shared memory, or of the
// global `scratch` buffer when that is given.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
extend_dense_wide_kernel(const int8_t* __restrict__ q,
                         const int8_t* __restrict__ t,
                         const int* __restrict__ qlen_,
                         const int* __restrict__ tlen_,
                         const int* __restrict__ h0_,
                         const int* __restrict__ mat, int* __restrict__ out,
                         int* __restrict__ scratch, int N, int QMAX, int TMAX,
                         int ncols, int o_del, int e_del, int o_ins,
                         int e_ins, int w, int zdrop, int end_bonus,
                         int opt_ext, int a) {
  extern __shared__ int smem_row[];
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  constexpr int S = kWideS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int job = blockIdx.x * (blockDim.x >> 5) + warp;
  if (job >= N) return;  // whole warp: one alignment per warp
  int* Hrow = scratch != nullptr ? scratch + (size_t)job * 2 * ncols
                                 : smem_row + (size_t)warp * 2 * ncols;
  int* Erow = Hrow + ncols;

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
  const int qcol = min(max(qlen, 0), QMAX);
  const int nch = qcol / kChunk + 1;  // the chunks holding columns 0..qcol
  const int8_t* qrow = q + (size_t)job * QMAX;

  // first row: H(0, u) = max(h0 - o_ins - e_ins*u, 0), H(0, 0) = h0
  for (int c = 0; c < nch; ++c) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int u = c * kChunk + lane * S + s;
      const int k = c * kChunk + s * 32 + lane;
      Hrow[k] = (u == 0) ? h0 : max(h0 - o_ins - e_ins * u, 0);
      Erow[k] = 0;
    }
  }

  int best = h0, qle = 0, tle = 0, gscore = -1, gtle = 0, max_off = 0;
  const int8_t* trow = t + (size_t)job * TMAX;
  const int nrows = min(tlen, TMAX);
  for (int i = 0; i < nrows; ++i) {
    const int* mrow = smat + clamp04(trow[i]) * 5;
    const int lo = i - w_lane, hi = i + w_lane + 1;
    const int b0 = max(h0 - (o_del + e_del * (i + 1)), 0);
    int hdiag = 0;      // H(i-1, first column - 1) of this chunk
    int run_in = kNeg;  // F's running max over the earlier chunks
    int row_max = -2, row_col = -1, h_end = 0;
    for (int c = 0; c < nch; ++c) {
      const int base = c * kChunk;
      const int u0 = base + lane * S;
      int H[S], E[S], M[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        H[s] = Hrow[base + s * 32 + lane];
        E[s] = Erow[base + s * 32 + lane];
      }
      int hleft = __shfl_up_sync(kFull, H[S - 1], 1);
      if (lane == 0) hleft = hdiag;
      hdiag = __shfl_sync(kFull, H[S - 1], 31);  // before it is overwritten
      unsigned live_bits = 0;
      int gmax = kNeg;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int u = u0 + s;
        const int hd = (s == 0) ? hleft : H[s - 1];
        const bool live = u <= qlen && u <= QMAX &&
                          (!opt_ext || u == 0 || (u - 1 >= lo && u - 1 < hi));
        live_bits |= (unsigned)live << s;
        const int qc = (u >= 1 && u <= QMAX) ? clamp04(qrow[u - 1]) : 4;
        const int m = (u >= 1 && hd > 0) ? hd + mrow[qc] : 0;
        M[s] = live ? m : 0;
        E[s] = live ? E[s] : 0;
        const int g = (u == 0) ? kNeg : max(M[s] - oe_ins, 0) + e_ins * u;
        gmax = max(gmax, g);
      }
      // exclusive max-scan across the warp, seeded with the earlier chunks
      int incl = gmax;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = max(incl, v);
      }
      int run = __shfl_up_sync(kFull, incl, 1);
      run = lane == 0 ? run_in : max(run, run_in);

      int rmax = -2, rcol = -1, hend = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int u = u0 + s;
        const bool live = (live_bits >> s) & 1u;
        const int f = live ? max(run - e_ins * (u - 1), 0) : 0;
        if (u >= 1) run = max(run, max(M[s] - oe_ins, 0) + e_ins * u);
        const int hn = (u == 0) ? b0 : max(max(M[s], E[s]), f);
        E[s] = live ? max(E[s] - e_del, max(M[s] - oe_del, 0)) : 0;
        Hrow[base + s * 32 + lane] = hn;
        Erow[base + s * 32 + lane] = E[s];
        // row max over real columns; ties -> the later column
        const int ht = (u > QMAX) ? -2 : ((live && u >= 1) ? hn : -1);
        if (ht >= rmax) {
          rmax = ht;
          rcol = u;
        }
        if (u == qcol) hend = hn;
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
      if (rmax >= row_max) {  // a later chunk wins a tie
        row_max = rmax;
        row_col = rcol;
      }
      if (qcol / kChunk == c)
        h_end = __shfl_sync(kFull, hend, (qcol - base) / S);
      run_in = __shfl_sync(kFull, run, 31);
    }
    const int rowmax = row_max;
    // no live column: every column up to QMAX holds -1, the last one wins
    const int mj = rowmax < 0 ? QMAX : row_col;

    if (h_end >= gscore && (!opt_ext || i + w_lane + 1 >= qlen)) {
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

cudaError_t launch_wide(const void* q, const void* t, const void* qlen,
                        const void* tlen, const void* h0, const void* mat,
                        void* out, void* scratch, int N, int QMAX, int TMAX,
                        int o_del, int e_del, int o_ins, int e_ins, int w,
                        int zdrop, int end_bonus, int opt_ext, int a,
                        cudaStream_t stream) {
  const int ncols = (QMAX + 1 + kChunk - 1) / kChunk * kChunk;
  const size_t per_warp = (size_t)ncols * 2 * sizeof(int);
  int warps = kWarpsPerBlock;
  size_t smem = 0;
  if (scratch == nullptr) {
    // as many warps per block as their rows fit in shared memory
    while (warps > 1 && warps * per_warp > (size_t)kMaxSmemBytes) --warps;
    smem = warps * per_warp;
    if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
    // the static smat counts against the same 48 KB default, so the
    // dynamic limit is raised for every launch that uses shared rows
    {
      const cudaError_t err = cudaFuncSetAttribute(
          extend_dense_wide_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
  }
  const dim3 block(warps * 32);
  const dim3 grid((N + warps - 1) / warps);
  extend_dense_wide_kernel<<<grid, block, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(h0), static_cast<const int*>(mat),
      static_cast<int*>(out), static_cast<int*>(scratch), N, QMAX, TMAX,
      ncols, o_del, e_del, o_ins, e_ins, w, zdrop, end_bonus, opt_ext, a);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch(const void* q, const void* t, const void* qlen,
                   const void* tlen, const void* h0, const void* mat, void* out,
                   int N, int QMAX, int TMAX, int o_del, int e_del, int o_ins,
                   int e_ins, int w, int zdrop, int end_bonus, int opt_ext,
                   int a, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  extend_dense_kernel<S><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(h0), static_cast<const int*>(mat),
      static_cast<int*>(out), N, QMAX, TMAX, o_del, e_del, o_ins, e_ins, w,
      zdrop, end_bonus, opt_ext, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; out is (N, 6) int32 rows
// [score, qle, tle, gscore, gtle, max_off]. Rows of more than 1024
// columns take the wide route; `scratch` is null there when one warp's
// row (8 bytes a column, rounded up to 512 columns) fits in shared memory,
// else a buffer of N * 2 * ncols ints. Returns a cudaError_t code.
int bm_extend_dense(const void* q, const void* t, const void* qlen,
                    const void* tlen, const void* h0, const void* mat,
                    void* out, void* scratch, int N, int QMAX, int TMAX,
                    int o_del, int e_del, int o_ins, int e_ins, int w,
                    int zdrop, int end_bonus, int opt_ext, int a,
                    void* stream) {
  if (N <= 0) return 0;
  if (QMAX < 1 || e_del < 1 || e_ins < 1) return (int)cudaErrorInvalidValue;
  const int S = (QMAX + 1 + 31) / 32;  // columns 0..QMAX per warp
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > 32)
    return (int)launch_wide(q, t, qlen, tlen, h0, mat, out, scratch, N, QMAX,
                            TMAX, o_del, e_del, o_ins, e_ins, w, zdrop,
                            end_bonus, opt_ext, a, st);
#define BM_LAUNCH(SS)                                                       \
  return (int)launch<SS>(q, t, qlen, tlen, h0, mat, out, N, QMAX, TMAX,     \
                         o_del, e_del, o_ins, e_ins, w, zdrop, end_bonus,   \
                         opt_ext, a, st)
  if (S <= 1) BM_LAUNCH(1);
  if (S <= 2) BM_LAUNCH(2);
  if (S <= 3) BM_LAUNCH(3);
  if (S <= 4) BM_LAUNCH(4);
  if (S <= 5) BM_LAUNCH(5);
  if (S <= 6) BM_LAUNCH(6);
  if (S <= 7) BM_LAUNCH(7);
  if (S <= 8) BM_LAUNCH(8);
  if (S <= 12) BM_LAUNCH(12);
  if (S <= 16) BM_LAUNCH(16);
  if (S <= 24) BM_LAUNCH(24);
  if (S <= 32) BM_LAUNCH(32);
#undef BM_LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached: S <= 32 here
}

const char* bm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
