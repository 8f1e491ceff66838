// Batched local Smith-Waterman with start positions (ksw_align2
// semantics), for Hopper (sm_90a). The mate-rescue DP of paired-end
// alignment.
//
// Replaces the Pallas TPU kernel bwamem_tpu/ops/pallas/swalign_kernel.py
// (_make_sw_kernel, launched twice by _sw_pallas_impl from
// sw_align_batch_pallas_stacked, with the score2 window and the reverse
// gathers in XLA between the launches). The contract is
// bwamem_tpu/ops/swalign.py:sw_align_batch: affine gaps, 5x5 score
// matrix, E from the previous row's H, F closed along the row. Per job it
// reports
//   score  the best cell; qe, te its 0-based column and row. A row's max
//          goes to its EARLIEST column; best moves only on a strict
//          improvement, so the EARLIEST row wins a tie. qe = te = -1 when
//          score is 0;
//   score2 the largest row max >= minsc over rows outside
//          te +- ceil(score / a), 0 when there is none;
//   qb, tb from a reverse sweep over q[qe..0] and t[te..0]: qe - rqe and
//          te - rte when the reverse best equals score, else -1. With
//          rev_skip > 0, jobs whose score is below rev_skip skip the
//          reverse sweep and report qb = tb = -1.
//
// Design: one warp per job, the forward sweep, score2 and the reverse
// sweep in one launch. Lane l holds the strip of S columns
// [l*S, l*S + S) of H and E in registers. Per target row:
//   * the diagonal H(i-1, j-1) at a strip's left edge comes from the
//     previous lane by __shfl_up_sync;
//   * the row's F is a running max of G(j) = Hp(j) + e_ins*j, where Hp is
//     the cell before F: each lane reduces its strip, a warp-shuffle
//     exclusive max-scan gives every strip its carry-in, and an in-lane
//     pass finishes the strip;
//   * the row max and its earliest column come from one warp reduction on
//     (value, column); lane 0 keeps it in this warp's slice of dynamic
//     shared memory for score2.
// Each warp runs to its own tlen; nothing is sorted or padded.
//
// What bounds it: integer work along a serial chain of target rows (about
// tlen rows forward, te + 1 back), each row a few shuffle rounds; a job
// reads QMAX + TMAX bytes and writes 24. So the kernel is bound by the
// latency of that chain and by how many warps are in flight, not by
// memory bandwidth. DPX min/max and 16-bit lanes are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kMaxSmemBytes = 232448;  // 227 KB a block may use on sm_90

__device__ __forceinline__ int clamp04(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

// One local-SW sweep of this warp over target rows t[0], t[step],
// ..., t[(nrows-1)*step] against the query strip qc (qlen live columns).
// Returns best, qe, te in every lane; with rowmax != nullptr, lane 0
// stores each row's max there.
template <int S>
__device__ __forceinline__ void sweep(const int (&qc)[S], int qlen,
                                      const int8_t* t, int step, int nrows,
                                      const int* smat, int o_del, int e_del,
                                      int o_ins, int e_ins, int* rowmax,
                                      int& best, int& qe, int& te) {
  const int lane = threadIdx.x & 31;
  const int j0 = lane * S;
  const int oe_del = o_del + e_del;
  int H[S], E[S], Hp[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    H[s] = 0;
    E[s] = 0;
  }
  best = 0;
  qe = -1;
  te = -1;
  for (int i = 0; i < nrows; ++i) {
    const int* mrow = smat + clamp04(t[(ptrdiff_t)step * i]) * 5;
    // H(i-1, j-1) for the strip's first column: the previous lane's last
    int hleft = __shfl_up_sync(kFull, H[S - 1], 1);
    if (lane == 0) hleft = 0;
    int gmax = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = j0 + s;
      const int hd = (s == 0) ? hleft : H[s - 1];
      E[s] = max(max(E[s] - e_del, H[s] - oe_del), 0);
      const int hp = j < qlen ? max(max(hd + mrow[qc[s]], E[s]), 0) : 0;
      Hp[s] = hp;
      gmax = max(gmax, hp + e_ins * j);
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

    int rmax = -1, rcol = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = j0 + s;
      const int f = run - e_ins * j - o_ins;
      const int h = j < qlen ? max(max(Hp[s], f), 0) : 0;
      run = max(run, Hp[s] + e_ins * j);
      H[s] = h;
      if (h > rmax) {  // strict: the earliest column keeps a tie
        rmax = h;
        rcol = j;
      }
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int ov = __shfl_xor_sync(kFull, rmax, d);
      const int oc = __shfl_xor_sync(kFull, rcol, d);
      if (ov > rmax || (ov == rmax && oc < rcol)) {
        rmax = ov;
        rcol = oc;
      }
    }
    if (rowmax != nullptr && lane == 0) rowmax[i] = rmax;
    if (rmax > best) {
      best = rmax;
      qe = rcol;
      te = i;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
sw_local_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                const int* __restrict__ qlen_, const int* __restrict__ tlen_,
                const int* __restrict__ minsc_, const int* __restrict__ mat,
                int* __restrict__ out, int N, int QMAX, int TMAX, int o_del,
                int e_del, int o_ins, int e_ins, int a, int rev_skip) {
  extern __shared__ int smem_rowmax[];  // TMAX ints per warp
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int job = blockIdx.x * (blockDim.x >> 5) + warp;
  if (job >= N) return;  // whole warp: one job per warp
  int* rowmax = smem_rowmax + (size_t)warp * TMAX;

  const int qlen = min(max(qlen_[job], 0), QMAX);
  const int nrows = min(max(tlen_[job], 0), TMAX);
  const int8_t* qrow = q + (size_t)job * QMAX;
  const int8_t* trow = t + (size_t)job * TMAX;
  const int j0 = lane * S;

  int qc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = j0 + s;
    qc[s] = j < qlen ? clamp04(qrow[j]) : 4;
  }
  int best, qe, te;
  sweep<S>(qc, qlen, trow, 1, nrows, smat, o_del, e_del, o_ins, e_ins,
           rowmax, best, qe, te);
  __syncwarp();

  // score2: rows outside te +- ceil(best / a) whose max reaches minsc;
  // rows at or past tlen count as 0
  const int halfw = (best + a - 1) / a;
  const int minsc = minsc_[job];
  int score2 = 0;
  for (int r = lane; r < nrows; r += 32) {
    const int v = rowmax[r];
    if ((r < te - halfw || r > te + halfw) && v >= minsc)
      score2 = max(score2, v);
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1)
    score2 = max(score2, __shfl_xor_sync(kFull, score2, d));

  // reverse sweep over q[qe..0], t[te..0] for the start coordinates
  int qb = -1, tb = -1;
  if (rev_skip <= 0 || best >= rev_skip) {
    const int rql = max(qe + 1, 0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = j0 + s;
      qc[s] = j < rql ? clamp04(qrow[qe - j]) : 4;
    }
    int rbest, rqe, rte;
    sweep<S>(qc, rql, trow + te, -1, max(te + 1, 0), smat, o_del, e_del,
             o_ins, e_ins, nullptr, rbest, rqe, rte);
    if (rbest == best) {
      qb = qe - rqe;
      tb = te - rte;
    }
  }
  if (lane == 0) {  // (6, N) rows in SW_KEYS order
    out[job] = best;
    out[(size_t)N + job] = qb;
    out[(size_t)2 * N + job] = qe;
    out[(size_t)3 * N + job] = tb;
    out[(size_t)4 * N + job] = te;
    out[(size_t)5 * N + job] = score2;
  }
}

template <int S>
cudaError_t launch(const void* q, const void* t, const void* qlen,
                   const void* tlen, const void* minsc, const void* mat,
                   void* out, int N, int QMAX, int TMAX, int o_del, int e_del,
                   int o_ins, int e_ins, int a, int rev_skip,
                   cudaStream_t stream) {
  // as many warps per block as the row-max slices fit in shared memory
  const size_t per_warp = (size_t)TMAX * sizeof(int);
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * per_warp > (size_t)kMaxSmemBytes) --warps;
  const size_t smem = warps * per_warp;
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_local_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 block(warps * 32);
  const dim3 grid((N + warps - 1) / warps);
  sw_local_kernel<S><<<grid, block, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(t),
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(minsc), static_cast<const int*>(mat),
      static_cast<int*>(out), N, QMAX, TMAX, o_del, e_del, o_ins, e_ins, a,
      rev_skip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; out is (6, N) int32 in the order score, qb, qe, tb,
// te, score2. Returns a cudaError_t code.
int bm_sw_local(const void* q, const void* t, const void* qlen,
                const void* tlen, const void* minsc, const void* mat,
                void* out, int N, int QMAX, int TMAX, int o_del, int e_del,
                int o_ins, int e_ins, int a, int rev_skip, void* stream) {
  if (N <= 0) return 0;
  if (QMAX < 1 || TMAX < 1 || a < 1) return (int)cudaErrorInvalidValue;
  const int S = (QMAX + 31) / 32;  // query columns 0..QMAX-1 per warp
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BM_LAUNCH(SS)                                                      \
  return (int)launch<SS>(q, t, qlen, tlen, minsc, mat, out, N, QMAX, TMAX, \
                         o_del, e_del, o_ins, e_ins, a, rev_skip, st)
  if (S <= 1) BM_LAUNCH(1);
  if (S <= 2) BM_LAUNCH(2);
  if (S <= 3) BM_LAUNCH(3);
  if (S <= 4) BM_LAUNCH(4);
  if (S <= 6) BM_LAUNCH(6);
  if (S <= 8) BM_LAUNCH(8);
  if (S <= 12) BM_LAUNCH(12);
  if (S <= 16) BM_LAUNCH(16);
  if (S <= 24) BM_LAUNCH(24);
  if (S <= 32) BM_LAUNCH(32);
#undef BM_LAUNCH
  return (int)cudaErrorInvalidValue;  // QMAX > 1024: not supported
}

const char* bm_sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
