// The job order of the port's DP kernels (K1 extend_kernel.cu, K2
// swalign_kernel.cu, K3 extend_banded.cu), built on the device before the
// DP kernels run: three small kernels count each job's bin, scan the
// counts into each bin's first slot, and scatter the jobs into their
// bins. A bin is a width class (widest first), then the jobs that take
// 16-bit cells first, then the job's rows in powers of two (most first),
// so that the jobs a warp runs side by side are alike and the longest
// start first. ops/kernels/extend_kernel.py job_bins states the same rule
// in torch ops for the tests.
//
// Each kernel supplies a binner B: a plain struct with
//   __device__ void prepare();                 // once per block, thread 0
//   __device__ int bin(int j, bool& fits) const;  // bin_of(...) of job j
//   int N;                                     // the jobs
// The workspace is kWorkHeader ints (counts, cursors, each class's jobs)
// followed by the N entries of the order: a job's index, with kFits16 set
// when it takes 16-bit cells.

#pragma once

#include <cuda_runtime.h>

namespace jobbins {

// width classes 0..5 run from registers: (S, G) = (4, 8), (8, 8), (8, 16),
// (8, 32), (16, 32), (32, 32) for at most 32, 64, 128, 256, 512, 1024
// columns (G lanes of S columns each); class 6 is K1's wide route
constexpr int kClasses = 7;
constexpr int kRegClasses = 6;
constexpr int kRowBins = 22;  // rows 0, 1, 2-3, 4-7, ..., 2^20 or more
constexpr int kBins = kClasses * 2 * kRowBins;
constexpr int kWorkHeader = 1024;  // ints of the workspace before the order
static_assert(2 * kBins + kClasses <= kWorkHeader, "workspace header");
constexpr int kFits16 = 1 << 30;  // an order entry's flag

__host__ __device__ constexpr int class_S(int c) {
  return c == 0 ? 4 : c <= 3 ? 8 : c == 4 ? 16 : 32;
}
__host__ __device__ constexpr int class_G(int c) {
  return c <= 1 ? 8 : c == 2 ? 16 : 32;
}
__host__ __device__ constexpr int class_cols(int c) {
  return class_S(c) * class_G(c);
}

// the first class that holds `cols` columns (kRegClasses past 1024)
__host__ __device__ inline int class_of(int cols) {
  int c = 0;
  while (c < kRegClasses && cols > class_cols(c)) ++c;
  return c;
}

__device__ __forceinline__ int bin_of(int cls, bool fits, int rows) {
  const int rb = rows <= 0 ? 0 : min(32 - __clz(rows), kRowBins - 1);
  return ((kClasses - 1 - cls) * 2 + (fits ? 0 : 1)) * kRowBins +
         (kRowBins - 1 - rb);
}

template <class B>
__global__ void count_kernel(B b, int* cnt) {
  __shared__ int hist[kBins];
  __shared__ B sb;
  for (int x = threadIdx.x; x < kBins; x += blockDim.x) hist[x] = 0;
  if (threadIdx.x == 0) {
    sb = b;
    sb.prepare();
  }
  __syncthreads();
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < sb.N;
       j += gridDim.x * blockDim.x) {
    bool fits;
    atomicAdd(&hist[sb.bin(j, fits)], 1);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < kBins; x += blockDim.x)
    if (hist[x] != 0) atomicAdd(&cnt[x], hist[x]);
}

// one thread: each bin's first slot of the order, and each class's jobs
__global__ void scan_kernel(const int* cnt, int* cursor, int* counts) {
  int per_class[kClasses] = {};
  int off = 0;
  for (int x = 0; x < kBins; ++x) {
    cursor[x] = off;
    off += cnt[x];
    per_class[kClasses - 1 - x / (2 * kRowBins)] += cnt[x];
  }
  for (int c = 0; c < kClasses; ++c) counts[c] = per_class[c];
}

// each job into a slot of its bin, flagged kFits16 where it fits 16 bits
// (the order within a bin varies from run to run; no result depends on it)
template <class B>
__global__ void scatter_kernel(B b, int* cursor, int* order) {
  __shared__ B sb;
  if (threadIdx.x == 0) {
    sb = b;
    sb.prepare();
  }
  __syncthreads();
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < sb.N;
       j += gridDim.x * blockDim.x) {
    bool fits;
    const int x = sb.bin(j, fits);
    order[atomicAdd(&cursor[x], 1)] = j | (fits ? kFits16 : 0);
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// the job order of b.N jobs into `work` (kWorkHeader + N ints) on `st`;
// *counts and *order point into it: each class's jobs, and the order
template <class B>
cudaError_t build_order(const B& b, int* work, cudaStream_t st, int** counts,
                        int** order) {
  int* cnt = work;
  int* cursor = cnt + kBins;
  *counts = cnt + 2 * kBins;
  *order = cnt + kWorkHeader;
  const int pb = max(1, min((b.N + 255) / 256, 4 * sm_count()));
  cudaError_t err = cudaMemsetAsync(cnt, 0, kBins * sizeof(int), st);
  if (err != cudaSuccess) return err;
  count_kernel<B><<<pb, 256, 0, st>>>(b, cnt);
  scan_kernel<<<1, 1, 0, st>>>(cnt, cursor, *counts);
  scatter_kernel<B><<<pb, 256, 0, st>>>(b, cursor, *order);
  return cudaGetLastError();
}

// persistent grid: as many blocks as the card holds at once, at most one
// warp per job
template <typename F>
int grid_for(F kernel, int threads, size_t smem, int N, int wpb) {
  int per_sm = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const int need = (N + wpb - 1) / wpb;
  return max(1, min(need, per_sm * sm_count()));
}

}  // namespace jobbins
