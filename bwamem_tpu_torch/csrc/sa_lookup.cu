// Suffix-array lookup of BWT rows, for Hopper (sm_90a): each row's text
// position (sa_lookup).
//
// Replaces the XLA-compiled loop of bwamem_tpu/ops/fm.py sa_lookup_batch
// (:666), which smem_seed_batch's occurrence expansion calls
// (bwamem_tpu/ops/seeding.py _expand_occurrences, :965). No
// pl.pallas_call stands behind it: the JAX package walks with XLA ops.
// The contract is the port's plain version, ops/fm.sa_lookup_batch, bit
// for bit: at most sa_intv LF steps from the row to one whose SSA bit is
// set, then the sampled value (low uint32 word, plus the uint8 upper bits
// on a wide index) plus the steps taken.
//
// What bounds it on this card: a row takes up to sa_intv steps, each a
// dependent read of a 32 B SSA bitmap row and a 32 B occ row, so it is
// bound by the latency of that chain (the tables sit in L2 on the 4.6 Mbp
// world); the bytes each row must move are its input, its output and one
// sampled value.
//
// Layout (GPUSeed's locate_seeds_gpu): one thread per row, 128 a block,
// that stops at its sampled row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/kernels/build.py)
#include <stdint.h>

#include "fm_index.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace salk {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sa_lookup_kernel(fmi::FMPtrs p, const T* rows, int64_t n, int sa_intv,
                     T* out) {
  __shared__ fmi::FMConst c;
  fmi::load_const(c, p);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = fmi::sa_lookup_one<T>(c, p, rows[i], sa_intv);
}

}  // namespace salk

extern "C" {

// Text positions of n rows (wide: int64 rows and output, else int32).
// Returns a cudaError_t code.
int bm_sa_lookup(const fmi::FMPtrs* fm, const void* rows, long long n,
                 int wide, int sa_intv, void* out, void* stream) {
  if (n <= 0) return 0;
  if (sa_intv < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + salk::kThreads - 1) / salk::kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (wide)
    salk::sa_lookup_kernel<int64_t><<<grid, salk::kThreads, 0, st>>>(
        *fm, static_cast<const int64_t*>(rows), n, sa_intv,
        static_cast<int64_t*>(out));
  else
    salk::sa_lookup_kernel<int32_t><<<grid, salk::kThreads, 0, st>>>(
        *fm, static_cast<const int32_t*>(rows), n, sa_intv,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* bm_sa_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
