// The 16-bit probe, for Hopper (sm_90a): six int16 op classes, each a
// kernel of its own, computed two lanes at a time in one 32-bit register.
//
// Replaces the Pallas TPU kernel of tools/mosaic_probe.py (run_case, one
// pl.pallas_call per op class on an (8, 128) int16 block). That probe
// asks whether Mosaic lowers the ops a 16-bit extension DP needs; this one
// asks the same of Hopper: can a K1/K3 cell run as packed int16x2 SIMD
// and DPX instructions, two DP cells per 32-bit lane? Each case takes
// int16 (R, C), C even, and returns int16 (R, C):
//   0 compare  where(x > 3, x, 0)              __vcmpgts2 mask, and
//   1 reduce   the row max, broadcast          __vimax3_s16x2 (DPX) over
//                                               two words a step, then
//                                               __vmaxs2 warp tree and a
//                                               block step
//   2 iota     x + column index (wraps mod 2^16) __vadd2
//   3 shift    the row shifted right one lane,  __shfl_up_sync of the
//              0 in column 0                    neighbouring word, then
//   4 roll     roll(x, 1, axis=1): column 0     __byte_perm; a warp's
//              takes the row's last lane        first word loads its
//                                               carry (the previous word,
//                                               or the row's last word
//                                               for the roll, 0 for the
//                                               shift's column 0)
//   5 convert  x -> int32 -> int16              sign-extending unpack and
//                                               repack
// Word j of a row holds columns 2j (low half) and 2j + 1 (high half).
//
// Design: one block of 128 threads per row; thread t takes words t,
// t + 128, ... (neighbouring threads on neighbouring words, so every load
// and store is coalesced).
//
// What bounds it: bytes. A case reads 2·R·C bytes and writes as many, and
// does a handful of integer operations per 4 bytes, far below the card's
// rate; the bound is 4·R·C bytes over the memory rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kMin2 = 0x80008000u;  // -32768 in both halves

template <int CASE>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int W) {
  const uint32_t* row = x + (size_t)blockIdx.x * W;
  uint32_t* orow = out + (size_t)blockIdx.x * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (CASE == 1) {
    uint32_t m = kMin2;
    for (int j = tid; j < W; j += 2 * kThreads) {
      const uint32_t b = j + kThreads < W ? row[j + kThreads] : kMin2;
      m = __vimax3_s16x2(m, row[j], b);
    }
    for (int off = 16; off > 0; off >>= 1)
      m = __vmaxs2(m, __shfl_xor_sync(kFull, m, off));
    m = __vmaxs2(m, __byte_perm(m, 0, 0x1032));  // max of the two halves
    __shared__ uint32_t part[kThreads / 32];
    if (lane == 0) part[tid >> 5] = m;
    __syncthreads();
    static_assert(kThreads / 32 == 4, "the block step folds four warps");
    m = __vimax3_s16x2(part[0], part[1], __vmaxs2(part[2], part[3]));
    for (int j = tid; j < W; j += kThreads) orow[j] = m;
    return;
  }
  for (int j0 = 0; j0 < W; j0 += kThreads) {  // uniform over the block
    const int j = j0 + tid;
    const bool on = j < W;
    const uint32_t w = on ? row[j] : 0u;
    uint32_t r;
    if (CASE == 0) {
      r = w & __vcmpgts2(w, 0x00030003u);
    } else if (CASE == 2) {
      r = __vadd2(w, (uint32_t)(2 * j) | ((uint32_t)(2 * j + 1) << 16));
    } else if (CASE == 5) {
      const int lo = (int16_t)(w & 0xffffu);
      const int hi = (int)w >> 16;
      r = ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
    } else {  // 3 shift, 4 roll
      uint32_t prev = __shfl_up_sync(kFull, w, 1);
      if (lane == 0 && on)
        prev = j > 0 ? row[j - 1] : (CASE == 4 ? row[W - 1] : 0u);
      r = __byte_perm(prev, w, 0x5432);  // (w.lo << 16) | prev.hi
    }
    if (on) orow[j] = r;
  }
}

}  // namespace

extern "C" {

// Case `which` (0..5, in the order above) on int16 x (R, C) into out
// (R, C), both 4-byte aligned, on `stream`. Returns a cudaError_t code.
int bm_int16_probe(const void* x, void* out, int R, int C, int which,
                   void* stream) {
  if (R <= 0) return 0;
  if (C < 2 || C > 2048 || (C & 1)) return (int)cudaErrorInvalidValue;
  const int W = C / 2;
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* oi = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: probe_kernel<0><<<R, kThreads, 0, st>>>(xi, oi, W); break;
    case 1: probe_kernel<1><<<R, kThreads, 0, st>>>(xi, oi, W); break;
    case 2: probe_kernel<2><<<R, kThreads, 0, st>>>(xi, oi, W); break;
    case 3: probe_kernel<3><<<R, kThreads, 0, st>>>(xi, oi, W); break;
    case 4: probe_kernel<4><<<R, kThreads, 0, st>>>(xi, oi, W); break;
    case 5: probe_kernel<5><<<R, kThreads, 0, st>>>(xi, oi, W); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* bm_int16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
