// Backward FM walk of SMEM seeding, for Hopper (sm_90a): every candidate
// lane extended to the left on its k-side interval (seed_backward).
//
// Replaces the XLA-compiled lax.while_loop of bwamem_tpu/ops/seeding.py
// _backward_pass (:366) in mode "smem" (rounds 1 and 2 of smem_seed_batch).
// No pl.pallas_call stands behind it: the JAX package seeds with XLA ops.
// The contract is the port's plain version, ops/seeding._backward_pass
// without `schedule` and `text_walk`: each lane (read rid, interval (k,
// s) of the segment [qbeg, end)) prepends read bases while the base is
// not N, qbeg > 0 and the new interval keeps at least `floor` rows (1 by
// default). Output: the final (qb, k, s) of every lane.
//
// The early kill: a lane that reaches the same (qb, k, s) as the next
// lane of its group (the segment key, the read by default) stops, as in
// the plain version, but here only against the next lane of the same
// warp, both walking in lockstep (GPUSeed's N_SHUFFLES dedup); the last
// lane of a warp is never killed. Lanes come in (group, end) order, and
// two lanes of one group in one state walk on alike, so a killed lane's
// qb is at or above the final qb of a later-ending lane of its group and
// ops/seeding._containment_filter drops it whether or not it was killed.
// So the kernel equals the plain version on every lane the filter keeps,
// and on the keep mask; the raw (qb, k, s) of lanes that either version
// killed may differ.
//
// What bounds it on this card: each trip of a lane reads two 32 B occ rows
// (at k and k + s), a chain of dependent reads from a table that sits in
// L2 on the 4.6 Mbp world, so the walk is bound by the latency of those
// reads and by how long the longest lane of a warp walks.
//
// Layout (GPUSeed's find_seed_intervals_back): one thread per lane, 128 a
// block, the lane's state in registers; a warp loops while any of its
// lanes walks, and one shuffle a trip brings the next lane's state.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/kernels/build.py)
#include <stdint.h>

#include <type_traits>

#include "fm_index.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace seedbw {

using fmi::FMConst;

template <typename T>
struct BackArgs {
  const int32_t* reads;  // (B, L) codes, 4 = N or pad
  const int32_t* rid;    // (P,) read of each lane
  const int32_t* qbeg;   // (P,)
  const T* k;            // (P,)
  const T* s;            // (P,)
  const T* floor;        // (P,) or null: 1
  const int32_t* group;  // (P,) or null: rid
  int B, L, P;
  int32_t* qb_out;
  T* k_out;
  T* s_out;
};

// One trip of a live lane: prepend the base left of qb when the lane can
// (qb > 0, not N, at least `fl` rows left). Returns whether it did.
template <typename T>
BM_HD bool back_step(const FMConst& c, const int32_t* occ,
                     const int32_t* rd, T fl, int32_t& qb, T& kk, T& ss) {
  const int32_t j = qb - 1;
  if (j < 0) return false;
  const int base = rd[j];
  if (base >= 4) return false;
  T nk, ns;
  fmi::backward_ext(c, occ, kk, ss, base, nk, ns);
  if (!(ns >= fl)) return false;
  qb = j;
  kk = nk;
  ss = ns;
  return true;
}

// A lane's start state (rd: its read's codes; fl: its floor, 1 without
// one; grp: its group key, its read without one).
template <typename T>
BM_HD void load_lane(const BackArgs<T>& a, int lane, int32_t& qb, T& kk,
                     T& ss, T& fl, int32_t& grp, const int32_t*& rd) {
  qb = a.qbeg[lane];
  kk = a.k[lane];
  ss = a.s[lane];
  fl = a.floor ? a.floor[lane] : static_cast<T>(1);
  const int32_t r = a.rid[lane];
  grp = a.group ? a.group[lane] : r;
  rd = a.reads + static_cast<int64_t>(r) * a.L;
}

// Whether the lane may be killed against the next one (lane + 1, whose
// group key is nxt_grp): that lane exists, is in this warp (warp_lane is
// the lane's place in it) and is in the same group.
BM_HD bool kill_pair(bool in, int lane, int P, int warp_lane, int32_t grp,
                     int32_t nxt_grp) {
  return in && lane + 1 < P && warp_lane != 31 && nxt_grp == grp;
}

// Whether a lane stops after a trip: it could not step (ok false), or it
// reached the state (nqb, nkk, nss) the next lane of its group holds after
// the same trip (kill: kill_pair).
template <typename T>
BM_HD bool lane_done(bool ok, bool kill, int32_t qb, T kk, T ss,
                     int32_t nqb, T nkk, T nss) {
  return !ok || (kill && nqb == qb && nkk == kk && nss == ss);
}

#ifdef __CUDACC__
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seed_backward_kernel(fmi::FMPtrs p, BackArgs<T> a) {
  __shared__ FMConst c;
  fmi::load_const(c, p);
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool in = lane < a.P;
  int32_t qb = 0, grp = -1;
  T kk = 0, ss = 0, fl = 1;
  const int32_t* rd = a.reads;
  if (in) load_lane<T>(a, lane, qb, kk, ss, fl, grp, rd);
  const int32_t nxt_grp = __shfl_down_sync(kFull, grp, 1);
  const bool kill =
      kill_pair(in, lane, a.P, threadIdx.x & 31, grp, nxt_grp);
  bool done = !in;
  for (int it = 0; it < a.L; ++it) {
    if (!__any_sync(kFull, !done)) break;
    const bool ok = !done && back_step<T>(c, p.occ, rd, fl, qb, kk, ss);
    const int32_t nqb = __shfl_down_sync(kFull, qb, 1);
    const T nkk = __shfl_down_sync(kFull, kk, 1);
    const T nss = __shfl_down_sync(kFull, ss, 1);
    done = lane_done<T>(ok, kill, qb, kk, ss, nqb, nkk, nss);
  }
  if (in) {
    a.qb_out[lane] = qb;
    a.k_out[lane] = kk;
    a.s_out[lane] = ss;
  }
}
#endif

}  // namespace seedbw

#ifdef __CUDACC__
extern "C" {

// Backward walks of P lanes (floor and group may be null). wide: int64
// k, s, floor and outputs, else int32. Returns a cudaError_t code.
int bm_seed_backward(const fmi::FMPtrs* fm, const void* reads, int B,
                     int L, const void* rid, const void* qbeg, const void* k,
                     const void* s, const void* floor, const void* group,
                     int P, int wide, void* qb_out, void* k_out, void* s_out,
                     void* stream) {
  if (P <= 0) return 0;
  if (B <= 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (P + seedbw::kThreads - 1) / seedbw::kThreads;
  auto go = [&](auto* kp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(kp)>>;
    seedbw::BackArgs<T> a{static_cast<const int32_t*>(reads),
                          static_cast<const int32_t*>(rid),
                          static_cast<const int32_t*>(qbeg), kp,
                          static_cast<const T*>(s),
                          static_cast<const T*>(floor),
                          static_cast<const int32_t*>(group), B, L, P,
                          static_cast<int32_t*>(qb_out),
                          static_cast<T*>(k_out), static_cast<T*>(s_out)};
    seedbw::seed_backward_kernel<T>
        <<<grid, seedbw::kThreads, 0, st>>>(*fm, a);
    return static_cast<int>(cudaGetLastError());
  };
  if (wide) return go(static_cast<const int64_t*>(k));
  return go(static_cast<const int32_t*>(k));
}

const char* bm_seed_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
