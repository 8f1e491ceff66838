// Forward FM walks of SMEM seeding, for Hopper (sm_90a): the round-1
// forward walk of each read (seed_forward, with the round-3 LAST-like
// automaton fused into it) and the round-2 split re-seed walks
// (seed_reseed_forward).
//
// Replaces the XLA-compiled loops of bwamem_tpu/ops/seeding.py
// (smem_seed_batch): _forward_pass2 (:176) on occ2 indexes, _forward_pass
// (:111) and _seed_strategy_pass (:796) without them, and _reseed_forward
// (:842). No pl.pallas_call stands behind them: the JAX package seeds with
// XLA ops (lax.scan and lax.while_loop under jax.jit). The contract is the
// port's plain versions in bwamem_tpu_torch/ops/seeding.py, bit for bit on
// every entry the walk emits:
//   * seed_forward: per read the (seg, k, s, emit) planes (B, NP) of
//     _forward_pass2 (NP = 2 * ((L + 2) / 2), two bases a trip) or of
//     _forward_pass (NP = L + 1, one base a trip), and with a strategy the
//     (x, k, s, emit) planes (B, L) of the round-3 automaton. emit is
//     written everywhere; seg/x, k and s only where emit is set (nothing
//     reads the rest).
//   * seed_reseed_forward: per lane the (kb, sb, eb, filled) planes
//     (R, L + 2) of _reseed_forward: entry j holds the emission of
//     relative offset j. `filled` must be zero on entry (the wrapper
//     allocates it with zeros); kb, sb and eb are written where filled.
//
// What bounds it on this card: each trip is a chain of dependent table
// reads, one occ2 row of 128 B at each of the interval's two ends (two
// 32 B occ rows a base without occ2), so a walk is bound by the latency
// of those reads, not by bandwidth: at phase 4's shape (16384 reads, 81
// trips) the rows read are about 0.34 GB, 0.1 ms at 3.35 TB/s, and the
// 4.6 Mbp world's occ2 table (~9 MB) sits in the 50 MB L2.
//
// Layout (GPUSeed's find_seed_intervals_fow, one thread per read): the
// walk state (k, l, s, seg) and the round-3 state stay in registers for
// the whole read, the small tables (L2, the 2-mer table) sit in shared
// memory, and each trip writes its plane columns. Many walks in flight
// (a thread each, 128 a block) hide the row latency. The round-2 lanes
// are one thread each too, and a lane stops at its death: after it the
// torch version only writes zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/kernels/build.py)
#include <stdint.h>

#include <type_traits>

#include "fm_index.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace seedfw {

using fmi::FMConst;

template <typename T>
struct FwdArgs {
  const int32_t* reads;  // (B, L) codes, 4 = N or pad
  const int32_t* lens;   // (B,)
  int B, L, NP;
  int min_seed_len;
  bool strategy;         // round 3 fused in
  int min_len3;
  int64_t max_intv3;
  int32_t* seg;          // (B, NP)
  T* k;
  T* s;
  uint8_t* emit;
  int32_t* x3;           // (B, L), with a strategy
  T* k3;
  T* s3;
  uint8_t* e3;
};

template <typename T>
BM_HD void put(const FwdArgs<T>& a, int64_t o, bool e, int32_t seg, T k,
               T s) {
  a.emit[o] = e;
  if (e) {
    a.seg[o] = seg;
    a.k[o] = k;
    a.s[o] = s;
  }
}

template <typename T>
BM_HD void put3(const FwdArgs<T>& a, int64_t o, bool e, int32_t x, T k,
                T s) {
  a.e3[o] = e;
  if (e) {
    a.x3[o] = x;
    a.k3[o] = k;
    a.s3[o] = s;
  }
}

template <typename T>
BM_HD T pick(bool c1, T a, bool c2, T b) {
  return c1 ? a : (c2 ? b : static_cast<T>(0));
}

// _forward_pass2 of read b (with _forward_pass2's strategy trips when
// a.strategy): two bases a trip from one occ2 gather at each end.
template <typename T>
BM_HD void walk_pairs(const FMConst& c, const int32_t* occ2,
                      const FwdArgs<T>& a, int b) {
  const int32_t* rd = a.reads + static_cast<int64_t>(b) * a.L;
  const int len = a.lens[b];
  const int64_t o = static_cast<int64_t>(b) * a.NP;
  const int64_t o3 = static_cast<int64_t>(b) * a.L;
  T k = 0, l = 0, s = 0, k3 = 0, l3 = 0, s3 = 0;
  int32_t seg = 0, x3 = 0;
  for (int i = 0; i < a.NP; i += 2) {
    const int b1 = i < a.L ? rd[i] : 4;
    const int b2 = i + 1 < a.L ? rd[i + 1] : 4;
    const bool v1 = i < len && b1 < 4;
    const bool v2 = i + 1 < len && b2 < 4;
    const bool active = s > 0;
    T k1, l1, s1, k2, l2, s2;
    fmi::forward_ext2(c, occ2, k, l, s, b1, b2, k1, l1, s1, k2, l2, s2);
    T ik1, il1, is1, ik2, il2, is2, pk, pl, ps;
    fmi::init1(c, b1, ik1, il1, is1);
    fmi::init1(c, b2, ik2, il2, is2);
    fmi::init2(c, b1, b2, pk, pl, ps);

    // sub-step A (position i)
    const T s1v = v1 ? s1 : static_cast<T>(0);
    put(a, o + i, active && s1v != s && i >= a.min_seed_len, seg, k, s);
    const bool ext1 = v1 && active && s1 > 0;
    const bool rs1 = v1 && !ext1;
    const T kA = pick(ext1, k1, rs1, ik1);
    const T sA = pick(ext1, s1, rs1, is1);
    const int32_t segA = ext1 ? seg : i;

    // sub-step B (position i + 1): the pair path, the 2-mer table or dead
    const T sB = pick(ext1, s2, rs1, ps);
    const T kB = pick(ext1, k2, rs1, pk);
    const T lB = pick(ext1, l2, rs1, pl);
    const bool activeB = sA > 0;
    const T sBv = v2 ? sB : static_cast<T>(0);
    put(a, o + i + 1, activeB && sBv != sA && i + 1 >= a.min_seed_len, segA,
        kA, sA);
    const bool ext2 = v2 && activeB && sB > 0;
    const bool rs2 = v2 && !ext2;
    k = pick(ext2, kB, rs2, ik2);
    l = pick(ext2, lB, rs2, il2);
    s = pick(ext2, sB, rs2, is2);
    seg = ext2 ? segA : i + 1;
    if (!a.strategy) continue;

    // the round-3 automaton, both sub-steps
    T k31, l31, s31, k32, l32, s32;
    fmi::forward_ext2(c, occ2, k3, l3, s3, b1, b2, k31, l31, s31, k32, l32,
                      s32);
    const bool walkA = v1 && x3 < i;
    const bool e3A = walkA && static_cast<int64_t>(s31) < a.max_intv3 &&
                     i - x3 >= a.min_len3;
    if (i < a.L) put3(a, o3 + i, e3A, x3, k31, s31);
    const bool startA = v1 && x3 == i;
    const bool contA = walkA && !e3A;
    const int32_t x3A = (!v1 || e3A) ? i + 1 : x3;
    const T k3B = pick(contA, k32, startA, pk);
    const T l3B = pick(contA, l32, startA, pl);
    const T s3B = pick(contA, s32, startA, ps);
    const bool walkB = v2 && x3A < i + 1;
    const bool e3B = walkB && static_cast<int64_t>(s3B) < a.max_intv3 &&
                     i + 1 - x3A >= a.min_len3;
    if (i + 1 < a.L) put3(a, o3 + i + 1, e3B, x3A, k3B, s3B);
    const bool startB = v2 && x3A == i + 1;
    const bool contB = walkB && !e3B;
    k3 = pick(contB, k3B, startB, ik2);
    l3 = pick(contB, l3B, startB, il2);
    s3 = pick(contB, s3B, startB, is2);
    x3 = (!v2 || e3B) ? i + 2 : x3A;
  }
}

// _forward_pass of read b (emit mode "shrink"), with _seed_strategy_pass
// in the same trips when a.strategy: one base a trip.
template <typename T>
BM_HD void walk_single(const FMConst& c, const int32_t* occ,
                       const FwdArgs<T>& a, int b) {
  const int32_t* rd = a.reads + static_cast<int64_t>(b) * a.L;
  const int len = a.lens[b];
  const int64_t o = static_cast<int64_t>(b) * a.NP;
  const int64_t o3 = static_cast<int64_t>(b) * a.L;
  T k = 0, l = 0, s = 0, k3 = 0, l3 = 0, s3 = 0;
  int32_t seg = 0, x3 = 0;
  for (int i = 0; i <= a.L; ++i) {
    const int base = i < a.L ? rd[i] : 4;
    const bool valid = i < len && base < 4;
    const bool active = s > 0;
    T nk, nl, ns;
    fmi::forward_ext1(c, occ, k, l, s, base, nk, nl, ns);
    const T oks = valid ? ns : static_cast<T>(0);
    put(a, o + i, active && oks != s && i >= a.min_seed_len, seg, k, s);
    const bool ext = valid && active && oks > 0;
    const bool rs = valid && !ext;
    T ik, il, is;
    fmi::init1(c, base, ik, il, is);
    k = pick(ext, nk, rs, ik);
    l = pick(ext, nl, rs, il);
    s = pick(ext, oks, rs, is);
    seg = ext ? seg : i;
    if (!a.strategy || i >= a.L) continue;

    const bool walking = valid && x3 < i;
    T kn, ln, sn;
    fmi::forward_ext1(c, occ, k3, l3, s3, base, kn, ln, sn);
    const bool e3 = walking && static_cast<int64_t>(sn) < a.max_intv3 &&
                    i - x3 >= a.min_len3;
    put3(a, o3 + i, e3, x3, kn, sn);
    const bool start = valid && x3 == i;
    const bool cont = walking && !e3;
    k3 = pick(cont, kn, start, ik);
    l3 = pick(cont, ln, start, il);
    s3 = pick(cont, sn, start, is);
    x3 = (!valid || e3) ? i + 1 : x3;
  }
}

template <typename T>
struct ReseedArgs {
  const int32_t* reads;  // (B, L)
  const int32_t* lens;   // (B,)
  const int32_t* lrid;   // (R,) read of each lane
  const int32_t* lx;     // (R,) start position
  const T* lfloor;       // (R,) min interval size to go on
  int B, L, R;
  int min_seed_len;
  T* kb;                 // (R, L + 2)
  T* sb;
  int32_t* eb;
  uint8_t* fill;         // zero on entry
};

// _reseed_forward of lane r: the walk from lx with the lane's floor, two
// bases a trip on occ2 indexes (freeze-on-death within the pair does not
// matter here: the lane stops at its death, after which the torch version
// emits nothing).
template <typename T>
BM_HD void walk_reseed(const FMConst& c, const int32_t* occ,
                       const int32_t* occ2, bool pairs,
                       const ReseedArgs<T>& a, int r) {
  const int64_t rid = a.lrid[r];
  const int lx = a.lx[r];
  const T fl = a.lfloor[r];
  const int len = a.lens[rid];
  const int64_t last = static_cast<int64_t>(a.B) * a.L - 1;
  const int64_t row = rid * a.L;
  auto at = [&](int64_t i) {
    const int64_t x = row + i;
    return a.reads[x < 0 ? 0 : (x > last ? last : x)];
  };
  auto fetch = [&](int i) { return i < len ? at(i) : 4; };
  const int64_t o = static_cast<int64_t>(r) * (a.L + 2);
  auto push = [&](int j, bool e, T kv, T sv, int ev) {
    if (!e) return;
    a.kb[o + j] = kv;
    a.sb[o + j] = sv;
    a.eb[o + j] = ev;
    a.fill[o + j] = 1;
  };
  const int b0 = at(lx);
  T k, l, s;
  fmi::init1(c, b0, k, l, s);
  bool alive = b0 < 4 && lx < len;
  for (int j = 1; j <= a.L && alive; j += pairs ? 2 : 1) {
    if (pairs) {
      const int i1 = lx + j, i2 = i1 + 1;
      const int b1 = fetch(i1), b2 = fetch(i2);
      const bool v1 = i1 < len && b1 < 4;
      const bool v2 = i2 < len && b2 < 4;
      T k1, l1, s1, k2, l2, s2;
      fmi::forward_ext2(c, occ2, k, l, s, b1, b2, k1, l1, s1, k2, l2, s2);
      const T s1n = v1 ? s1 : static_cast<T>(0);
      push(j, s1n != s && i1 >= a.min_seed_len, k, s, i1);
      const bool alive1 = v1 && s1n >= fl;
      const T s2n = (v2 && alive1) ? s2 : static_cast<T>(0);
      push(j + 1, alive1 && s2n != s1n && i2 >= a.min_seed_len, k1, s1n,
           i2);
      const bool alive2 = alive1 && v2 && s2n >= fl;
      if (alive2) {
        k = k2;
        l = l2;
        s = s2n;
      } else if (alive1) {
        k = k1;
        l = l1;
        s = s1n;
      }
      alive = alive2;
    } else {
      const int i = lx + j;
      const int b = fetch(i);
      const bool vb = i < len && b < 4;
      T kn, ln, sn;
      fmi::forward_ext1(c, occ, k, l, s, b, kn, ln, sn);
      const T snv = vb ? sn : static_cast<T>(0);
      push(j, snv != s && i >= a.min_seed_len, k, s, i);
      alive = vb && snv >= fl;
      if (alive) {
        k = kn;
        l = ln;
        s = snv;
      }
    }
  }
}

#ifdef __CUDACC__
constexpr int kThreads = 128;

template <typename T, bool kPairs>
__global__ void __launch_bounds__(kThreads)
    seed_forward_kernel(fmi::FMPtrs p, FwdArgs<T> a) {
  __shared__ FMConst c;
  fmi::load_const(c, p);
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.B) return;
  if (kPairs)
    walk_pairs<T>(c, p.occ2, a, b);
  else
    walk_single<T>(c, p.occ, a, b);
}

template <typename T, bool kPairs>
__global__ void __launch_bounds__(kThreads)
    seed_reseed_kernel(fmi::FMPtrs p, ReseedArgs<T> a) {
  __shared__ FMConst c;
  fmi::load_const(c, p);
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.R) return;
  walk_reseed<T>(c, p.occ, p.occ2, kPairs, a, r);
}

template <typename T>
int launch_forward(const fmi::FMPtrs& p, const FwdArgs<T>& a, bool pairs,
                   cudaStream_t st) {
  const int grid = (a.B + kThreads - 1) / kThreads;
  if (pairs)
    seed_forward_kernel<T, true><<<grid, kThreads, 0, st>>>(p, a);
  else
    seed_forward_kernel<T, false><<<grid, kThreads, 0, st>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reseed(const fmi::FMPtrs& p, const ReseedArgs<T>& a, bool pairs,
                  cudaStream_t st) {
  const int grid = (a.R + kThreads - 1) / kThreads;
  if (pairs)
    seed_reseed_kernel<T, true><<<grid, kThreads, 0, st>>>(p, a);
  else
    seed_reseed_kernel<T, false><<<grid, kThreads, 0, st>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace seedfw

#ifdef __CUDACC__
extern "C" {

// Round-1 forward walks of B reads of L columns into planes of NP columns
// (pairs: the occ2 walk, NP = 2 * ((L + 2) / 2); else NP = L + 1); with
// `strategy`, the round-3 planes (B, L) too. wide: int64 positions (k, s,
// k3, s3), else int32. Returns a cudaError_t code.
int bm_seed_forward(const fmi::FMPtrs* fm, const void* reads,
                    const void* lens, int B, int L, int NP, int wide,
                    int pairs, int min_seed_len, int strategy, int min_len3,
                    long long max_intv3, void* seg, void* k, void* s,
                    void* emit, void* x3, void* k3, void* s3, void* e3,
                    void* stream) {
  if (B <= 0) return 0;
  if (L < 0 || NP != (pairs ? 2 * ((L + 2) / 2) : L + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto* kp, auto* sp, auto* k3p, auto* s3p) {
    using T = std::remove_pointer_t<decltype(kp)>;
    seedfw::FwdArgs<T> a{static_cast<const int32_t*>(reads),
                         static_cast<const int32_t*>(lens), B, L, NP,
                         min_seed_len, strategy != 0, min_len3, max_intv3,
                         static_cast<int32_t*>(seg), kp, sp,
                         static_cast<uint8_t*>(emit),
                         static_cast<int32_t*>(x3), k3p, s3p,
                         static_cast<uint8_t*>(e3)};
    return seedfw::launch_forward<T>(*fm, a, pairs != 0, st);
  };
  if (wide)
    return fill(static_cast<int64_t*>(k), static_cast<int64_t*>(s),
                static_cast<int64_t*>(k3), static_cast<int64_t*>(s3));
  return fill(static_cast<int32_t*>(k), static_cast<int32_t*>(s),
              static_cast<int32_t*>(k3), static_cast<int32_t*>(s3));
}

// Round-2 re-seed walks of R lanes into (R, L + 2) planes; `fill` must be
// zero on entry. Returns a cudaError_t code.
int bm_seed_reseed_forward(const fmi::FMPtrs* fm, const void* reads,
                           const void* lens, int B, int L, const void* lrid,
                           const void* lx, const void* lfloor, int R,
                           int wide, int pairs, int min_seed_len, void* kb,
                           void* sb, void* eb, void* fill, void* stream) {
  if (R <= 0) return 0;
  if (B <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto* flp, auto* kp, auto* sp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(flp)>>;
    seedfw::ReseedArgs<T> a{static_cast<const int32_t*>(reads),
                            static_cast<const int32_t*>(lens),
                            static_cast<const int32_t*>(lrid),
                            static_cast<const int32_t*>(lx), flp, B, L, R,
                            min_seed_len, kp, sp,
                            static_cast<int32_t*>(eb),
                            static_cast<uint8_t*>(fill)};
    return seedfw::launch_reseed<T>(*fm, a, pairs != 0, st);
  };
  if (wide)
    return go(static_cast<const int64_t*>(lfloor), static_cast<int64_t*>(kb),
              static_cast<int64_t*>(sb));
  return go(static_cast<const int32_t*>(lfloor), static_cast<int32_t*>(kb),
            static_cast<int32_t*>(sb));
}

const char* bm_seed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
