// Forward FM walks of SMEM seeding, for Hopper (sm_90a): the round-1
// forward walk of each read (seed_forward, with the round-3 LAST-like
// automaton as a second walk of the same read) and the round-2 split
// re-seed walks (seed_reseed_forward).
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
//     relative offset j. filled is written everywhere, kb, sb and eb only
//     where it is set.
//
// What bounds S1 on this card: each trip is a chain of dependent table
// reads, one occ2 row of 128 B at each of the interval's two ends (one 32 B
// occ row a base without occ2), and the row queries' popcounts. The table
// (~9 MB on the 4.6 Mbp world) sits in the 50 MB L2, so bytes do not bound
// it: the latency of the chain does, unless enough walks are in flight to
// hide it, and then the instructions do (~350 a lane a trip at G = 2).
//
// Layout of S1 (the lane-group form of csrc/fm_index.cuh): a walk is a
// group of 2G lanes, the interval's two ends on the group's two halves,
// each end's row query split over G lanes (a 128 B occ2 row: each lane
// reads 16/G of its 16 count words and, where they lie before the row
// offset, 16/G of its 16 data words, and counts its data words' matches
// on bit planes, four words a transpose; a 32 B occ row: G = 2, two count
// and two BWT words a lane), summed by a __shfl_xor_sync reduce and
// swapped between the halves, so every lane of the group holds the step's
// result and the walk's state. G is fmi::kPairLanes (2): 2 lanes a row ran
// fastest over the main path's shapes taken together (1 lane about as
// fast at 16384 reads, 1.4x slower at 1 kb; 8 lanes 2-2.6x slower at
// 16384 reads; PERF.md §6). Round 3 is a walk of its own on other warps
// (a warp runs one automaton, so its lanes never diverge on it); the grid has one one-warp
// block per 32 / 2G walks, so 512, 4096 and 16384 reads all spread over
// the 132 SMs. A group prefetches 2G trips' bases (a lane each, then a
// shuffle a trip), and each trip's plane columns stay in the registers of
// one lane of the group until 2G trips are done; then the group writes
// them as one contiguous run of the read's row. A warp runs its longest walk's trips to the first trip past
// its read's end (after it a walk emits nothing) and zero-fills the rest
// of each emit row.
//
// S3 (seed_reseed_forward) has S1's chain, but few walks: a phase-4 chunk
// holds some 10^4 re-seed lanes, and each dies once its interval falls
// below its floor, so the latency of the chain bounds it. Its layout is
// S1's: each re-seed lane is a walk on 2G lanes (G = fmi::kPairLanes on
// occ2, a lane pair an occ row without), 32 / 2G walks a one-warp block;
// the bases of 2G trips are prefetched a lane each; each trip's two plane
// columns stay in one lane of the group and leave as a run of 2G trips. A
// dead walk reads no row, and the warp stops at the trip where its last
// walk dies. The warp's fill rows are one contiguous block, which it
// zeroes with 8-byte stores before it walks (a group zeroing its own row
// past its last trip, a byte a lane, writes 4 scattered bytes a row a
// store: S3 at 1 kb took 0.216 ms that way on an H100, 0.081 with the
// block stores; PERF.md).
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
  bool strategy;         // round 3 as well
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

// One plane column: emit, and seg (x for round 3), k and s.
template <typename T>
struct Col {
  bool e;
  int32_t v;
  T k, s;
};

// A walk's automaton state: the interval (k, l, s) and seg (round 1) or
// x (round 3).
template <typename T>
struct Walk {
  T k, l, s;
  int32_t v;
};

template <typename T>
BM_HD T pick(bool c1, T a, bool c2, T b) {
  return c1 ? a : (c2 ? b : static_cast<T>(0));
}

// Trips a walk of a read of `len` bases runs (pairs: two bases a trip): to
// the first trip that starts past the read's last base; after it the walk
// is dead and emits nothing (its interval is 0 and no base is valid).
BM_HD int walk_trips(int len, int L, bool pairs) {
  const int n = len < 0 ? 0 : (len > L ? L : len);
  const int np = pairs ? (L + 2) / 2 : L + 1;
  const int t = pairs ? n / 2 + 2 : n + 1;
  return t < np ? t : np;
}

// One trip of _forward_pass2's round-1 automaton at positions i and i + 1
// (bases b1, b2, valid v1, v2), from the pair step of its interval
// (forward_ext2: k1.. after b1, k2.. after both): the columns of both
// positions, and the state after the trip.
template <typename T>
BM_HD void r1_pair_trip(const FMConst& c, int msl, int i, int b1, int b2,
                        bool v1, bool v2, T k1, T l1, T s1, T k2, T l2,
                        T s2, Walk<T>& w, Col<T>& eA, Col<T>& eB) {
  T ik1, il1, is1, ik2, il2, is2, pk, pl, ps;
  fmi::init1(c, b1, ik1, il1, is1);
  fmi::init1(c, b2, ik2, il2, is2);
  fmi::init2(c, b1, b2, pk, pl, ps);
  // sub-step A (position i)
  const bool active = w.s > 0;
  const T s1v = v1 ? s1 : static_cast<T>(0);
  eA = {active && s1v != w.s && i >= msl, w.v, w.k, w.s};
  const bool ext1 = v1 && active && s1 > 0;
  const bool rs1 = v1 && !ext1;
  const T kA = pick(ext1, k1, rs1, ik1);
  const T sA = pick(ext1, s1, rs1, is1);
  const int32_t segA = ext1 ? w.v : i;
  // sub-step B (position i + 1): the pair path, the 2-mer table or dead
  const T sB = pick(ext1, s2, rs1, ps);
  const T kB = pick(ext1, k2, rs1, pk);
  const T lB = pick(ext1, l2, rs1, pl);
  const bool activeB = sA > 0;
  const T sBv = v2 ? sB : static_cast<T>(0);
  eB = {activeB && sBv != sA && i + 1 >= msl, segA, kA, sA};
  const bool ext2 = v2 && activeB && sB > 0;
  const bool rs2 = v2 && !ext2;
  w.k = pick(ext2, kB, rs2, ik2);
  w.l = pick(ext2, lB, rs2, il2);
  w.s = pick(ext2, sB, rs2, is2);
  w.v = ext2 ? segA : i + 1;
}

// One trip of _forward_pass2's round-3 automaton (strategy (min_len3,
// max_intv3)), as r1_pair_trip; its columns lie in planes of width L.
template <typename T>
BM_HD void r3_pair_trip(const FMConst& c, int min_len3, int64_t max_intv3,
                        int i, int b1, int b2, bool v1, bool v2, T k31,
                        T l31, T s31, T k32, T l32, T s32, Walk<T>& w,
                        Col<T>& eA, Col<T>& eB) {
  (void)l31;
  T ik2, il2, is2, pk, pl, ps;
  fmi::init1(c, b2, ik2, il2, is2);
  fmi::init2(c, b1, b2, pk, pl, ps);
  const bool walkA = v1 && w.v < i;
  const bool e3A = walkA && static_cast<int64_t>(s31) < max_intv3 &&
                   i - w.v >= min_len3;
  eA = {e3A, w.v, k31, s31};
  const bool startA = v1 && w.v == i;
  const bool contA = walkA && !e3A;
  const int32_t x3A = (!v1 || e3A) ? i + 1 : w.v;
  const T k3B = pick(contA, k32, startA, pk);
  const T l3B = pick(contA, l32, startA, pl);
  const T s3B = pick(contA, s32, startA, ps);
  const bool walkB = v2 && x3A < i + 1;
  const bool e3B = walkB && static_cast<int64_t>(s3B) < max_intv3 &&
                   i + 1 - x3A >= min_len3;
  eB = {e3B, x3A, k3B, s3B};
  const bool startB = v2 && x3A == i + 1;
  const bool contB = walkB && !e3B;
  w.k = pick(contB, k3B, startB, ik2);
  w.l = pick(contB, l3B, startB, il2);
  w.s = pick(contB, s3B, startB, is2);
  w.v = (!v2 || e3B) ? i + 2 : x3A;
}

// One trip of _forward_pass's round-1 automaton (emit mode "shrink") at
// position i, from the forward step (nk, nl, ns) of its interval by base.
template <typename T>
BM_HD void r1_single_trip(const FMConst& c, int msl, int i, int base,
                          bool valid, T nk, T nl, T ns, Walk<T>& w,
                          Col<T>& e) {
  const bool active = w.s > 0;
  const T oks = valid ? ns : static_cast<T>(0);
  e = {active && oks != w.s && i >= msl, w.v, w.k, w.s};
  const bool ext = valid && active && oks > 0;
  const bool rs = valid && !ext;
  T ik, il, is;
  fmi::init1(c, base, ik, il, is);
  w.k = pick(ext, nk, rs, ik);
  w.l = pick(ext, nl, rs, il);
  w.s = pick(ext, oks, rs, is);
  w.v = ext ? w.v : i;
}

// One trip of _seed_strategy_pass's automaton at position i (< L).
template <typename T>
BM_HD void r3_single_trip(const FMConst& c, int min_len3, int64_t max_intv3,
                          int i, int base, bool valid, T kn, T ln, T sn,
                          Walk<T>& w, Col<T>& e) {
  const bool walking = valid && w.v < i;
  const bool e3 = walking && static_cast<int64_t>(sn) < max_intv3 &&
                  i - w.v >= min_len3;
  e = {e3, w.v, kn, sn};
  const bool start = valid && w.v == i;
  const bool cont = walking && !e3;
  T ik, il, is;
  fmi::init1(c, base, ik, il, is);
  w.k = pick(cont, kn, start, ik);
  w.l = pick(cont, ln, start, il);
  w.s = pick(cont, sn, start, is);
  w.v = (!valid || e3) ? i + 1 : w.v;
}

// Plane column i of a read's row (round 1: its (seg, k, s, emit) planes at
// offset o = row NP; round 3: its (x, k, s, emit) planes at o = row L).
template <typename T>
BM_HD void put_col(const FwdArgs<T>& a, bool r3, int64_t o, const Col<T>& e) {
  (r3 ? a.e3 : a.emit)[o] = e.e;
  if (e.e) {
    (r3 ? a.x3 : a.seg)[o] = e.v;
    (r3 ? a.k3 : a.k)[o] = e.k;
    (r3 ? a.s3 : a.s)[o] = e.s;
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
  uint8_t* fill;
};

// A re-seed walk: its lane's read (its row in reads, its length), start
// lx and floor, and the state of _reseed_forward's walk, the interval
// (k, l, s) and whether it walks on.
template <typename T>
struct ReseedWalk {
  int64_t row;
  int len, lx;
  T fl;
  T k, l, s;
  bool alive;
};

// The code at position i of the walk's read as _reseed_forward reads it:
// its flat index clamped into the reads (the start base b0), and past the
// read's end 4 (a trip's bases, fetch).
template <typename T>
BM_HD int reseed_at(const ReseedArgs<T>& a, const ReseedWalk<T>& w,
                    int64_t i) {
  const int64_t last = static_cast<int64_t>(a.B) * a.L - 1;
  const int64_t x = w.row + i;
  return a.reads[x < 0 ? 0 : (x > last ? last : x)];
}

template <typename T>
BM_HD int reseed_base(const ReseedArgs<T>& a, const ReseedWalk<T>& w,
                      int64_t i) {
  return i < w.len ? reseed_at(a, w, i) : 4;
}

// Lane r's walk at its start: the 1-base interval of b0 at lx, alive
// where b0 is a base and lx lies inside the read.
template <typename T>
BM_HD ReseedWalk<T> reseed_start(const FMConst& c, const ReseedArgs<T>& a,
                                 int r) {
  ReseedWalk<T> w;
  const int64_t rid = a.lrid[r];
  w.row = rid * a.L;
  w.len = a.lens[rid];
  w.lx = a.lx[r];
  w.fl = a.lfloor[r];
  const int b0 = reseed_at(a, w, w.lx);
  fmi::init1(c, b0, w.k, w.l, w.s);
  w.alive = b0 < 4 && w.lx < w.len;
  return w;
}

// Trips of a re-seed walk over reads of L columns: two bases a trip on
// occ2 indexes (columns j = 2t + 1 and j + 1 of trip t), one without
// (column t + 1); at most to column L + 1.
BM_HD int reseed_trips(int L, bool pairs) { return pairs ? (L + 1) / 2 : L; }
BM_HD int reseed_col(int t, bool pairs) { return pairs ? 2 * t + 1 : t + 1; }

// One pair trip of _reseed_forward at positions i1 = lx + j and i1 + 1
// (valid v1, v2), from the pair step of the walk's interval (k1.. after
// the first base, k2.. after both): the emissions of columns j and j + 1
// (end position, k and s before the base) and the state after the trip.
// It freezes where the walk dies: at the first base on the state before
// the trip, at the second on the one after the first base.
template <typename T>
BM_HD void reseed_pair_trip(int msl, int i1, bool v1, bool v2, T k1, T l1,
                            T s1, T k2, T l2, T s2, ReseedWalk<T>& w,
                            Col<T>& eA, Col<T>& eB) {
  const T zero = 0;
  const T s1n = v1 && w.alive ? s1 : zero;
  eA = {w.alive && s1n != w.s && i1 >= msl, i1, w.k, w.s};
  const bool alive1 = w.alive && v1 && s1n >= w.fl;
  const T s2n = v2 && alive1 ? s2 : zero;
  eB = {alive1 && s2n != s1n && i1 + 1 >= msl, i1 + 1, k1, s1n};
  const bool alive2 = alive1 && v2 && s2n >= w.fl;
  if (alive2) {
    w.k = k2;
    w.l = l2;
    w.s = s2n;
  } else if (alive1) {
    w.k = k1;
    w.l = l1;
    w.s = s1n;
  }
  w.alive = alive2;
}

// One single-base trip of _reseed_forward at position i (valid), from
// the forward step (nk, nl, ns) of the walk's interval by its base.
template <typename T>
BM_HD void reseed_single_trip(int msl, int i, bool valid, T nk, T nl, T ns,
                              ReseedWalk<T>& w, Col<T>& e) {
  const T snv = valid && w.alive ? ns : static_cast<T>(0);
  e = {w.alive && snv != w.s && i >= msl, i, w.k, w.s};
  const bool alive2 = w.alive && valid && snv >= w.fl;
  if (alive2) {
    w.k = nk;
    w.l = nl;
    w.s = snv;
  }
  w.alive = alive2;
}

// Plane entry o of the re-seed planes: filled, and kb, sb, eb where set.
template <typename T>
BM_HD void put_reseed(const ReseedArgs<T>& a, int64_t o, const Col<T>& e) {
  a.fill[o] = e.e;
  if (e.e) {
    a.kb[o] = e.k;
    a.sb[o] = e.s;
    a.eb[o] = e.v;
  }
}

#ifdef __CUDACC__
// S1's and S3's blocks: one warp, so that even a launch of few walks (a
// fastmap call of 512 reads: 128 warps) spreads over the SMs
constexpr int kWalkThreads = 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename U>
__device__ __forceinline__ fmi::Occ2Sums<U> shfl_xor(fmi::Occ2Sums<U> v,
                                                      int m) {
  return {__shfl_xor_sync(kFull, v.rc, m), __shfl_xor_sync(kFull, v.rs, m),
          __shfl_xor_sync(kFull, v.pc, m), __shfl_xor_sync(kFull, v.ps, m)};
}

template <typename U>
__device__ __forceinline__ fmi::OccSums<U> shfl_xor(fmi::OccSums<U> v,
                                                     int m) {
  return {__shfl_xor_sync(kFull, v.eq, m), __shfl_xor_sync(kFull, v.gt, m)};
}

// The walks of one warp: `per` walks of W = 32 / per lanes each; warps
// below nw1 walk round 1, the rest round 3 (of the same reads).
struct WarpWalk {
  int lane, q, b, width;
  bool in, r3;
  int64_t o;  // the read's row in its planes
};

template <typename T>
__device__ __forceinline__ bool warp_walk(const FwdArgs<T>& a, int nw1,
                                          int nwarps, int W, WarpWalk& ww) {
  const int warp = blockIdx.x * (kWalkThreads / 32) + threadIdx.x / 32;
  if (warp >= nwarps) return false;
  ww.lane = threadIdx.x & 31;
  ww.q = ww.lane % W;
  ww.r3 = warp >= nw1;
  ww.b = (ww.r3 ? warp - nw1 : warp) * (32 / W) + ww.lane / W;
  ww.in = ww.b < a.B;
  ww.width = ww.r3 ? a.L : a.NP;
  ww.o = static_cast<int64_t>(ww.in ? ww.b : 0) * ww.width;
  return true;
}

// The occ2 pair walk (_forward_pass2's trips), G lanes an end.
template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
    seed_pairs_kernel(fmi::FMPtrs p, FwdArgs<T> a, int nw1, int nwarps) {
  constexpr int G = fmi::kPairLanes, W = 2 * G, NW = 16 / G;
  using U = fmi::Acc<T>;
  __shared__ FMConst c;
  __shared__ uint32_t masks[33];
  for (int t = threadIdx.x; t <= 32; t += kWalkThreads)
    masks[t] = fmi::plane_mask(t);
  fmi::load_const(c, p);
  WarpWalk ww;
  if (!warp_walk(a, nw1, nwarps, W, ww)) return;
  const int end = ww.q / G, ql = ww.q % G;
  const int len = ww.in ? a.lens[ww.b] : 0;
  const int trips = __reduce_max_sync(kFull, walk_trips(len, a.L, true));
  const int32_t* rd = a.reads + static_cast<int64_t>(ww.in ? ww.b : 0) * a.L;
  Walk<T> w{0, 0, 0, 0};
  Col<T> keepA{}, keepB{};
  for (int t0 = 0; t0 < trips; t0 += W) {
    const int ip = 2 * (t0 + ww.q);
    const int bp1 = ww.in && ip < a.L ? rd[ip] : 4;
    const int bp2 = ww.in && ip + 1 < a.L ? rd[ip + 1] : 4;
    const int nt = trips - t0 < W ? trips - t0 : W;
    for (int u = 0; u < nt; ++u) {
      const int i = 2 * (t0 + u);
      const int b1 = __shfl_sync(kFull, bp1, u, W);
      const int b2 = __shfl_sync(kFull, bp2, u, W);
      const bool v1 = i < len && b1 < 4;
      const bool v2 = i + 1 < len && b2 < 4;
      const int c1 = 3 - fmi::clamp_code(b1), c2 = 3 - fmi::clamp_code(b2);
      const T x = end ? static_cast<T>(w.l + w.s) : w.l;
      int r;
      const int32_t* row = fmi::occ2_row(c, p.occ2, x, r);
      uint32_t cw[NW], dw[NW] = {};
      fmi::load_slice<NW>(row + ql * NW, cw);
      // data words all at or past the row offset count nothing: unread
      if (8 * NW * ql < r) fmi::load_slice<NW>(row + 16 + ql * NW, dw);
      fmi::Occ2Sums<U> part =
          fmi::occ2_lane_part<G, U>(cw, dw, ql, r, c1, c2, masks);
#pragma unroll
      for (int m = G / 2; m > 0; m >>= 1) part = part + shfl_xor(part, m);
      part = fmi::occ2_finish<T, U>(c, x, c1, c2, part);
      const fmi::Occ2Sums<U> other = shfl_xor(part, G);
      T k1, l1, s1, k2, l2, s2;
      fmi::ext2_from<T, U>(c, w.k, w.l, w.s, b1, b2, end ? other : part,
                           end ? part : other, k1, l1, s1, k2, l2, s2);
      Col<T> eA, eB;
      if (ww.r3)
        r3_pair_trip<T>(c, a.min_len3, a.max_intv3, i, b1, b2, v1, v2, k1,
                        l1, s1, k2, l2, s2, w, eA, eB);
      else
        r1_pair_trip<T>(c, a.min_seed_len, i, b1, b2, v1, v2, k1, l1, s1,
                        k2, l2, s2, w, eA, eB);
      if (ww.q == u) {
        keepA = eA;
        keepB = eB;
      }
    }
    // the group's 2G trips as one run of the row: lane q's two columns
    if (ww.in && ww.q < nt) {
      if (ip < ww.width) put_col(a, ww.r3, ww.o + ip, keepA);
      if (ip + 1 < ww.width) put_col(a, ww.r3, ww.o + ip + 1, keepB);
    }
  }
  if (ww.in)
    for (int i = 2 * trips + ww.q; i < ww.width; i += W)
      (ww.r3 ? a.e3 : a.emit)[ww.o + i] = 0;
}

// The single-base walk (_forward_pass's and _seed_strategy_pass's trips):
// an occ row's query on a lane pair, four lanes a walk.
template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
    seed_single_kernel(fmi::FMPtrs p, FwdArgs<T> a, int nw1, int nwarps) {
  constexpr int W = 4;
  using U = fmi::Acc<T>;
  __shared__ FMConst c;
  fmi::load_const(c, p);
  WarpWalk ww;
  if (!warp_walk(a, nw1, nwarps, W, ww)) return;
  const int end = ww.q / 2, ql = ww.q % 2;
  const int len = ww.in ? a.lens[ww.b] : 0;
  const int trips = __reduce_max_sync(kFull, walk_trips(len, a.L, false));
  const int32_t* rd = a.reads + static_cast<int64_t>(ww.in ? ww.b : 0) * a.L;
  Walk<T> w{0, 0, 0, 0};
  Col<T> keep{};
  for (int t0 = 0; t0 < trips; t0 += W) {
    const int ip = t0 + ww.q;
    const int bp = ww.in && ip < a.L ? rd[ip] : 4;
    const int nt = trips - t0 < W ? trips - t0 : W;
    for (int u = 0; u < nt; ++u) {
      const int i = t0 + u;
      const int base = __shfl_sync(kFull, bp, u, W);
      const bool valid = i < len && base < 4;
      const T x = end ? static_cast<T>(w.l + w.s) : w.l;
      int r;
      const int32_t* row = fmi::occ_row(c, p.occ, x, r);
      uint32_t cw[2], bw[2] = {};
      fmi::load_slice<2>(row + 2 * ql, cw);
      if (32 * ql < r) fmi::load_slice<2>(row + 4 + 2 * ql, bw);
      fmi::OccSums<U> part = fmi::occ_lane_part<U>(
          cw, bw, ql, r, 3 - fmi::clamp_code(base));
      part = part + shfl_xor(part, 1);
      const fmi::OccSums<U> other = shfl_xor(part, 2);
      T nk, nl, ns;
      fmi::ext1_from<T, U>(c, w.k, w.l, w.s, base, end ? other : part,
                           end ? part : other, nk, nl, ns);
      Col<T> e;
      if (ww.r3)
        r3_single_trip<T>(c, a.min_len3, a.max_intv3, i, base, valid, nk,
                          nl, ns, w, e);
      else
        r1_single_trip<T>(c, a.min_seed_len, i, base, valid, nk, nl, ns, w,
                          e);
      if (ww.q == u) keep = e;
    }
    if (ww.in && ww.q < nt && ip < ww.width)
      put_col(a, ww.r3, ww.o + ip, keep);
  }
  if (ww.in)
    for (int i = trips + ww.q; i < ww.width; i += W)
      (ww.r3 ? a.e3 : a.emit)[ww.o + i] = 0;
}

// The re-seed walks (_reseed_forward's trips): per walk 2G lanes, each
// end's row query on G of them (an occ2 row: G = fmi::kPairLanes; an occ
// row: a lane pair), as S1's walks; a dead walk's lanes read no row.
template <typename T, bool kPairs>
__global__ void __launch_bounds__(kWalkThreads)
    seed_reseed_kernel(fmi::FMPtrs p, ReseedArgs<T> a) {
  constexpr int G = kPairs ? fmi::kPairLanes : 2, W = 2 * G, NW = 16 / G;
  using U = fmi::Acc<T>;
  __shared__ FMConst c;
  __shared__ uint32_t masks[33];
  if (kPairs)
    for (int t = threadIdx.x; t <= 32; t += kWalkThreads)
      masks[t] = fmi::plane_mask(t);
  fmi::load_const(c, p);
  const int lane = threadIdx.x & 31, q = lane % W;
  const int end = q / G, ql = q % G;
  const int r = blockIdx.x * (32 / W) + lane / W;
  const bool in = r < a.R;
  {
    // the warp's rows of the fill plane, one contiguous block, zeroed
    // with 8-byte stores (it starts r0 (L + 2) bytes, a multiple of 8,
    // into the plane the wrapper allocated)
    const int r0 = blockIdx.x * (32 / W);
    const int nr = a.R - r0 < 32 / W ? a.R - r0 : 32 / W;
    uint8_t* blk = a.fill + static_cast<int64_t>(r0) * (a.L + 2);
    const int64_t nbytes = static_cast<int64_t>(nr) * (a.L + 2);
    for (int64_t x = lane; x < nbytes / 8; x += 32)
      reinterpret_cast<uint2*>(blk)[x] = make_uint2(0u, 0u);
    for (int64_t x = nbytes / 8 * 8 + lane; x < nbytes; x += 32) blk[x] = 0;
    __syncwarp();
  }
  ReseedWalk<T> w{};
  if (in) w = reseed_start<T>(c, a, r);
  const int64_t o = static_cast<int64_t>(in ? r : 0) * (a.L + 2);
  const int tmax = reseed_trips(a.L, kPairs);
  int t = 0;
  bool any = __any_sync(kFull, w.alive);
  Col<T> keepA{}, keepB{};
  while (any && t < tmax) {
    const int t0 = t;
    // the bases of the group's next W trips, a trip a lane
    const int ip = w.lx + reseed_col(t0 + q, kPairs);
    const int bp1 = in ? reseed_base(a, w, ip) : 4;
    const int bp2 = kPairs && in ? reseed_base(a, w, ip + 1) : 4;
    int u = 0;
    for (; u < W && t < tmax && any; ++u, ++t) {
      const int i = w.lx + reseed_col(t, kPairs);
      const int b1 = __shfl_sync(kFull, bp1, u, W);
      const T x = end ? static_cast<T>(w.l + w.s) : w.l;
      int rr;
      if constexpr (kPairs) {
        const int b2 = __shfl_sync(kFull, bp2, u, W);
        const int c1 = 3 - fmi::clamp_code(b1), c2 = 3 - fmi::clamp_code(b2);
        const int32_t* row = fmi::occ2_row(c, p.occ2, x, rr);
        uint32_t cw[NW] = {}, dw[NW] = {};
        if (w.alive) {
          fmi::load_slice<NW>(row + ql * NW, cw);
          if (8 * NW * ql < rr) fmi::load_slice<NW>(row + 16 + ql * NW, dw);
        }
        fmi::Occ2Sums<U> part =
            fmi::occ2_lane_part<G, U>(cw, dw, ql, rr, c1, c2, masks);
#pragma unroll
        for (int m = G / 2; m > 0; m >>= 1) part = part + shfl_xor(part, m);
        part = fmi::occ2_finish<T, U>(c, x, c1, c2, part);
        const fmi::Occ2Sums<U> other = shfl_xor(part, G);
        T k1, l1, s1, k2, l2, s2;
        fmi::ext2_from<T, U>(c, w.k, w.l, w.s, b1, b2, end ? other : part,
                             end ? part : other, k1, l1, s1, k2, l2, s2);
        Col<T> eA, eB;
        reseed_pair_trip<T>(a.min_seed_len, i, i < w.len && b1 < 4,
                            i + 1 < w.len && b2 < 4, k1, l1, s1, k2, l2, s2,
                            w, eA, eB);
        if (q == u) {
          keepA = eA;
          keepB = eB;
        }
      } else {
        const int32_t* row = fmi::occ_row(c, p.occ, x, rr);
        uint32_t cw[2] = {}, bw[2] = {};
        if (w.alive) {
          fmi::load_slice<2>(row + 2 * ql, cw);
          if (32 * ql < rr) fmi::load_slice<2>(row + 4 + 2 * ql, bw);
        }
        fmi::OccSums<U> part = fmi::occ_lane_part<U>(
            cw, bw, ql, rr, 3 - fmi::clamp_code(b1));
        part = part + shfl_xor(part, 1);
        const fmi::OccSums<U> other = shfl_xor(part, 2);
        T nk, nl, ns;
        fmi::ext1_from<T, U>(c, w.k, w.l, w.s, b1, end ? other : part,
                             end ? part : other, nk, nl, ns);
        Col<T> e;
        reseed_single_trip<T>(a.min_seed_len, i, i < w.len && b1 < 4, nk, nl,
                              ns, w, e);
        if (q == u) keepA = e;
      }
      any = __any_sync(kFull, w.alive);
    }
    // the group's u trips as one run of the lane's row: lane q's columns
    if (in && q < u) {
      const int j = reseed_col(t0 + q, kPairs);
      put_reseed(a, o + j, keepA);
      if (kPairs) put_reseed(a, o + j + 1, keepB);
    }
  }
}

template <typename T>
int launch_forward(const fmi::FMPtrs& p, const FwdArgs<T>& a, bool pairs,
                   cudaStream_t st) {
  // walks a warp: 32 / 2G on occ2, 8 without
  const int per = pairs ? 16 / fmi::kPairLanes : 8;
  const int nw1 = (a.B + per - 1) / per;
  const int nwarps = nw1 * (a.strategy ? 2 : 1);
  const int grid = (nwarps + kWalkThreads / 32 - 1) / (kWalkThreads / 32);
  if (pairs)
    seed_pairs_kernel<T><<<grid, kWalkThreads, 0, st>>>(p, a, nw1, nwarps);
  else
    seed_single_kernel<T><<<grid, kWalkThreads, 0, st>>>(p, a, nw1, nwarps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reseed(const fmi::FMPtrs& p, const ReseedArgs<T>& a, bool pairs,
                  cudaStream_t st) {
  // walks a warp: 32 / 2G on occ2, 8 without
  const int per = pairs ? 16 / fmi::kPairLanes : 8;
  const int grid = (a.R + per - 1) / per;
  if (pairs)
    seed_reseed_kernel<T, true><<<grid, kWalkThreads, 0, st>>>(p, a);
  else
    seed_reseed_kernel<T, false><<<grid, kWalkThreads, 0, st>>>(p, a);
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

// Round-2 re-seed walks of R lanes into (R, L + 2) planes (fill written
// everywhere; kb, sb, eb where it is set). Returns a cudaError_t code.
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
