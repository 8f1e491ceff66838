// FM-index primitives of the seeding kernels (seed_forward.cu,
// seed_backward.cu, sa_lookup.cu), one query per thread.
//
// Each function computes, for one interval or row, what its torch
// counterpart in bwamem_tpu_torch/ops/fm.py computes for a batch, bit for
// bit: the occ rank of one code (_rank1), the backward extension of the
// k-side interval (backward_ext_ks_batch), one forward extension by a
// chosen base (forward_ext4_batch, the column the walk selects), two
// forward extensions from one occ2 pair-row gather a row
// (forward_ext2_batch with _rank4p and _pair4, the two sentinel terms
// included), the 1-base restart interval (ops/seeding._init1) and the SA
// walk of one row (sa_lookup_batch with _ssa_bits and _ssa_combine).
//
// Positions take the type T of the index: int32_t, or int64_t where the
// index is wide (fm.wide), with the same wrap-around as torch's int32 and
// int64 arithmetic. The small tables (L2, primary, the occ2 start and
// 2-mer tables, the sentinel row's scalars, the SSA row offset) are read
// from the index's device tensors into shared memory once a block
// (load_const): a launch needs no host copy of them (no sync), and two
// launches on two indexes never share them, as one __constant__ copy a
// library would.
//
// Every function is __host__ __device__: without nvcc the header compiles
// as plain C++, so the walks' arithmetic can be held against the torch
// versions on a machine without a card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

namespace fmi {

BM_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// a[i] of a 4-entry register array, i in 0..3, as selects (an index
// known only at run time would move the array to local memory)
template <typename V>
BM_HD V sel4(const V* a, int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : (i == 2 ? a[2] : a[3]));
}

constexpr uint32_t kM1 = 0x55555555u;   // low bit of every 2-bit code
constexpr uint32_t kNib = 0x11111111u;  // low bit of every 4-bit pair code
constexpr int kO2Shift = 7;             // occ2: 128 BWT rows a table row
constexpr int kO2Mask = 127;

// Device pointers to the index's tensors (DeviceFMIndex fields), as the
// wrappers pass them: every pointer is to contiguous data of the field's
// dtype.
struct FMPtrs {
  const int32_t* occ;       // occ_blocks (n_occ + n_ssa, 8)
  const int32_t* occ2;      // occ2_blocks (n2, 32); unused without occ2
  const int64_t* L2;        // (5,)
  const int64_t* primary;   // ()
  const int64_t* start2;    // occ2_start (16,)
  const int64_t* pat;       // occ2_pat (3, 16)
  const int32_t* sa1;       // sa1_scalars (2,): sa1_j, sa1_pair
  const int32_t* n_occ;     // n_occ_blocks ()
  const int32_t* ssa_vals;  // (n_sampled,) uint32 low words
  const uint8_t* ssa_hi;    // (n_sampled,) bits >= 32
};

// The small tables, copied into shared memory once a block.
struct FMConst {
  int64_t L2[5];
  int64_t primary;
  int64_t start2[16];
  int64_t pat[48];  // (3, 16): k, l, s of each 2-mer
  int32_t sa1_j;
  int32_t sa1_pair;
  int32_t n_occ;
};

// Fill `c` from the index (an index without occ2 still has its
// all-zero start2 and 2-mer tables).
BM_HD void fill_const(FMConst& c, const FMPtrs& p) {
  for (int i = 0; i < 5; ++i) c.L2[i] = p.L2[i];
  c.primary = p.primary[0];
  c.sa1_j = p.sa1[0];
  c.sa1_pair = p.sa1[1];
  c.n_occ = p.n_occ[0];
  for (int i = 0; i < 16; ++i) c.start2[i] = p.start2[i];
  for (int i = 0; i < 48; ++i) c.pat[i] = p.pat[i];
}

#ifdef __CUDACC__
// One thread of the block fills the shared copy; all wait for it.
__device__ __forceinline__ void load_const(FMConst& c, const FMPtrs& p) {
  if (threadIdx.x == 0) fill_const(c, p);
  __syncthreads();
}
#endif

BM_HD int clamp_code(int b) { return b < 0 ? 0 : (b > 3 ? 3 : b); }

// Copy `n` 32-bit words of a table row (16-byte aligned) into registers.
template <int N>
BM_HD void load_words(const int32_t* src, uint32_t* dst) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
#else
  for (int i = 0; i < N; ++i) dst[i] = static_cast<uint32_t>(src[i]);
#endif
}

// Occ row of BWT$ row i (the sentinel row removed) and its offset in it.
template <typename T>
BM_HD const int32_t* occ_row(const FMConst& c, const int32_t* occ, T i,
                             int& r) {
  const T prim = static_cast<T>(c.primary);
  const T j = i - static_cast<T>(i > prim);
  r = static_cast<int>(j & 63);
  return occ + static_cast<int64_t>(j >> 6) * 8;
}

// Count of code `code` among the first r bases of an occ row, plus the
// row's checkpoint count of it (_rank1).
template <typename T>
BM_HD T rank1(const uint32_t* row, int r, int code) {
  int64_t cnt = sel4(row, code);
  const uint32_t pat = static_cast<uint32_t>(code) * kM1;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int q = r - 16 * w;
    q = q < 0 ? 0 : (q > 16 ? 16 : q);
    const uint32_t m = q <= 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * q));
    const uint32_t y = ~(row[4 + w] ^ pat);
    cnt += popc(y & (y >> 1) & kM1 & m);
  }
  return static_cast<T>(cnt);
}

// Backward extension of the k-side interval (k, s) by base `code` (0..3):
// backward_ext_ks_batch.
template <typename T>
BM_HD void backward_ext(const FMConst& c, const int32_t* occ, T k, T s,
                        int code, T& nk, T& ns) {
  uint32_t row[8];
  int r;
  load_words<8>(occ_row(c, occ, k, r), row);
  const T ok = rank1<T>(row, r, code);
  load_words<8>(occ_row(c, occ, static_cast<T>(k + s), r), row);
  const T ol = rank1<T>(row, r, code);
  nk = static_cast<T>(c.L2[code]) + 1 + ok;
  ns = ol - ok;
}

// Forward extension of the bi-interval (k, l, s) by base b (clamped to
// 0..3): the column b of forward_ext4_batch's (k4, l4, s4), from the
// ranks of all four codes at l and at l + s.
template <typename T>
BM_HD void forward_ext1(const FMConst& c, const int32_t* occ, T k, T l, T s,
                        int b, T& nk, T& nl, T& ns) {
  const int cc = 3 - clamp_code(b);
  uint32_t lo[8], hi[8];
  int rlo, rhi;
  load_words<8>(occ_row(c, occ, l, rlo), lo);
  load_words<8>(occ_row(c, occ, static_cast<T>(l + s), rhi), hi);
  T ok[4], cnt[4];
  T suffix = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    ok[x] = rank1<T>(lo, rlo, x);
    cnt[x] = rank1<T>(hi, rhi, x) - ok[x];
    if (x > cc) suffix += cnt[x];
  }
  const T prim = static_cast<T>(c.primary);
  const T sent = static_cast<T>(l <= prim && prim < static_cast<T>(l + s));
  nk = k + sent + suffix;
  nl = static_cast<T>(c.L2[cc]) + 1 + sel4(ok, cc);
  ns = sel4(cnt, cc);
}

// One occ2 row query at BWT$ row i for the pair step after cur code c1:
// R4[c], the single-code ranks of all four codes (_rank4p: checkpoint
// sums over the previous code, in-block nibble matches, the sentinel
// row's add-back), and P4[cp], the pair counts (prev = cp, cur = c1)
// with the bogus sentinel pair discounted (_pair4).
template <typename T>
BM_HD void occ2_query(const FMConst& c, const int32_t* occ2, T i, int c1,
                      T R4[4], T P4[4]) {
  const T prim = static_cast<T>(c.primary);
  const T j = i - static_cast<T>(i > prim);
  const int32_t* rowp = occ2 + static_cast<int64_t>(j >> kO2Shift) * 32;
  uint32_t cnt[16], data[16];
  load_words<16>(rowp, cnt);
  load_words<16>(rowp + 16, data);
  const int r = static_cast<int>(j & kO2Mask);
  int64_t pc[3] = {0, 0, 0}, pp[3] = {0, 0, 0};
  const uint32_t c1pat = static_cast<uint32_t>(c1) * kNib;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    int q = r - 8 * w;
    if (q <= 0) break;
    q = q > 8 ? 8 : q;
    const uint32_t pm = 0xFFFFFFFFu << (32 - 4 * q);
    const uint32_t d = data[w];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const uint32_t y = ~(d ^ (static_cast<uint32_t>(x) * kNib));
      pc[x] += popc(y & (y >> 1) & kNib & pm);
    }
    const uint32_t yc = ~(d ^ c1pat);
    const uint32_t low2 = yc & (yc >> 1) & kNib & pm;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const uint32_t yh = ~(d ^ (static_cast<uint32_t>(x << 2) * kNib));
      pp[x] += popc(low2 & (yh >> 2) & (yh >> 3));
    }
  }
  const int64_t pcs[4] = {pc[0], pc[1], pc[2], r - pc[0] - pc[1] - pc[2]};
  const T sa1j = static_cast<T>(c.sa1_j);
  const bool back_blk = (sa1j >> kO2Shift) < (j >> kO2Shift);
  const int sa1_c = c.sa1_pair & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int64_t base = static_cast<int64_t>(cnt[x]) + cnt[4 + x] +
                         cnt[8 + x] + cnt[12 + x];
    R4[x] = static_cast<T>(base + pcs[x] + (x == sa1_c && back_blk));
  }
  const bool in_blk = (j >> kO2Shift) == (sa1j >> kO2Shift) &&
                      (c.sa1_j & kO2Mask) < r;
  const int64_t pps[4] = {pp[0], pp[1], pp[2],
                          sel4(pcs, c1) - pp[0] - pp[1] - pp[2]};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int d = (x << 2) | c1;
    P4[x] = static_cast<T>(static_cast<int64_t>(sel4(cnt + 4 * x, c1)) +
                           pps[x] - (d == c.sa1_pair && in_blk));
  }
}

// Two forward extensions (append b1, then b2; each clamped to 0..3) from
// one occ2 row gather at l and at l + s: forward_ext2_batch. (k1, l1, s1)
// is the interval after b1, (k2, l2, s2) after both.
template <typename T>
BM_HD void forward_ext2(const FMConst& c, const int32_t* occ2, T k, T l,
                        T s, int b1, int b2, T& k1, T& l1, T& s1, T& k2,
                        T& l2, T& s2) {
  const int c1 = 3 - clamp_code(b1);
  const int c2 = 3 - clamp_code(b2);
  const T le = static_cast<T>(l + s);
  T Rlo[4], Plo[4], Rhi[4], Phi[4];
  occ2_query(c, occ2, l, c1, Rlo, Plo);
  occ2_query(c, occ2, le, c1, Rhi, Phi);
  const T prim = static_cast<T>(c.primary);
  T suf1 = 0, suf2 = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (x > c1) suf1 += Rhi[x] - Rlo[x];
    if (x > c2) suf2 += Phi[x] - Plo[x];
  }
  s1 = sel4(Rhi, c1) - sel4(Rlo, c1);
  l1 = static_cast<T>(c.L2[c1]) + 1 + sel4(Rlo, c1);
  k1 = k + static_cast<T>(l <= prim && prim < le) + suf1;
  s2 = sel4(Phi, c2) - sel4(Plo, c2);
  l2 = static_cast<T>(c.start2[(c2 << 2) | c1]) + sel4(Plo, c2);
  // the one row whose previous char is the sentinel lies in [l, l+s) and
  // carries cur c1
  const T sa1j = static_cast<T>(c.sa1_j);
  const T r1row = sa1j + static_cast<T>(sa1j >= prim);
  k2 = k1 + static_cast<T>(l <= r1row && r1row < le &&
                           (c.sa1_pair & 3) == c1) + suf2;
}

// Bi-interval of the single base b (clamped to 0..3): a walk's restart.
template <typename T>
BM_HD void init1(const FMConst& c, int b, T& k, T& l, T& s) {
  const int bc = clamp_code(b);
  k = static_cast<T>(c.L2[bc]) + 1;
  l = static_cast<T>(c.L2[3 - bc]) + 1;
  s = static_cast<T>(c.L2[bc + 1]) - (k - 1);
}

// The 2-mer bi-interval of (b1, b2) (each clamped): the pair walk's
// restart at a pair's second base.
template <typename T>
BM_HD void init2(const FMConst& c, int b1, int b2, T& k, T& l, T& s) {
  const int d = clamp_code(b1) * 4 + clamp_code(b2);
  k = static_cast<T>(c.pat[d]);
  l = static_cast<T>(c.pat[16 + d]);
  s = static_cast<T>(c.pat[32 + d]);
}

// Text position of BWT$ row r: at most sa_intv LF steps to a row whose
// SSA bit is set, then the sampled value plus the steps taken
// (sa_lookup_batch). A row that meets no sampled row in sa_intv steps
// gives ssa_vals[0], as the torch version does.
template <typename T>
BM_HD T sa_lookup_one(const FMConst& c, const FMPtrs& p, T r, int sa_intv) {
  const T prim = static_cast<T>(c.primary);
  int64_t rank = 0;
  int step_hit = 0;
  for (int step = 0; step < sa_intv; ++step) {
    const int32_t* srow =
        p.occ + (static_cast<int64_t>(c.n_occ) + static_cast<int64_t>(r >> 6)) * 8;
    uint32_t sw[4];
    load_words<4>(srow, sw);
    const int off = static_cast<int>(r & 63);
    const uint32_t lo = sw[1], hi = sw[2];
    if ((((off < 32) ? lo : hi) >> (off & 31)) & 1u) {
      const uint32_t below_lo = off >= 32 ? lo : (lo & ((1u << off) - 1u));
      const uint32_t below_hi =
          off > 32 ? (hi & ((1u << (off - 32)) - 1u)) : 0u;
      rank = static_cast<int64_t>(static_cast<int32_t>(sw[0])) +
             popc(below_lo) + popc(below_hi);
      step_hit = step;
      break;
    }
    // LF: the BWT char of row r, then its rank
    int rr;
    uint32_t row[8];
    load_words<8>(occ_row(c, p.occ, r, rr), row);
    const int code = static_cast<int>(
        (sel4(row + 4, rr >> 4) >> (30 - 2 * (rr & 15))) & 3u);
    const T dest = static_cast<T>(c.L2[code]) + 1 + rank1<T>(row, rr, code);
    r = (r == prim) ? static_cast<T>(0) : dest;
  }
  int64_t v = static_cast<uint32_t>(p.ssa_vals[rank]);
  if (sizeof(T) == 8) v |= static_cast<int64_t>(p.ssa_hi[rank]) << 32;
  return static_cast<T>(v + step_hit);
}

}  // namespace fmi
