// The occurrences of SMEMs and their text positions, for Hopper
// (sm_90a): each SMEM's occurrence list, subsampled as mem_chain does,
// and the SA walk of each occurrence's BWT row (S4, sa_lookup).
//
// Replaces the XLA-compiled loop of bwamem_tpu/ops/fm.py sa_lookup_batch
// (:666) and the row arithmetic in front of it in
// bwamem_tpu/ops/seeding.py _expand_occurrences (:965). No
// pl.pallas_call stands behind them: the JAX package walks with XLA ops.
// The contract is the port's plain version, ops/seeding._expand_occurrences
// (on ops/fm.sa_lookup_batch), bit for bit in every field and in
// (candidate, SA rank) order: per SMEM (k, s, keep) with s_v = keep ? s
// : 0, step = s_v // max_occ where s_v > max_occ (else 1) and count =
// min(ceil(s_v / step), max_occ); per occurrence off of SMEM i the row
// k + off * step, at most sa_intv LF steps from it to a row whose SSA bit
// is set, then the sampled value (low uint32 word, plus the uint8 upper
// bits on a wide index) plus the steps taken; and SMEM i's read, qbeg,
// qend and s.
//
// What bounds it on this card: an occurrence takes up to sa_intv steps,
// each a dependent read of a 32 B SSA bitmap row and a 32 B occ row, so
// the latency of that chain bounds it (the tables sit in L2 on the 4.6
// Mbp world); the bytes each occurrence must move are its SMEM's fields,
// its output and one sampled value.
//
// Layout: two kernels a call. sa_count_kernel takes a tile of SMEMs a
// block (kTile a pass of its 256 threads, four SMEMs a thread): each
// SMEM's count (occ_count), their exclusive scan within the tile (loc)
// and the tile's total (tot). The wrapper reads the tiles' totals (the
// one host read: their sum sizes the output). sa_lookup_kernel takes one
// occurrence a thread, 128 a block, in output order: the block first
// scans the tiles' totals into shared memory, then each thread finds its
// tile there and its SMEM in the tile's loc (two binary searches; a
// warp's 32 occurrences share most of the search path, so its loads are
// broadcasts), computes its row and walks it. One thread a row, not a
// warp an SMEM: most SMEMs have one occurrence. Where step is 1 an SMEM's
// rows are consecutive, so its threads in a warp ask for the same SSA
// bitmap word and occ row on their first step: one request serves them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (ops/kernels/build.py)
#include <stdint.h>

#include <type_traits>

#include "fm_index.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace salk {

// sa_count_kernel's threads and the SMEMs one pass of them takes
constexpr int kCountThreads = 256;
constexpr int kItems = 4;
constexpr int64_t kTile = kCountThreads * kItems;
// at most this many tiles (a tile is a multiple of kTile SMEMs)
constexpr int kMaxTiles = 1024;
// sa_lookup_kernel's threads
constexpr int kThreads = 128;

// The SMEMs a tile of a call on n SMEMs: the least multiple of kTile
// that covers n in at most kMaxTiles tiles.
BM_HD int64_t tile_of(int64_t n) {
  constexpr int64_t kMost = kTile * kMaxTiles;
  return kTile * (n > kMost ? (n + kMost - 1) / kMost : 1);
}

// The tiles of a call on n SMEMs, each of `tile` SMEMs.
BM_HD int64_t tiles_of(int64_t n, int64_t tile) {
  return n > 0 ? (n + tile - 1) / tile : 0;
}

// The occurrences of an SMEM of size s (keep: its keep mask) under
// max_occ, and the step between their rows (mem_chain's subsampling).
BM_HD int64_t occ_count(int64_t s, bool keep, int64_t max_occ,
                        int64_t& step) {
  const int64_t sv = keep ? s : 0;
  step = sv > max_occ ? sv / max_occ : 1;
  const int64_t n = sv > 0 ? (sv + step - 1) / step : 0;
  return n < max_occ ? n : max_occ;
}

template <typename T>
struct ExpandArgs {
  const int32_t* rid;   // (n,) SMEMs: read, qbeg, qend, k, s
  const int32_t* qbeg;
  const int32_t* qend;
  const T* k;
  const T* s;
  int64_t n;
  int64_t max_occ;
  int64_t tile;         // SMEMs a tile
  int nb;               // tiles
  const int64_t* loc;   // (n,) exclusive scan of the counts in each tile
  const int64_t* tot;   // (nb,) each tile's count
  int64_t total;        // occurrences
  int32_t* read_id;     // (total,) the outputs
  int32_t* qb_out;
  int32_t* qe_out;
  T* rbeg;
  T* n_occ;
};

// The SMEM of occurrence o (< total) and its offset in the SMEM's list;
// pre[b] is the sum of the counts of the tiles before tile b. The last
// tile whose first occurrence is at or before o holds it (a tile of no
// occurrences shares its pre with the next), and in it the last SMEM
// whose first occurrence is at or before o.
template <typename T>
BM_HD int64_t find_owner(const ExpandArgs<T>& a, const int64_t* pre,
                         int64_t o, int64_t& off) {
  int lo = 0, hi = a.nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= o)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int64_t local = o - pre[lo];
  int64_t i0 = lo * a.tile;
  int64_t i1 = i0 + a.tile < a.n ? i0 + a.tile - 1 : a.n - 1;
  while (i0 < i1) {
    const int64_t mid = (i0 + i1 + 1) >> 1;
    if (a.loc[mid] <= local)
      i0 = mid;
    else
      i1 = mid - 1;
  }
  off = local - a.loc[i0];
  return i0;
}

// Occurrence o: its SMEM's fields and the text position of its row.
template <typename T>
BM_HD void expand_one(const fmi::FMConst& c, const fmi::FMPtrs& p,
                      const ExpandArgs<T>& a, const int64_t* pre,
                      int sa_intv, int64_t o) {
  int64_t off, step;
  const int64_t i = find_owner(a, pre, o, off);
  const T s = a.s[i];
  occ_count(s, true, a.max_occ, step);
  const T row = static_cast<T>(static_cast<int64_t>(a.k[i]) + off * step);
  a.rbeg[o] = fmi::sa_lookup_one<T>(c, p, row, sa_intv);
  a.read_id[o] = a.rid[i];
  a.qb_out[o] = a.qbeg[i];
  a.qe_out[o] = a.qend[i];
  a.n_occ[o] = s;
}

#ifdef __CUDACC__
constexpr unsigned kFull = 0xffffffffu;

// Exclusive scan of x over the block's NT threads; `total` gets the
// block's sum. Every thread of the block must call it.
template <int NT>
__device__ __forceinline__ int64_t block_scan(int64_t x, int64_t& total) {
  __shared__ int64_t wsum[NT / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int64_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  int64_t before = 0, sum = 0;
#pragma unroll
  for (int j = 0; j < NT / 32; ++j) {
    before += j < w ? wsum[j] : 0;
    sum += wsum[j];
  }
  __syncthreads();  // wsum is free for the next call
  total = sum;
  return before + inc - x;
}

template <typename T>
__global__ void __launch_bounds__(kCountThreads)
    sa_count_kernel(const T* s, const uint8_t* keep, int64_t n,
                    int64_t max_occ, int64_t tile, int64_t* loc,
                    int64_t* tot) {
  const int64_t base = blockIdx.x * tile;
  const int64_t end = base + tile < n ? base + tile : n;
  int64_t carry = 0;
  for (int64_t pass = base; pass < end; pass += kTile) {
    const int64_t i0 = pass + threadIdx.x * kItems;
    int64_t cnt[kItems], sum = 0, step;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = i0 + j;
      cnt[j] = i < end ? occ_count(s[i], keep[i] != 0, max_occ, step) : 0;
      sum += cnt[j];
    }
    int64_t all;
    int64_t run = carry + block_scan<kCountThreads>(sum, all);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < end) loc[i0 + j] = run;
      run += cnt[j];
    }
    carry += all;
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = carry;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sa_lookup_kernel(fmi::FMPtrs p, ExpandArgs<T> a, int sa_intv) {
  constexpr int kPer = kMaxTiles / kThreads;
  __shared__ fmi::FMConst c;
  __shared__ int64_t pre[kMaxTiles];
  fmi::load_const(c, p);
  // the tiles' first occurrences (every block scans the tiles' totals)
  int64_t v[kPer], sum = 0, all;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = threadIdx.x * kPer + j;
    v[j] = b < a.nb ? a.tot[b] : 0;
    sum += v[j];
  }
  int64_t run = block_scan<kThreads>(sum, all);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    pre[threadIdx.x * kPer + j] = run;
    run += v[j];
  }
  __syncthreads();
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o < a.total) expand_one<T>(c, p, a, pre, sa_intv, o);
}
#endif

}  // namespace salk

#ifdef __CUDACC__
extern "C" {

// The tiles of a call on n SMEMs: the length of bm_sa_count's tot.
long long bm_sa_tiles(long long n) {
  return salk::tiles_of(n, salk::tile_of(n));
}

// Per tile (salk::tile_of): the exclusive scan of the SMEMs' occurrence
// counts in loc (n) and the tile's count in tot (bm_sa_tiles; s: int64
// where wide, else int32; keep: bool). Returns a cudaError_t code.
int bm_sa_count(const void* s, const void* keep, long long n, int wide,
                long long max_occ, void* loc, void* tot, void* stream) {
  if (n <= 0) return 0;
  if (max_occ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tile = salk::tile_of(n);
  const long long nb = salk::tiles_of(n, tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto* sp) {
    salk::sa_count_kernel<<<static_cast<unsigned>(nb), salk::kCountThreads,
                            0, st>>>(sp, static_cast<const uint8_t*>(keep),
                                     n, max_occ, tile,
                                     static_cast<int64_t*>(loc),
                                     static_cast<int64_t*>(tot));
    return static_cast<int>(cudaGetLastError());
  };
  if (wide) return go(static_cast<const int64_t*>(s));
  return go(static_cast<const int32_t*>(s));
}

// The `total` occurrences of n SMEMs (rid, qbeg, qend: int32; k, s, and
// the outputs rbeg and n_occ: int64 where wide, else int32) from
// bm_sa_count's loc and tot: read_id, qbeg, qend, rbeg and n_occ of each.
// Returns a cudaError_t code.
int bm_sa_lookup(const fmi::FMPtrs* fm, const void* rid, const void* qbeg,
                 const void* qend, const void* k, const void* s, long long n,
                 int wide, int sa_intv, long long max_occ, const void* loc,
                 const void* tot, long long total, void* read_id,
                 void* qb_out, void* qe_out, void* rbeg, void* n_occ,
                 void* stream) {
  if (total <= 0) return 0;
  const long long blocks = (total + salk::kThreads - 1) / salk::kThreads;
  if (n <= 0 || sa_intv < 1 || max_occ < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile = salk::tile_of(n);
  const long long nb = salk::tiles_of(n, tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto* kp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(kp)>>;
    salk::ExpandArgs<T> a{static_cast<const int32_t*>(rid),
                          static_cast<const int32_t*>(qbeg),
                          static_cast<const int32_t*>(qend), kp,
                          static_cast<const T*>(s), n, max_occ, tile,
                          static_cast<int>(nb),
                          static_cast<const int64_t*>(loc),
                          static_cast<const int64_t*>(tot), total,
                          static_cast<int32_t*>(read_id),
                          static_cast<int32_t*>(qb_out),
                          static_cast<int32_t*>(qe_out),
                          static_cast<T*>(rbeg), static_cast<T*>(n_occ)};
    salk::sa_lookup_kernel<T>
        <<<static_cast<unsigned>(blocks), salk::kThreads, 0, st>>>(*fm, a,
                                                                   sa_intv);
    return static_cast<int>(cudaGetLastError());
  };
  if (wide) return go(static_cast<const int64_t*>(k));
  return go(static_cast<const int32_t*>(k));
}

const char* bm_sa_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
