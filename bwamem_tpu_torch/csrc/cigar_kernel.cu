// K5: the finalize's CIGAR solve on the H100. Each job is one gen_cigar
// chain of the native finalize (native/reg2aln_core.h solve_record): up to
// three banded global alignments (bm_ksw_global, native/ksw.cpp) at the
// bands the retry loop would try, ending where the loop ends, then the
// traceback of the last into run-length CIGAR ops. The score and the CIGAR
// are bm_ksw_global's bit for bit: its recurrence, its tie order (the
// diagonal beats a target gap, that winner beats a query gap; a gap extends
// only when strictly better than a fresh open), its boundary rows and its
// 3-state walk. The split finalize (csrc/finalize_split.cpp) plans the jobs
// and renders the SAM from the rows written here.
//
// Replaces no TPU kernel: the JAX package solves CIGARs on the host.
// Bound on this card: issue, ~8 instructions a live band cell per pass (as
// K1-K3 count them) over 33.45 T/s; the bytes (query codes and descriptors
// in, rows out, the window from the L2-resident packed genome) are smaller.
//
// Design:
//  - One warp a job, the band across the lanes in chunks of 32 columns.
//    Rows go in order; a row's query-gap state F is the exclusive prefix
//    max of diag(j') - o_ins - e_ins + e_ins*(j' + 1) along the row less
//    e_ins*j (the sequential recurrence unrolled), one warp scan a chunk
//    with the carry of the chunks before. H (two rows) and the column-gap
//    state E live in shared memory, indexed by column as bm_ksw_global
//    keeps them, so a row's cells read the row above whatever lane owned
//    them; one __syncwarp a row.
//  - Traceback at 4 bits a cell (the source and the two extend flags), as
//    four ballots a chunk, in the warp's shared memory where the job fits
//    there whole; a longer or wider job (1 kb reads, -x pacbio) keeps it in
//    the launch's global scratch at the byte offset its `tboff` gives (the
//    wrapper tiles the jobs so a launch's scratch stays bounded), its codes
//    and DP rows still in shared memory. Every pass keeps its traceback, so
//    the pass the loop ends on needs no second DP; a pass whose band
//    equals the last one's is not run (its score, and so the loop's exit,
//    are the last one's).
//  - The walk runs on lane 0 and writes at most `cap` runs; a longer CIGAR,
//    and a job whose warp would need more shared memory than the launch
//    gives (`smem_warp`), leave the row's op count at -1 for the host.
//    Slots past a row's runs hold 0.
//  - The window is read from the packed genome (2 bits a base) on the
//    card; only descriptors and the reads' codes go up, only the rows come
//    back.
//
// API (ctypes; pointers are device pointers, stream a cudaStream_t):
//   int bmt_cigar_solve(qs, qoff, rb, desc, pac, l_pac, mat, o_del, e_del,
//                       o_ins, e_ins, n, cap, smem_warp, warps, tboff,
//                       scratch, out, stream)
//   tboff: (n,) int64 byte offsets of the jobs' tracebacks in scratch (-1:
//   in shared memory), or null when every traceback is in shared memory.
//   Returns a cudaError_t (0: launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace k5 {

constexpr int kNeg = -0x40000000;
constexpr int kDesc = 8;
constexpr unsigned kFull = 0xffffffffu;
enum { kDiag = 0, kDel = 1, kIns = 2 };
enum { kOpM = 0, kOpI = 1, kOpD = 2 };

struct Params {
  const uint8_t* qs;      // read codes 0..4
  const int64_t* qoff;    // a job's query slice in qs
  const int64_t* rb;      // a job's window start, doubled coordinates
  const int32_t* desc;    // lq, rlen, thr, nb, band[3], band max
  const uint32_t* pac;    // the packed genome, 16 bases a word
  int64_t l_pac;
  const int32_t* mat;     // 5 x 5, row = window base
  int o_del, e_del, o_ins, e_ins;
  int n, cap, smem_warp;
  const int64_t* tboff;   // a job's traceback in scratch (-1, or null: none)
  uint8_t* scratch;
  int32_t* out;           // n rows of 2 + cap: score, n_ops, ops
};

struct Smem {
  uint8_t* q;   // query codes, oriented as gen_cigar orients them
  uint8_t* t;   // window codes
  int* h0;      // H of even rows' predecessor / odd rows (lq + 2 cells)
  int* h1;
  int* e;       // E by column
  uint4* tb;    // traceback: a uint4 of 4 bit planes per 32 columns a row
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// the layout cigar_kernel.job_smem sizes
__device__ inline Smem carve(uint8_t* base, int lq, int rlen) {
  Smem s;
  int o = 0;
  s.q = base;
  o += round16(lq);
  s.t = base + o;
  o += round16(rlen);
  const int hw = ((lq + 2 + 3) & ~3) * 4;
  s.h0 = reinterpret_cast<int*>(base + o);
  s.h1 = reinterpret_cast<int*>(base + o + hw);
  s.e = reinterpret_cast<int*>(base + o + 2 * hw);
  s.tb = reinterpret_cast<uint4*>(base + o + 3 * hw);
  return s;
}

__device__ __forceinline__ int base_fwd(const uint32_t* pac, int64_t p) {
  return (int)((__ldg(pac + (p >> 4)) >> (30 - 2 * (int)(p & 15))) & 3u);
}

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// gen_cigar's ungapped call (lq == rlen, band 0): the summed scores
__device__ int ungapped(const Smem& s, const int* smat, int lq, int lane) {
  int sum = 0;
  for (int j = lane; j < lq; j += 32) sum += smat[5 * s.t[j] + s.q[j]];
#pragma unroll
  for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  return sum;
}

// One bm_ksw_global pass at band w: the corner's score, and the traceback
// of every band cell in s.tb
__device__ int dp_pass(const Params& p, const Smem& s, const int* smat,
                       int lq, int rlen, int w, int lane) {
  if (lq == 0 || rlen == 0) return lq || rlen ? kNeg : 0;   // an empty side
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  const int nch = (min(lq, 2 * w + 1) + 31) >> 5;
  const int top = min(lq, w);
  for (int j = lane; j < lq + 2; j += 32) {
    s.h0[j] = j == 0 ? 0 : (j <= top ? -(p.o_ins + p.e_ins * j) : kNeg);
    s.h1[j] = kNeg;
    s.e[j] = kNeg;
  }
  __syncwarp();
  for (int i = 0; i < rlen; ++i) {
    const int* hp = (i & 1) ? s.h1 : s.h0;
    int* hc = (i & 1) ? s.h0 : s.h1;
    const int beg = max(i - w, 0), end = min(i + w + 1, lq);
    const int* srow = smat + 5 * s.t[i];
    if (lane == 0) hc[beg] = beg == 0 ? -(p.o_del + p.e_del * (i + 1)) : kNeg;
    int carry = kNeg + p.e_ins * beg;   // F(beg) + e_ins * beg
    uint4* tbrow = s.tb + (size_t)i * nch;
    for (int c0 = beg; c0 < end; c0 += 32) {
      const int j = c0 + lane;
      const bool act = j < end;
      int diag = 0, ed = kNeg, g = INT32_MIN;
      if (act) {
        diag = hp[j] + srow[s.q[j]];
        ed = s.e[j];
        g = diag - oe_ins + p.e_ins * (j + 1);
      }
      const int incl = warp_incl_max(g, lane);
      const int up = __shfl_up_sync(kFull, incl, 1);
      const int f = (lane == 0 ? carry : max(up, carry)) - p.e_ins * j;
      carry = max(carry, __shfl_sync(kFull, incl, 31));
      int best = diag, src = kDiag;
      if (!(diag >= ed)) {
        best = ed;
        src = kDel;
      }
      if (f > best) {
        best = f;
        src = kIns;
      }
      const bool ext_d = ed - p.e_del > diag - oe_del;
      const bool ext_i = f - p.e_ins > diag - oe_ins;
      if (act) {
        hc[j + 1] = best;
        s.e[j] = ext_d ? ed - p.e_del : diag - oe_del;
      }
      const unsigned b0 = __ballot_sync(kFull, act && (src & 1));
      const unsigned b1 = __ballot_sync(kFull, act && (src & 2));
      const unsigned b2 = __ballot_sync(kFull, act && ext_d);
      const unsigned b3 = __ballot_sync(kFull, act && ext_i);
      if (lane == 0) tbrow[(c0 - beg) >> 5] = make_uint4(b0, b1, b2, b3);
    }
    if (lane == 0) s.e[end] = kNeg;
    __syncwarp();
  }
  const int score = ((rlen - 1) & 1 ? s.h0 : s.h1)[lq];
  __syncwarp();
  return score;
}

// bm_ksw_global's walk from the corner over the pass at band w; the runs
// go to ops[0..) in order. Returns their number, or -1 past cap.
__device__ int walk(const Smem& s, int lq, int rlen, int w, int cap,
                    int32_t* ops) {
  const int nch = (min(lq, 2 * w + 1) + 31) >> 5;
  int n = 0, cur = -1, run = 0;
  bool over = false;
  auto push = [&](int op, int len) {
    if (n < cap)
      ops[n] = (len << 4) | op;
    else
      over = true;
    ++n;
  };
  auto emit = [&](int op, int len) {
    if (op == cur) {
      run += len;
    } else {
      if (run) push(cur, run);
      cur = op;
      run = len;
    }
  };
  int i = rlen - 1, k = min(i + w + 1, lq) - 1, st = kDiag;
  if (lq == 0 || rlen == 0) i = k = -1;   // an empty side: D then I
  while (i >= 0 && k >= 0) {
    const int c = k - max(i - w, 0);
    const uint4 v = s.tb[(size_t)i * nch + (c >> 5)];
    const int b = c & 31;
    const int cell = ((v.x >> b) & 1) | (((v.y >> b) & 1) << 1) |
                     (((v.z >> b) & 1) << 2) | (((v.w >> b) & 1) << 3);
    if (st == kDiag)
      st = cell & 3;
    else if (st == kDel)
      st = (cell & 4) ? kDel : kDiag;
    else
      st = (cell & 8) ? kIns : kDiag;
    if (st == kDiag) {
      emit(kOpM, 1);
      --i;
      --k;
    } else if (st == kDel) {
      emit(kOpD, 1);
      --i;
    } else {
      emit(kOpI, 1);
      --k;
    }
  }
  if (lq == 0 || rlen == 0) {
    if (rlen) emit(kOpD, rlen);
    if (lq) emit(kOpI, lq);
  }
  if (i >= 0) emit(kOpD, i + 1);
  if (k >= 0) emit(kOpI, k + 1);
  if (run) push(cur, run);
  if (over) {
    for (int a = 0; a < cap; ++a) ops[a] = 0;
    return -1;
  }
  for (int a = 0, z = n - 1; a < z; ++a, --z) {  // the walk ran backwards
    const int32_t x = ops[a];
    ops[a] = ops[z];
    ops[z] = x;
  }
  return n;
}

__global__ void cigar_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = p.mat[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int job = blockIdx.x * (blockDim.x >> 5) + warp;
  if (job >= p.n) return;
  const int32_t* d = p.desc + (size_t)job * kDesc;
  const int lq = d[0], rlen = d[1], thr = d[2], nb = d[3], bmax = d[7];
  int32_t* out = p.out + (size_t)job * (2 + p.cap);
  for (int l = lane; l < p.cap; l += 32) out[2 + l] = 0;   // unused runs: 0
  __syncwarp();
  const int dlen = rlen > lq ? rlen - lq : lq - rlen;
  // the job's shared memory, as cigar_kernel.job_smem counts it (less the
  // traceback where that is in scratch)
  const int ncol = bmax >= 0 ? min(lq, 2 * max(bmax, dlen) + 1) : 0;
  const long long off = p.tboff ? p.tboff[job] : -1;
  const long long need = (long long)round16(lq) + round16(rlen) +
                         3LL * ((lq + 2 + 3) & ~3) * 4 +
                         (off < 0 ? (long long)rlen * ((ncol + 31) >> 5) * 16
                                  : 0);
  if (nb <= 0 || need > p.smem_warp) {
    if (lane == 0) {
      out[0] = 0;
      out[1] = -1;
    }
    return;
  }
  Smem s = carve(smem + (size_t)warp * p.smem_warp, lq, rlen);
  if (off >= 0) s.tb = reinterpret_cast<uint4*>(p.scratch + off);
  const int64_t r0 = p.rb[job];
  const bool rev = r0 >= p.l_pac;
  const uint8_t* qsrc = p.qs + p.qoff[job];
  for (int j = lane; j < lq; j += 32)
    s.q[j] = rev ? qsrc[lq - 1 - j] : qsrc[j];
  // gen_cigar reverses the reverse strand's window, which leaves the
  // forward run complemented
  const int64_t f0 = rev ? 2 * p.l_pac - (r0 + rlen) : r0;
  for (int i = lane; i < rlen; i += 32) {
    const int b = base_fwd(p.pac, f0 + i);
    s.t[i] = (uint8_t)(rev ? 3 - b : b);
  }
  __syncwarp();

  // solve_record's loop over the plan's bands
  int last = kNeg, score = 0, band = 0;
  for (int k = 0; k < nb; ++k) {
    const int bk = d[4 + k];
    if (k > 0 && bk == band) break;   // the same pass: the loop ends here
    band = bk;
    score = band < 0 ? ungapped(s, smat, lq, lane)
                     : dp_pass(p, s, smat, lq, rlen, max(band, dlen), lane);
    if (k > 0 && score == last) break;
    if (k == nb - 1) break;
    last = score;
    if (!(score < thr)) break;
  }
  if (lane != 0) return;
  out[0] = score;
  if (band < 0) {
    out[1] = 1;
    out[2] = (lq << 4) | kOpM;
  } else {
    out[1] = walk(s, lq, rlen, max(band, dlen), p.cap, out + 2);
  }
}

}  // namespace k5

extern "C" int bmt_cigar_solve(const void* qs, const void* qoff,
                               const void* rb, const void* desc,
                               const void* pac, long long l_pac,
                               const void* mat, int o_del, int e_del,
                               int o_ins, int e_ins, int n, int cap,
                               int smem_warp, int warps, const void* tboff,
                               void* scratch, void* out, void* stream) {
  if (n <= 0) return 0;
  k5::Params p;
  p.qs = static_cast<const uint8_t*>(qs);
  p.qoff = static_cast<const int64_t*>(qoff);
  p.rb = static_cast<const int64_t*>(rb);
  p.desc = static_cast<const int32_t*>(desc);
  p.pac = static_cast<const uint32_t*>(pac);
  p.l_pac = l_pac;
  p.mat = static_cast<const int32_t*>(mat);
  p.o_del = o_del;
  p.e_del = e_del;
  p.o_ins = o_ins;
  p.e_ins = e_ins;
  p.n = n;
  p.cap = cap;
  p.smem_warp = smem_warp;
  p.tboff = static_cast<const int64_t*>(tboff);
  p.scratch = static_cast<uint8_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  const size_t shmem = (size_t)warps * smem_warp;
  cudaError_t err = cudaFuncSetAttribute(
      k5::cigar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + warps - 1) / warps;
  k5::cigar_kernel<<<grid, 32 * warps, shmem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* bmt_cigar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
