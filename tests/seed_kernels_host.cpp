// The seeding kernels' walks compiled as plain C++ for the CPU tests
// (tests/test_torch_seed_kernels.py): the per-thread functions of
// bwamem_tpu_torch/csrc/seed_forward.cu, seed_backward.cu and
// sa_lookup.cu (their CUDA parts sit behind __CUDACC__), driven by loops
// that stand in for the launches: one call per read, lane or row, and for
// seed_backward the warp's lockstep, lane by lane in groups of 32, on the
// kernel's own lane, step and kill functions.
// Build: g++ -std=c++17 -O2 -shared -fPIC -I<csrc>.
#include <stdint.h>

#include <type_traits>

#include "sa_lookup.cu"
#include "seed_backward.cu"
#include "seed_forward.cu"

namespace {

// The launch of seed_backward: each warp of 32 lanes in lockstep, a trip
// of every live lane, then each lane's kill test against the next one's
// state (what the kernel's shuffles bring), until no lane of it walks.
template <typename T>
void backward_warps(const fmi::FMConst& c, const fmi::FMPtrs& p,
                    const seedbw::BackArgs<T>& a) {
  for (int w0 = 0; w0 < a.P; w0 += 32) {
    int32_t qb[33] = {}, grp[33] = {};
    T kk[33] = {}, ss[33] = {}, fl[32];
    bool done[32], kill[32], ok[32];
    const int32_t* rd[32];
    for (int t = 0; t < 32; ++t) {
      done[t] = w0 + t >= a.P;
      if (!done[t])
        seedbw::load_lane<T>(a, w0 + t, qb[t], kk[t], ss[t], fl[t], grp[t],
                             rd[t]);
    }
    for (int t = 0; t < 32; ++t)
      kill[t] = seedbw::kill_pair(!done[t], w0 + t, a.P, t, grp[t],
                                  grp[t + 1]);
    for (int it = 0; it < a.L; ++it) {
      bool any = false;
      for (int t = 0; t < 32; ++t) any = any || !done[t];
      if (!any) break;
      for (int t = 0; t < 32; ++t)
        ok[t] = !done[t] &&
                seedbw::back_step<T>(c, p.occ, rd[t], fl[t], qb[t], kk[t],
                                     ss[t]);
      for (int t = 0; t < 32; ++t)
        done[t] = seedbw::lane_done<T>(ok[t], kill[t], qb[t], kk[t], ss[t],
                                       qb[t + 1], kk[t + 1], ss[t + 1]);
    }
    for (int t = 0; t < 32 && w0 + t < a.P; ++t) {
      a.qb_out[w0 + t] = qb[t];
      a.k_out[w0 + t] = kk[t];
      a.s_out[w0 + t] = ss[t];
    }
  }
}

}  // namespace

extern "C" {

// Same arguments as bm_seed_forward, without the stream.
int host_seed_forward(const fmi::FMPtrs* fm, const void* reads,
                      const void* lens, int B, int L, int NP, int wide,
                      int pairs, int min_seed_len, int strategy,
                      int min_len3, long long max_intv3, void* seg, void* k,
                      void* s, void* emit, void* x3, void* k3, void* s3,
                      void* e3) {
  fmi::FMConst c;
  fmi::fill_const(c, *fm);
  auto go = [&](auto* kp, auto* sp, auto* k3p, auto* s3p) {
    using T = std::remove_pointer_t<decltype(kp)>;
    seedfw::FwdArgs<T> a{static_cast<const int32_t*>(reads),
                         static_cast<const int32_t*>(lens), B, L, NP,
                         min_seed_len, strategy != 0, min_len3, max_intv3,
                         static_cast<int32_t*>(seg), kp, sp,
                         static_cast<uint8_t*>(emit),
                         static_cast<int32_t*>(x3), k3p, s3p,
                         static_cast<uint8_t*>(e3)};
    for (int b = 0; b < B; ++b) {
      if (pairs)
        seedfw::walk_pairs<T>(c, fm->occ2, a, b);
      else
        seedfw::walk_single<T>(c, fm->occ, a, b);
    }
    return 0;
  };
  if (wide)
    return go(static_cast<int64_t*>(k), static_cast<int64_t*>(s),
              static_cast<int64_t*>(k3), static_cast<int64_t*>(s3));
  return go(static_cast<int32_t*>(k), static_cast<int32_t*>(s),
            static_cast<int32_t*>(k3), static_cast<int32_t*>(s3));
}

// Same arguments as bm_seed_reseed_forward, without the stream.
int host_seed_reseed_forward(const fmi::FMPtrs* fm, const void* reads,
                             const void* lens, int B, int L,
                             const void* lrid, const void* lx,
                             const void* lfloor, int R, int wide, int pairs,
                             int min_seed_len, void* kb, void* sb, void* eb,
                             void* fill) {
  fmi::FMConst c;
  fmi::fill_const(c, *fm);
  auto go = [&](auto* flp, auto* kp, auto* sp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(flp)>>;
    seedfw::ReseedArgs<T> a{static_cast<const int32_t*>(reads),
                            static_cast<const int32_t*>(lens),
                            static_cast<const int32_t*>(lrid),
                            static_cast<const int32_t*>(lx), flp, B, L, R,
                            min_seed_len, kp, sp, static_cast<int32_t*>(eb),
                            static_cast<uint8_t*>(fill)};
    for (int r = 0; r < R; ++r)
      seedfw::walk_reseed<T>(c, fm->occ, fm->occ2, pairs != 0, a, r);
    return 0;
  };
  if (wide)
    return go(static_cast<const int64_t*>(lfloor), static_cast<int64_t*>(kb),
              static_cast<int64_t*>(sb));
  return go(static_cast<const int32_t*>(lfloor), static_cast<int32_t*>(kb),
            static_cast<int32_t*>(sb));
}

// Same arguments as bm_seed_backward, without the stream.
int host_seed_backward(const fmi::FMPtrs* fm, const void* reads, int B,
                       int L, const void* rid, const void* qbeg,
                       const void* k, const void* s, const void* floor,
                       const void* group, int P, int wide, void* qb_out,
                       void* k_out, void* s_out) {
  fmi::FMConst c;
  fmi::fill_const(c, *fm);
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
    backward_warps<T>(c, *fm, a);
    return 0;
  };
  if (wide) return go(static_cast<const int64_t*>(k));
  return go(static_cast<const int32_t*>(k));
}

// Same arguments as bm_sa_lookup, without the stream.
int host_sa_lookup(const fmi::FMPtrs* fm, const void* rows, long long n,
                   int wide, int sa_intv, void* out) {
  fmi::FMConst c;
  fmi::fill_const(c, *fm);
  for (long long i = 0; i < n; ++i) {
    if (wide)
      static_cast<int64_t*>(out)[i] = fmi::sa_lookup_one<int64_t>(
          c, *fm, static_cast<const int64_t*>(rows)[i], sa_intv);
    else
      static_cast<int32_t*>(out)[i] = fmi::sa_lookup_one<int32_t>(
          c, *fm, static_cast<const int32_t*>(rows)[i], sa_intv);
  }
  return 0;
}

}  // extern "C"
