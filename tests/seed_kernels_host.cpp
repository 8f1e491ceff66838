// The seeding kernels' walks compiled as plain C++ for the CPU tests
// (tests/test_torch_seed_kernels.py): the functions of
// bwamem_tpu_torch/csrc/seed_forward.cu, seed_backward.cu and sa_lookup.cu
// (their CUDA parts sit behind __CUDACC__), driven by loops that stand in
// for the launches. S1's walks run on the lane-group form of
// csrc/fm_index.cuh: each row query is the sum of its G lanes' parts, as
// the kernel's shuffles sum them, finished and turned into the step by the
// kernel's own functions, and so do S3's re-seed walks (reseed_walk);
// S2's warps walk their 32 lanes in lockstep with the kernel's kill
// (backward_warps); S4's two kernels run their functions a tile of SMEMs
// and an occurrence at a time.
// Build: g++ -std=c++17 -O2 -shared -fPIC -I<csrc>.
#include <stdint.h>

#include <type_traits>

#include "sa_lookup.cu"
#include "seed_backward.cu"
#include "seed_forward.cu"

namespace {

uint32_t g_masks[33];

const uint32_t* masks() {
  for (int t = 0; t <= 32; ++t) g_masks[t] = fmi::plane_mask(t);
  return g_masks;
}

// An end's occ2 row query at BWT$ row i: the G lanes' parts summed, then
// finished (the kernel's reduce).
template <typename T>
fmi::Occ2Sums<fmi::Acc<T>> occ2_group(const fmi::FMConst& c,
                                      const int32_t* occ2, T i, int c1,
                                      int c2, const uint32_t* mk) {
  using U = fmi::Acc<T>;
  constexpr int G = fmi::kPairLanes, NW = 16 / G;
  int r;
  const int32_t* row = fmi::occ2_row(c, occ2, i, r);
  fmi::Occ2Sums<U> sum{0, 0, 0, 0};
  for (int q = 0; q < G; ++q) {
    uint32_t cw[NW], dw[NW];
    fmi::load_words<NW>(row + q * NW, cw);
    fmi::load_words<NW>(row + 16 + q * NW, dw);
    sum = sum + fmi::occ2_lane_part<G, U>(cw, dw, q, r, c1, c2, mk);
  }
  return fmi::occ2_finish<T, U>(c, i, c1, c2, sum);
}

// An end's occ row query for `code` at BWT$ row i on a lane pair.
template <typename T>
fmi::OccSums<fmi::Acc<T>> occ_group(const fmi::FMConst& c,
                                    const int32_t* occ, T i, int code) {
  using U = fmi::Acc<T>;
  int r;
  const int32_t* row = fmi::occ_row(c, occ, i, r);
  fmi::OccSums<U> sum{0, 0};
  for (int q = 0; q < 2; ++q) {
    uint32_t cw[2], bw[2];
    fmi::load_words<2>(row + 2 * q, cw);
    fmi::load_words<2>(row + 4 + 2 * q, bw);
    sum = sum + fmi::occ_lane_part<U>(cw, bw, q, r, code);
  }
  return sum;
}

// One walk of read b (r3: the round-3 automaton) as a group of the launch
// runs it: its trips (walk_trips), each trip's step from the two ends'
// group queries, its columns, then emit 0 to the end of its row.
template <typename T>
void walk(const fmi::FMConst& c, const fmi::FMPtrs& p,
          const seedfw::FwdArgs<T>& a, bool pairs, bool r3, int b,
          const uint32_t* mk) {
  using U = fmi::Acc<T>;
  const int len = a.lens[b];
  const int32_t* rd = a.reads + static_cast<int64_t>(b) * a.L;
  const int width = r3 ? a.L : a.NP;
  const int64_t o = static_cast<int64_t>(b) * width;
  const int trips = seedfw::walk_trips(len, a.L, pairs);
  seedfw::Walk<T> w{0, 0, 0, 0};
  for (int t = 0; t < trips; ++t) {
    if (pairs) {
      const int i = 2 * t;
      const int b1 = i < a.L ? rd[i] : 4, b2 = i + 1 < a.L ? rd[i + 1] : 4;
      const bool v1 = i < len && b1 < 4, v2 = i + 1 < len && b2 < 4;
      const int c1 = 3 - fmi::clamp_code(b1), c2 = 3 - fmi::clamp_code(b2);
      const auto lo = occ2_group<T>(c, p.occ2, w.l, c1, c2, mk);
      const auto hi = occ2_group<T>(c, p.occ2, static_cast<T>(w.l + w.s),
                                       c1, c2, mk);
      T k1, l1, s1, k2, l2, s2;
      fmi::ext2_from<T, U>(c, w.k, w.l, w.s, b1, b2, lo, hi, k1, l1, s1, k2,
                           l2, s2);
      seedfw::Col<T> eA, eB;
      if (r3)
        seedfw::r3_pair_trip<T>(c, a.min_len3, a.max_intv3, i, b1, b2, v1,
                                v2, k1, l1, s1, k2, l2, s2, w, eA, eB);
      else
        seedfw::r1_pair_trip<T>(c, a.min_seed_len, i, b1, b2, v1, v2, k1, l1,
                                s1, k2, l2, s2, w, eA, eB);
      if (i < width) seedfw::put_col(a, r3, o + i, eA);
      if (i + 1 < width) seedfw::put_col(a, r3, o + i + 1, eB);
    } else {
      const int i = t, base = i < a.L ? rd[i] : 4;
      const bool valid = i < len && base < 4;
      const int cc = 3 - fmi::clamp_code(base);
      const auto lo = occ_group<T>(c, p.occ, w.l, cc);
      const auto hi = occ_group<T>(c, p.occ, static_cast<T>(w.l + w.s), cc);
      T nk, nl, ns;
      fmi::ext1_from<T, U>(c, w.k, w.l, w.s, base, lo, hi, nk, nl, ns);
      seedfw::Col<T> e;
      if (r3)
        seedfw::r3_single_trip<T>(c, a.min_len3, a.max_intv3, i, base, valid,
                                  nk, nl, ns, w, e);
      else
        seedfw::r1_single_trip<T>(c, a.min_seed_len, i, base, valid, nk, nl,
                                  ns, w, e);
      if (i < width) seedfw::put_col(a, r3, o + i, e);
    }
  }
  for (int i = pairs ? 2 * trips : trips; i < width; ++i)
    (r3 ? a.e3 : a.emit)[o + i] = 0;
}

// Re-seed lane r's walk as its group runs it: its fill row zeroed (the
// warp's block), then its trips until it dies, each trip's step from the
// two ends' group queries, and its columns.
template <typename T>
void reseed_walk(const fmi::FMConst& c, const fmi::FMPtrs& p,
                 const seedfw::ReseedArgs<T>& a, bool pairs, int r,
                 const uint32_t* mk) {
  using U = fmi::Acc<T>;
  seedfw::ReseedWalk<T> w = seedfw::reseed_start<T>(c, a, r);
  const int64_t o = static_cast<int64_t>(r) * (a.L + 2);
  for (int j = 0; j < a.L + 2; ++j) a.fill[o + j] = 0;
  const int tmax = seedfw::reseed_trips(a.L, pairs);
  for (int t = 0; t < tmax && w.alive; ++t) {
    const int i = w.lx + seedfw::reseed_col(t, pairs);
    const int b1 = seedfw::reseed_base(a, w, i);
    const T hi_row = static_cast<T>(w.l + w.s);
    if (pairs) {
      const int b2 = seedfw::reseed_base(a, w, i + 1);
      const int c1 = 3 - fmi::clamp_code(b1), c2 = 3 - fmi::clamp_code(b2);
      const auto lo = occ2_group<T>(c, p.occ2, w.l, c1, c2, mk);
      const auto hi = occ2_group<T>(c, p.occ2, hi_row, c1, c2, mk);
      T k1, l1, s1, k2, l2, s2;
      fmi::ext2_from<T, U>(c, w.k, w.l, w.s, b1, b2, lo, hi, k1, l1, s1, k2,
                           l2, s2);
      seedfw::Col<T> eA, eB;
      seedfw::reseed_pair_trip<T>(a.min_seed_len, i, i < w.len && b1 < 4,
                                  i + 1 < w.len && b2 < 4, k1, l1, s1, k2,
                                  l2, s2, w, eA, eB);
      seedfw::put_reseed(a, o + i - w.lx, eA);
      seedfw::put_reseed(a, o + i - w.lx + 1, eB);
    } else {
      const int cc = 3 - fmi::clamp_code(b1);
      const auto lo = occ_group<T>(c, p.occ, w.l, cc);
      const auto hi = occ_group<T>(c, p.occ, hi_row, cc);
      T nk, nl, ns;
      fmi::ext1_from<T, U>(c, w.k, w.l, w.s, b1, lo, hi, nk, nl, ns);
      seedfw::Col<T> e;
      seedfw::reseed_single_trip<T>(a.min_seed_len, i, i < w.len && b1 < 4,
                                    nk, nl, ns, w, e);
      seedfw::put_reseed(a, o + i - w.lx, e);
    }
  }
}

template <typename T>
void forward(const fmi::FMConst& c, const fmi::FMPtrs& p,
             const seedfw::FwdArgs<T>& a, bool pairs) {
  const uint32_t* mk = masks();
  for (int b = 0; b < a.B; ++b) {
    walk<T>(c, p, a, pairs, false, b, mk);
    if (a.strategy) walk<T>(c, p, a, pairs, true, b, mk);
  }
}

// Mismatches of the lane-group queries against the one-thread ones at
// every BWT$ row of the index (every row offset r of every block), for
// every code pair; -1 if some row offset was not reached. occ2: the occ2
// pair query on its group against occ2_query; else the occ row query on a
// lane pair against rank1.
template <typename T>
long long check_rows(const fmi::FMConst& c, const fmi::FMPtrs& p,
                     int64_t n_rows, bool occ2) {
  using U = fmi::Acc<T>;
  const uint32_t* mk = masks();
  long long bad = 0;
  bool seen[128] = {};
  const int period = occ2 ? 128 : 64;
  for (int64_t i = 0; i < n_rows; ++i) {
    const T ti = static_cast<T>(i);
    int r;
    if (occ2) {
      fmi::occ2_row(c, p.occ2, ti, r);
      for (int c1 = 0; c1 < 4; ++c1)
        for (int c2 = 0; c2 < 4; ++c2) {
          const auto g = occ2_group<T>(c, p.occ2, ti, c1, c2, mk);
          const auto w = fmi::occ2_sums<T, U>(c, p.occ2, ti, c1, c2);
          bad += g.rc != w.rc || g.rs != w.rs || g.pc != w.pc ||
                 g.ps != w.ps;
        }
    } else {
      const int32_t* row = fmi::occ_row(c, p.occ, ti, r);
      uint32_t words[8];
      fmi::load_words<8>(row, words);
      for (int code = 0; code < 4; ++code) {
        const auto g = occ_group<T>(c, p.occ, ti, code);
        const auto w = fmi::occ_sums<T, U>(words, r, code);
        bad += g.eq != w.eq || g.gt != w.gt;
      }
    }
    seen[r] = true;
  }
  for (int r = 0; r < period; ++r)
    if (!seen[r]) return -1;
  return bad;
}

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
    forward<T>(c, *fm, a, pairs != 0);
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
    const uint32_t* mk = masks();
    for (int r = 0; r < R; ++r)
      reseed_walk<T>(c, *fm, a, pairs != 0, r, mk);
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

// bm_sa_tiles with tiles of `tile` SMEMs (0: the card's, salk::tile_of).
long long host_sa_tiles(long long n, long long tile) {
  return salk::tiles_of(n, tile > 0 ? tile : salk::tile_of(n));
}

// Same arguments as bm_sa_count, the stream taken by `tile` (as in
// host_sa_tiles): each tile's SMEMs in order, their counts (occ_count)
// scanned within the tile.
int host_sa_count(const void* s, const void* keep, long long n, int wide,
                  long long max_occ, void* loc, void* tot, long long tile) {
  if (tile <= 0) tile = salk::tile_of(n);
  int64_t* lp = static_cast<int64_t*>(loc);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  int64_t step;
  for (long long b = 0; b * tile < n; ++b) {
    int64_t run = 0;
    for (long long i = b * tile; i < n && i < (b + 1) * tile; ++i) {
      lp[i] = run;
      const int64_t si = wide ? static_cast<const int64_t*>(s)[i]
                              : static_cast<const int32_t*>(s)[i];
      run += salk::occ_count(si, kp[i] != 0, max_occ, step);
    }
    static_cast<int64_t*>(tot)[b] = run;
  }
  return 0;
}

// Same arguments as bm_sa_lookup, the stream taken by `tile` (as in
// host_sa_tiles): the tiles' first occurrences (the kernel's block scan),
// then each occurrence.
int host_sa_lookup(const fmi::FMPtrs* fm, const void* rid, const void* qbeg,
                   const void* qend, const void* k, const void* s,
                   long long n, int wide, int sa_intv, long long max_occ,
                   const void* loc, const void* tot, long long total,
                   void* read_id, void* qb_out, void* qe_out, void* rbeg,
                   void* n_occ, long long tile) {
  fmi::FMConst c;
  fmi::fill_const(c, *fm);
  if (tile <= 0) tile = salk::tile_of(n);
  const int nb = static_cast<int>(salk::tiles_of(n, tile));
  int64_t pre[salk::kMaxTiles];
  int64_t run = 0;
  for (int b = 0; b < nb; ++b) {
    pre[b] = run;
    run += static_cast<const int64_t*>(tot)[b];
  }
  auto go = [&](auto* kp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(kp)>>;
    salk::ExpandArgs<T> a{static_cast<const int32_t*>(rid),
                          static_cast<const int32_t*>(qbeg),
                          static_cast<const int32_t*>(qend), kp,
                          static_cast<const T*>(s), n, max_occ, tile, nb,
                          static_cast<const int64_t*>(loc),
                          static_cast<const int64_t*>(tot), total,
                          static_cast<int32_t*>(read_id),
                          static_cast<int32_t*>(qb_out),
                          static_cast<int32_t*>(qe_out),
                          static_cast<T*>(rbeg), static_cast<T*>(n_occ)};
    for (long long o = 0; o < total; ++o)
      salk::expand_one<T>(c, *fm, a, pre, sa_intv, o);
    return 0;
  };
  if (wide) return go(static_cast<const int64_t*>(k));
  return go(static_cast<const int32_t*>(k));
}

// The lane-group row queries against the one-thread ones on every BWT$
// row (n_rows of them): occ2 != 0, the occ2 pair query; else the occ row
// query. Returns the mismatches, -1 if a row offset was never reached.
long long host_check_rows(const fmi::FMPtrs* fm, long long n_rows, int wide,
                          int occ2) {
  fmi::FMConst c;
  fmi::fill_const(c, *fm);
  auto go = [&](auto t) -> long long {
    using T = decltype(t);
    return check_rows<T>(c, *fm, n_rows, occ2 != 0);
  };
  return wide ? go(int64_t{0}) : go(int32_t{0});
}

}  // extern "C"
