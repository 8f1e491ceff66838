// The finalize split in three steps, for a CIGAR solve on the card:
//
//   plan    mark primaries, pair the mates and choose the records, as the
//           native finalize does, and list every gen_cigar call the SAM
//           needs as a job (read, region) with its band sequence;
//   solve   the jobs' scores and CIGARs (K5, csrc/cigar_kernel.cu, or its
//           plain version); a job the solve did not take is solved here by
//           the host's gen_cigar;
//   render  NM/MD from each CIGAR and the reference window, then the SAM
//           text, in the native finalize's order.
//
// The plan follows bm_finalize_se_batch / bm_finalize_pe_batch
// (native/samemit.cpp) step for step with each solve_into call replaced by
// a job, and the render replays the records that plan chose through the
// same helpers (reg2aln_post, aln2sam), which are compiled in from that
// file unchanged: the SAM is the native finalize's byte for byte. No
// decision of the plan reads a solve's result; the one that does in the
// native code (nopair's proper-pair flag compares the two representative
// records' contigs) is taken at render.
//
// The pairs' regions come as lists of AlnReg objects; bmt_flatten_regs
// reads them into the plan's columns in one pass through the C API (called
// holding the GIL), where the per-object Python loop of the native loader
// cost ~1.3 us a region, ~10 regions a read on a repeat-rich genome.
//
// Build: g++ -std=c++17 -O3 -shared -fPIC -I<python include>
//        -I<repo>/native finalize_split.cpp <repo>/native/ksw.cpp

#include <Python.h>

#include "samemit.cpp"

namespace {

struct Job {     // one gen_cigar call: solve_record's inputs
  int64_t read;  // index of the read in the slice
  Reg r;         // the region as the native finalize's solve_into saw it
};

struct Rec {      // one record (Aln) whose solve is deferred
  int32_t job;    // -1: the unmapped record (no solve)
  int32_t flag;   // flags the emitter set, without the read's extra flag
  int32_t mapq;
  bool sub_neg;   // the emitter set sub = -1 after the solve
  int32_t xa;     // its XA string's index in the read's list, -1: none
};

struct ReadPlan {     // one read's records
  int64_t b;          // index of the read in the slice
  int32_t n_regs;     // size of its XA string list
  size_t xa0, xa1;    // its XA entries: [xa0, xa1) of Plan::xa
  size_t rec0, rec1;  // its records: [rec0, rec1) of Plan::recs
};

struct PairPlan {
  bool nopair;
  ReadPlan rd[2];
  Rec h[2];      // nopair: the representative records (each other's mate)
  bool pp_cand;  // nopair: the proper-pair test bar the contigs' equality
};

struct Plan {
  Opt opt;
  IdxRefs ix;
  // the reads (the caller keeps these arrays alive until the plan is freed)
  const uint8_t* qstream;
  const int64_t *q_off, *name_off, *qual_off, *com_off;
  const int32_t* q_len;
  const char *names, *quals, *comments, *rg;
  int32_t rg_len;
  bool paired;
  std::vector<Job> jobs;
  std::vector<std::pair<int32_t, int32_t>> xa;  // (primary index, job)
  std::vector<Rec> recs;
  std::vector<ReadPlan> reads;  // SE
  std::vector<PairPlan> pairs;  // PE

  ReadIn read_in(int64_t b) const {
    return load_read(b, qstream, q_off, q_len, names, name_off, quals,
                     qual_off, comments, com_off);
  }
  int32_t add_job(int64_t b, const Reg& r) {
    jobs.push_back(Job{b, r});
    return (int32_t)jobs.size() - 1;
  }
};

// gen_xa (native/samemit.cpp) with each solve a job
void plan_xa(Plan* pl, int64_t b, std::vector<Reg>& regs,
             const std::vector<int>& ord, ReadPlan* rp) {
  const Opt& opt = pl->opt;
  const size_t n = regs.size();
  rp->n_regs = (int32_t)n;
  rp->xa0 = rp->xa1 = pl->xa.size();
  if (opt.flag_all || n == 0) return;
  auto pri_idx = [&](size_t i) -> int32_t {
    const Reg& r = regs[ord[i]];
    int32_t k = r.secondary_all;
    if (k >= 0 && (double)r.score >= regs[ord[k]].score * opt.XA_drop_ratio)
      return k;
    return -1;
  };
  std::vector<int32_t> cnt(n, 0);
  std::vector<char> has_alt(n, 0);
  int32_t tot = 0;
  for (size_t i = 0; i < n; ++i) {
    int32_t r = pri_idx(i);
    if (r >= 0) {
      ++cnt[r];
      ++tot;
      if (regs[ord[i]].is_alt) has_alt[r] = 1;
    }
  }
  if (!tot) return;
  for (size_t i = 0; i < n; ++i) {
    int32_t r = pri_idx(i);
    if (r < 0) continue;
    if (cnt[r] > opt.max_XA_hits_alt ||
        (!has_alt[r] && cnt[r] > opt.max_XA_hits))
      continue;
    pl->xa.emplace_back(r, pl->add_job(b, regs[ord[i]]));
  }
  rp->xa1 = pl->xa.size();
}

// reg2sam_emit (native/samemit.cpp) up to the solves: the read's records
void plan_read(Plan* pl, int64_t b, std::vector<Reg>& regs,
               const std::vector<int>& ord, ReadPlan* rp) {
  const Opt& opt = pl->opt;
  rp->b = b;
  plan_xa(pl, b, regs, ord, rp);
  rp->rec0 = pl->recs.size();
  const size_t n = regs.size();
  for (size_t i = 0; i < n; ++i) {
    const Reg& p = regs[ord[i]];
    if (p.score < opt.T) continue;
    if (p.secondary >= 0 && (p.is_alt || !opt.flag_all)) continue;
    if (p.secondary >= 0 && p.secondary < INT_MAX_SENTINEL &&
        (double)p.score < regs[ord[p.secondary]].score * opt.drop_ratio)
      continue;
    Rec q{};
    q.mapq = p.secondary < 0 ? approx_mapq(opt, p) : 0;
    if (p.secondary >= 0) q.flag |= 0x100;
    q.job = pl->add_job(b, p);
    q.xa = (int32_t)i;
    q.sub_neg = p.secondary >= 0;
    const bool first = pl->recs.size() == rp->rec0;
    if (!first && p.secondary < 0)
      q.flag |= opt.flag_no_multi ? 0x10000 : 0x800;
    if (!first && !p.is_alt && q.mapq > pl->recs[rp->rec0].mapq)
      q.mapq = pl->recs[rp->rec0].mapq;
    pl->recs.push_back(q);
  }
  if (pl->recs.size() == rp->rec0)
    pl->recs.push_back(Rec{-1, 0, 0, false, -1});  // the unmapped record
  rp->rec1 = pl->recs.size();
}

// ------------------------------------------------------------- render --

// NM and MD of a solved CIGAR against the reference window, as gen_cigar
// computes them after its DP (native/reg2aln_core.h)
void nm_md(const IdxRefs& ix, const uint8_t* query, int32_t l_query,
           int64_t rb, int64_t re, GenOut* out) {
  const int64_t rlen = re - rb;
  const bool is_rev = rb >= ix.l_pac;
  std::vector<uint8_t> rseq((size_t)rlen);
  if (!is_rev) {
    for (int64_t p = rb; p < re; ++p)
      rseq[(size_t)(p - rb)] = (uint8_t)bm_core::base_fwd(ix.pac, p);
  } else {
    for (int64_t p = rb; p < re; ++p)
      rseq[(size_t)(p - rb)] =
          (uint8_t)(3 - bm_core::base_fwd(ix.pac, 2 * ix.l_pac - 1 - p));
    for (int64_t i = 0, j = rlen - 1; i < j; ++i, --j)
      std::swap(rseq[(size_t)i], rseq[(size_t)j]);
  }
  std::vector<uint8_t> q((size_t)l_query);
  if (!is_rev)
    std::memcpy(q.data(), query, (size_t)l_query);
  else
    for (int32_t j = 0; j < l_query; ++j) q[j] = query[l_query - 1 - j];

  static const char FWD[5] = {'A', 'C', 'G', 'T', 'N'};
  static const char REV[5] = {'T', 'G', 'C', 'A', 'N'};
  const char* int2base = is_rev ? REV : FWD;
  char buf[16];
  int64_t x = 0, y = 0;
  int32_t u = 0, n_mm = 0, n_gap = 0;
  const size_t nc = out->cig.size();
  for (size_t k = 0; k < nc; ++k) {
    uint32_t c = out->cig[k];
    int32_t op = (int32_t)(c & 0xF), ln = (int32_t)(c >> 4);
    if (op == bm_core::OP_M) {
      int32_t prev = -1, last = -1, cnt = 0;
      for (int32_t i = 0; i < ln; ++i) {
        if (q[(size_t)(x + i)] != rseq[(size_t)(y + i)]) {
          int len = std::snprintf(buf, sizeof buf, "%d", u + i - prev - 1);
          out->md.append(buf, (size_t)len);
          out->md.push_back(int2base[rseq[(size_t)(y + i)]]);
          prev = i;
          u = 0;
          last = i;
          ++cnt;
        }
      }
      n_mm += cnt;
      if (cnt)
        u = ln - 1 - last;
      else
        u += ln;
      x += ln;
      y += ln;
    } else if (op == bm_core::OP_D) {
      if (k > 0 && k + 1 < nc) {
        int len = std::snprintf(buf, sizeof buf, "%d", u);
        out->md.append(buf, (size_t)len);
        out->md.push_back('^');
        for (int32_t i = 0; i < ln; ++i)
          out->md.push_back(int2base[rseq[(size_t)(y + i)]]);
        u = 0;
        n_gap += ln;
      }
      y += ln;
    } else if (op == bm_core::OP_I) {
      x += ln;
      n_gap += ln;
    }
  }
  int len = std::snprintf(buf, sizeof buf, "%d", u);
  out->md.append(buf, (size_t)len);
  out->nm = n_mm + n_gap;
}

struct Solved {  // the solve step's rows: score, n_ops (< 0: not solved), ops
  const int32_t* res;
  int32_t stride;
};

// solve_into (native/samemit.cpp) with the job's (score, CIGAR) from the
// solve step, or from the host's gen_cigar where the solve did not take it
void finish_job(const Plan& pl, const Solved& sv, int32_t job, Aln* a) {
  const Job& jb = pl.jobs[(size_t)job];
  const Reg& r = jb.r;
  const ReadIn rd = pl.read_in(jb.read);
  const Opt& opt = pl.opt;
  GenOut g;
  const int32_t* row = sv.res + (size_t)job * (size_t)sv.stride;
  if (row[1] < 0) {
    solve_record(pl.ix.pac, pl.ix.l_pac, pl.ix.mat, opt.o_del, opt.e_del,
                 opt.o_ins, opt.e_ins, opt.a, opt.w, rd.seq + r.qb,
                 r.qe - r.qb, r.rb, r.re, r.truesc, r.w, &g);
  } else {
    g.score = row[0];
    g.cig.assign((const uint32_t*)row + 2, (const uint32_t*)row + 2 + row[1]);
    nm_md(pl.ix, rd.seq + r.qb, r.qe - r.qb, r.rb, r.re, &g);
  }
  reg2aln_post(r, rd.lq, pl.ix, &g, a);
}

Aln rec_aln(const Plan& pl, const Solved& sv, const Rec& rc,
            const std::vector<std::string>& xa, int32_t extra) {
  Aln q;
  q.mapq = rc.mapq;
  q.flag = rc.flag;
  if (rc.job >= 0) {
    finish_job(pl, sv, rc.job, &q);
  } else {
    q.score = 0;
    q.sub = -1;
  }
  if (rc.xa >= 0 && (size_t)rc.xa < xa.size()) q.XA = xa[(size_t)rc.xa];
  q.flag |= extra;
  if (rc.sub_neg) q.sub = -1;
  return q;
}

// the XA strings of gen_xa from the read's solved XA jobs
void render_xa(const Plan& pl, const Solved& sv, const ReadPlan& rp,
               std::vector<std::string>* xa) {
  const IdxRefs& ix = pl.ix;
  xa->assign((size_t)rp.n_regs, std::string());
  char tmp[64];
  for (size_t e = rp.xa0; e < rp.xa1; ++e) {
    Aln t;
    finish_job(pl, sv, pl.xa[e].second, &t);
    std::string& dst = (*xa)[(size_t)pl.xa[e].first];
    dst.append(ix.ref_names + ix.rname_off[t.rid],
               (size_t)(ix.rname_off[t.rid + 1] - ix.rname_off[t.rid]));
    dst.push_back(',');
    dst.push_back(t.is_rev ? '-' : '+');
    int nn = std::snprintf(tmp, sizeof tmp, "%lld,", (long long)(t.pos + 1));
    dst.append(tmp, (size_t)nn);
    append_cigar_str(&dst, t.cigar);
    nn = std::snprintf(tmp, sizeof tmp, ",%d;", t.NM);
    dst.append(tmp, (size_t)nn);
  }
}

void read_alns(const Plan& pl, const Solved& sv, const ReadPlan& rp,
               int32_t extra, std::vector<Aln>* alns) {
  std::vector<std::string> xa;
  render_xa(pl, sv, rp, &xa);
  alns->clear();
  for (size_t k = rp.rec0; k < rp.rec1; ++k)
    alns->push_back(rec_aln(pl, sv, pl.recs[k], xa, extra));
}

void emit_read(const Plan& pl, const ReadPlan& rp,
               const std::vector<Aln>& alns, const Aln* mate, Out* o) {
  const ReadIn rd = pl.read_in(rp.b);
  for (size_t w = 0; w < alns.size(); ++w)
    aln2sam(pl.opt, pl.ix, rd, pl.rg, pl.rg_len, alns, w, mate, o);
}

}  // namespace

extern "C" {

void* bmt_plan_se(
    const uint32_t* pac, int64_t l_pac, const int8_t* mat,
    const int64_t* ann_off, int32_t n_ref, const char* ref_names,
    const int64_t* rname_off, const char* annos, const int64_t* anno_off,
    const double* opt_d, const int32_t* opt_i,
    int64_t n_reads, int64_t read_id0, const int64_t* reg_off,
    const uint8_t* qstream, const int64_t* q_off, const int32_t* q_len,
    const char* names, const int64_t* name_off, const char* quals,
    const int64_t* qual_off, const char* comments, const int64_t* com_off,
    const char* rg, int32_t rg_len,
    const int64_t* rb, const int64_t* re, const int32_t* qb,
    const int32_t* qe, const int32_t* score, const int32_t* truesc,
    const int32_t* sub, const int32_t* csub, const int32_t* arw,
    const int32_t* seedcov, const int32_t* rid, const int8_t* is_alt,
    const double* frac) {
  Plan* pl = new Plan();
  int32_t opt_i_pe[18];
  std::memcpy(opt_i_pe, opt_i, 16 * sizeof(int32_t));
  opt_i_pe[16] = opt_i_pe[17] = 0;
  load_opt(opt_d, opt_i_pe, &pl->opt);
  pl->ix = IdxRefs{pac, l_pac, mat, ann_off, n_ref, ref_names, rname_off,
                   annos, anno_off};
  pl->qstream = qstream;
  pl->q_off = q_off;
  pl->q_len = q_len;
  pl->names = names;
  pl->name_off = name_off;
  pl->quals = quals;
  pl->qual_off = qual_off;
  pl->comments = comments;
  pl->com_off = com_off;
  pl->rg = rg;
  pl->rg_len = rg_len;
  pl->paired = false;
  RegArrays ra{rb, re, qb, qe, score, truesc, sub, csub, arw, seedcov,
               rid, is_alt, frac};
  std::vector<Reg> regs;
  pl->reads.resize((size_t)n_reads);
  for (int64_t b = 0; b < n_reads; ++b) {
    load_regs(ra, reg_off[b], reg_off[b + 1], &regs);
    int n_pri = 0;
    std::vector<int> ord = mark_primary(pl->opt, regs, read_id0 + b, &n_pri);
    plan_read(pl, b, regs, ord, &pl->reads[(size_t)b]);
  }
  return pl;
}

void* bmt_plan_pe(
    const uint32_t* pac, int64_t l_pac, const int8_t* mat,
    const int64_t* ann_off, int32_t n_ref, const char* ref_names,
    const int64_t* rname_off, const char* annos, const int64_t* anno_off,
    const double* opt_d, const int32_t* opt_i,
    const int32_t* pes_i, const double* pes_d,
    int64_t n_pairs, int64_t pair_id0, const int64_t* reg_off,
    const uint8_t* qstream, const int64_t* q_off, const int32_t* q_len,
    const char* names, const int64_t* name_off, const char* quals,
    const int64_t* qual_off, const char* comments, const int64_t* com_off,
    const char* rg, int32_t rg_len,
    const int64_t* rb, const int64_t* re, const int32_t* qb,
    const int32_t* qe, const int32_t* score, const int32_t* truesc,
    const int32_t* sub, const int32_t* csub, const int32_t* arw,
    const int32_t* seedcov, const int32_t* rid, const int8_t* is_alt,
    const double* frac) {
  Plan* pl = new Plan();
  load_opt(opt_d, opt_i, &pl->opt);
  const Opt& opt = pl->opt;
  pl->ix = IdxRefs{pac, l_pac, mat, ann_off, n_ref, ref_names, rname_off,
                   annos, anno_off};
  const IdxRefs& ix = pl->ix;
  pl->qstream = qstream;
  pl->q_off = q_off;
  pl->q_len = q_len;
  pl->names = names;
  pl->name_off = name_off;
  pl->quals = quals;
  pl->qual_off = qual_off;
  pl->comments = comments;
  pl->com_off = com_off;
  pl->rg = rg;
  pl->rg_len = rg_len;
  pl->paired = true;
  RegArrays ra{rb, re, qb, qe, score, truesc, sub, csub, arw, seedcov,
               rid, is_alt, frac};
  PES pes[4];
  for (int d = 0; d < 4; ++d) {
    pes[d].failed = pes_i[d * 3];
    pes[d].low = pes_i[d * 3 + 1];
    pes[d].high = pes_i[d * 3 + 2];
    pes[d].avg = pes_d[d * 2];
    pes[d].std = pes_d[d * 2 + 1];
  }

  std::vector<Reg> regs2[2];
  std::vector<int> ord2[2];
  pl->pairs.resize((size_t)n_pairs);
  for (int64_t pi = 0; pi < n_pairs; ++pi) {
    PairPlan& pp = pl->pairs[(size_t)pi];
    const int64_t id_ = pair_id0 + pi;
    int n_pri[2] = {0, 0};
    for (int i = 0; i < 2; ++i) {
      int64_t b = (pi << 1) | i;
      load_regs(ra, reg_off[b], reg_off[b + 1], &regs2[i]);
      ord2[i] = mark_primary(opt, regs2[i], (id_ << 1) | i, &n_pri[i]);
    }
    auto marked = [&](int i, int j) -> Reg& {
      return regs2[i][ord2[i][(size_t)j]];
    };

    // pair vs nopair, as bm_finalize_pe_batch decides
    bool nopair = opt.flag_nopairing || !(n_pri[0] && n_pri[1]);
    int32_t o_sc = 0, subo = 0, n_sub = 0;
    int z[2] = {0, 0};
    if (!nopair) {
      mem_pair(opt, ix, pes, regs2, ord2, n_pri, id_, &o_sc, &subo,
               &n_sub, z);
      if (o_sc <= 0) nopair = true;
    }
    if (!nopair) {
      for (int i = 0; i < 2 && !nopair; ++i)
        for (int j = 1; j < n_pri[i]; ++j)
          if (marked(i, j).secondary < 0 && marked(i, j).score >= opt.T) {
            nopair = true;
            break;
          }
    }
    pp.nopair = nopair;

    if (nopair) {
      for (int i = 0; i < 2; ++i) {
        int which = -1;
        const size_t n = regs2[i].size();
        if (n) {
          if (marked(i, 0).score >= opt.T)
            which = 0;
          else if ((size_t)n_pri[i] < n &&
                   marked(i, n_pri[i]).score >= opt.T)
            which = n_pri[i];
        }
        Rec& h = pp.h[i];
        h = Rec{-1, 0, 0, false, -1};
        if (which >= 0) {
          const Reg& p = marked(i, which);
          h.mapq = p.secondary < 0 ? approx_mapq(opt, p) : 0;
          if (p.secondary >= 0) h.flag |= 0x100;
          h.job = pl->add_job((pi << 1) | i, p);
        }
      }
      pp.pp_cand = false;
      if (!opt.flag_nopairing && !regs2[0].empty() && !regs2[1].empty()) {
        int d;
        int64_t dist;
        infer_dir(l_pac, marked(0, 0).rb, marked(1, 0).rb, &d, &dist);
        pp.pp_cand =
            !pes[d].failed && pes[d].low <= dist && dist <= pes[d].high;
      }
      for (int i = 0; i < 2; ++i)
        plan_read(pl, (pi << 1) | i, regs2[i], ord2[i], &pp.rd[i]);
      continue;
    }

    // paired mode (reference: src/bwamem_pair.c:300-397)
    int32_t extra_flag = 1;
    int32_t score_un =
        marked(0, 0).score + marked(1, 0).score - opt.pen_unpaired;
    if (score_un > subo) subo = score_un;
    int32_t q_pe = raw_mapq(o_sc - subo, opt.a);
    if (n_sub > 0)
      q_pe -= (int32_t)(4.343 * std::log((double)n_sub + 1.0) + 0.499);
    if (q_pe < 0) q_pe = 0;
    if (q_pe > 60) q_pe = 60;
    q_pe = (int32_t)(q_pe * (1.0 - 0.5 * (marked(0, 0).frac_rep +
                                          marked(1, 0).frac_rep)) +
                     0.499);
    int32_t q_se[2] = {0, 0};
    if (o_sc > score_un) {
      for (int i = 0; i < 2; ++i) {
        Reg& c = marked(i, z[i]);
        if (c.secondary >= 0) {
          c.sub = marked(i, c.secondary).score;
          c.secondary = -2;
        }
        q_se[i] = approx_mapq(opt, c);
      }
      for (int i = 0; i < 2; ++i) {
        const Reg& c = marked(i, z[i]);
        if (q_se[i] <= q_pe)
          q_se[i] = q_pe < q_se[i] + 40 ? q_pe : q_se[i] + 40;
        q_se[i] = std::min(q_se[i], raw_mapq(c.score - c.csub, opt.a));
      }
      extra_flag |= 2;
    } else {
      z[0] = z[1] = 0;
      q_se[0] = approx_mapq(opt, marked(0, 0));
      q_se[1] = approx_mapq(opt, marked(1, 0));
    }
    for (int i = 0; i < 2; ++i) {
      int32_t k = marked(i, z[i]).secondary_all;
      if (k >= 0 && k < n_pri[i]) {
        for (size_t jj = 0; jj < regs2[i].size(); ++jj) {
          Reg& rj = regs2[i][ord2[i][jj]];
          if (rj.secondary_all == k || (int32_t)jj == k)
            rj.secondary_all = z[i];
        }
        marked(i, z[i]).secondary_all = -1;
      }
    }
    for (int i = 0; i < 2; ++i) {
      pp.rd[i].b = (pi << 1) | i;
      plan_xa(pl, pp.rd[i].b, regs2[i], ord2[i], &pp.rd[i]);
    }
    for (int i = 0; i < 2; ++i) {
      const Reg& c = marked(i, z[i]);
      ReadPlan& rp = pp.rd[i];
      rp.rec0 = pl->recs.size();
      Rec h{};
      if (c.secondary >= 0) h.flag |= 0x100;
      h.job = pl->add_job(rp.b, c);
      h.mapq = q_se[i];
      h.flag |= (0x40 << i) | extra_flag;
      h.xa = z[i];
      pl->recs.push_back(h);
      const size_t n = regs2[i].size();
      if ((size_t)n_pri[i] < n) {
        const Reg& pr = marked(i, n_pri[i]);
        if (pr.score >= opt.T && pr.secondary < 0 && pr.is_alt) {
          Rec gg{};
          gg.mapq = pr.secondary < 0 ? approx_mapq(opt, pr) : 0;
          gg.job = pl->add_job(rp.b, pr);
          gg.flag |= 0x800 | (0x40 << i) | extra_flag;
          gg.xa = n_pri[i];
          pl->recs.push_back(gg);
        }
      }
      rp.rec1 = pl->recs.size();
    }
  }
  return pl;
}

int64_t bmt_plan_n_jobs(const void* h) {
  return (int64_t)static_cast<const Plan*>(h)->jobs.size();
}

// Each job's descriptor for the solve step: the query slice's offset in
// qstream, the window's start (doubled coordinates) and 8 int32s: query
// length, window length, the retry loop's score threshold (truesc - a),
// the number of gen_cigar calls the loop may make (0: a window gen_cigar
// refuses, left to the host) and the band of each call (-1: the ungapped
// case of gen_cigar), then the largest band. The bands are those
// solve_record's loop (native/reg2aln_core.h) passes to bm_ksw_global.
void bmt_plan_jobs(const void* h, int64_t* qoff, int64_t* rb_out,
                   int32_t* desc) {
  const Plan* pl = static_cast<const Plan*>(h);
  const Opt& opt = pl->opt;
  const int64_t l_pac = pl->ix.l_pac;
  const int32_t am = pl->ix.mat[0];
  const int32_t w_cap = opt.w << 2;
  for (size_t k = 0; k < pl->jobs.size(); ++k) {
    const Job& jb = pl->jobs[k];
    const Reg& r = jb.r;
    const int32_t lq = r.qe - r.qb;
    const int64_t rlen = r.re - r.rb;
    int32_t* d = desc + 8 * k;
    qoff[k] = pl->q_off[jb.read] + r.qb;
    rb_out[k] = r.rb;
    d[0] = lq;
    d[1] = (int32_t)rlen;
    d[2] = r.truesc - opt.a;
    d[3] = 0;
    d[4] = d[5] = d[6] = d[7] = -1;
    if (lq <= 0 || r.rb >= r.re || (r.rb < l_pac && l_pac < r.re) ||
        rlen > (1 << 30))
      continue;
    int32_t w2 = bm_core::infer_bw(lq, (int32_t)rlen, r.truesc, opt.a,
                                   opt.o_del, opt.e_del);
    int32_t w2b = bm_core::infer_bw(lq, (int32_t)rlen, r.truesc, opt.a,
                                    opt.o_ins, opt.e_ins);
    if (w2b > w2) w2 = w2b;
    if (w2 > opt.w) w2 = w2 < r.w ? w2 : r.w;
    // gen_cigar's band for each call of the loop
    int32_t max_ins = (int32_t)((double)(((lq + 1) >> 1) * am - opt.o_ins) /
                                    opt.e_ins + 1.0);
    int32_t max_del = (int32_t)((double)(((lq + 1) >> 1) * am - opt.o_del) /
                                    opt.e_del + 1.0);
    int32_t max_gap = max_ins > max_del ? max_ins : max_del;
    if (max_gap < 1) max_gap = 1;
    const int64_t dl = rlen > lq ? rlen - lq : lq - rlen;
    int32_t nb = 0;
    for (;;) {
      w2 = w2 < w_cap ? w2 : w_cap;
      int32_t band;
      if ((int64_t)lq == rlen && w2 == 0) {
        band = -1;
      } else {
        band = (int32_t)((max_gap + dl + 1) >> 1);
        if (band > w2) band = w2;
        if (band < (int32_t)dl + 3) band = (int32_t)dl + 3;
      }
      d[4 + nb] = band;
      if (band > d[7]) d[7] = band;
      ++nb;
      if (w2 == w_cap || nb == 3) break;
      w2 <<= 1;
    }
    d[3] = nb;
  }
}

// The SAM text from the solve step's rows (job k's row at res + k * stride:
// score, number of CIGAR ops or < 0 where the solve did not take the job,
// the ops as len << 4 | op). Returns 0, or 1 when out_cap is too small (the
// caller grows the buffer and renders again).
int bmt_render(const void* h, const int32_t* res, int32_t stride,
               char* out_buf, int64_t out_cap, int64_t* out_len) {
  const Plan& pl = *static_cast<const Plan*>(h);
  const Solved sv{res, stride};
  Out o{out_buf, out_cap};
  std::vector<Aln> alns, aa[2];
  if (!pl.paired) {
    for (const ReadPlan& rp : pl.reads) {
      read_alns(pl, sv, rp, 0, &alns);
      emit_read(pl, rp, alns, nullptr, &o);
      if (o.overflow) return 1;
    }
  } else {
    for (const PairPlan& pp : pl.pairs) {
      if (pp.nopair) {
        Aln hh[2];
        for (int i = 0; i < 2; ++i) {
          const Rec& rc = pp.h[i];
          hh[i].mapq = rc.mapq;
          hh[i].flag = rc.flag;
          if (rc.job >= 0) {
            finish_job(pl, sv, rc.job, &hh[i]);
          } else {
            hh[i].score = 0;
            hh[i].sub = -1;
          }
        }
        int32_t extra_flag = 1;
        if (pp.pp_cand && hh[0].rid == hh[1].rid && hh[0].rid >= 0)
          extra_flag |= 2;
        for (int i = 0; i < 2; ++i) {
          read_alns(pl, sv, pp.rd[i], (i ? 0x81 : 0x41) | extra_flag, &alns);
          emit_read(pl, pp.rd[i], alns, &hh[1 - i], &o);
        }
      } else {
        for (int i = 0; i < 2; ++i)
          read_alns(pl, sv, pp.rd[i], 0, &aa[i]);
        for (int i = 0; i < 2; ++i)
          emit_read(pl, pp.rd[i], aa[i], &aa[1 - i][0], &o);
      }
      if (o.overflow) return 1;
    }
  }
  *out_len = o.len;
  return 0;
}

void bmt_plan_free(void* h) { delete static_cast<Plan*>(h); }

// The columns of the native loader's _reg_arrays from `per_read`, a list
// of lists of AlnReg, n_regs regions in all (the caller has sized the
// columns). Returns 0, or -1 with a Python exception set.
int bmt_flatten_regs(PyObject* per_read, int64_t n_regs, int64_t* rb,
                     int64_t* re, int32_t* qb, int32_t* qe, int32_t* score,
                     int32_t* truesc, int32_t* sub, int32_t* csub,
                     int32_t* arw, int32_t* seedcov, int32_t* rid,
                     int8_t* is_alt, double* frac) {
  static const char* kNames[] = {"rb",   "re",      "qb",  "qe",
                                 "score", "truesc", "sub", "csub",
                                 "w",    "seedcov", "rid", "is_alt",
                                 "frac_rep"};
  static PyObject* names[13] = {nullptr};
  if (!names[0])
    for (int c = 0; c < 13; ++c) {
      names[c] = PyUnicode_InternFromString(kNames[c]);
      if (!names[c]) return -1;
    }
  int32_t* i32[9] = {qb, qe, score, truesc, sub, csub, arw, seedcov, rid};
  PyObject* reads = PySequence_Fast(per_read, "per_read: a sequence");
  if (!reads) return -1;
  int64_t k = 0;
  int rc = 0;
  const Py_ssize_t n_reads = PySequence_Fast_GET_SIZE(reads);
  for (Py_ssize_t b = 0; b < n_reads && rc == 0; ++b) {
    PyObject* regs = PySequence_Fast(PySequence_Fast_GET_ITEM(reads, b),
                                     "a read's regions: a sequence");
    if (!regs) {
      rc = -1;
      break;
    }
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(regs);
    for (Py_ssize_t j = 0; j < n && rc == 0; ++j, ++k) {
      if (k >= n_regs) {
        PyErr_SetString(PyExc_ValueError, "more regions than n_regs");
        rc = -1;
        break;
      }
      PyObject* r = PySequence_Fast_GET_ITEM(regs, j);
      for (int c = 0; c < 13 && rc == 0; ++c) {
        PyObject* v = PyObject_GetAttr(r, names[c]);
        if (!v) {
          rc = -1;
          break;
        }
        if (c < 2) {
          (c ? re : rb)[k] = PyLong_AsLongLong(v);
        } else if (c < 11) {
          i32[c - 2][k] = (int32_t)PyLong_AsLong(v);
        } else if (c == 11) {
          const int t = PyObject_IsTrue(v);
          is_alt[k] = t > 0 ? 1 : 0;
          if (t < 0) rc = -1;
        } else {
          frac[k] = PyFloat_AsDouble(v);
        }
        Py_DECREF(v);
        if (PyErr_Occurred()) rc = -1;
      }
    }
    Py_DECREF(regs);
  }
  Py_DECREF(reads);
  if (rc == 0 && k != n_regs) {
    PyErr_SetString(PyExc_ValueError, "fewer regions than n_regs");
    rc = -1;
  }
  return rc;
}

}  // extern "C"
