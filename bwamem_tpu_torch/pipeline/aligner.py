"""End-to-end single- and paired-end alignment on one device (torch).

Port of the native path of bwamem_tpu/pipeline/aligner.py:MemAligner:

  device:  batched seeding over the whole read batch (ops/seeding): SMEMs
           by default, all MEMs with -g, forward-only MEMs with -u 3,
           fixed-length seeds with -u 2/4
  host:    native chaining, the per-seed filter (-F SHD, or the SW filter
           for reads of 500 bp or more: one device launch per chunk,
           pipeline/seedflt.py), chain->extension-job construction (C++)
  device:  ONE extension launch over job descriptors: the device gathers
           the query/target windows from the uploaded reads and the packed
           genome, runs the extension kernel (dense, or banded when the
           band is narrower than the read), applies end_choice
  host:    L/R merge, native dedup/patch, then mark-primary + SAM text
  -W / -v 4: the per-seed-object path instead — Python chaining objects,
           the filter, host-built extension tiles bucketed by query length
           (one launch per bucket), merge and dedup per read
  PE:      insert-size inference on the host, then mate rescue: window
           bounds on the host, ONE local-SW launch per chunk on windows
           gathered on the device (pipeline/pairing.py), results applied
           on the host; native pairing + SAM text

The reads buffer uploaded for seeding travels WITH its batch (in the seed
arrays dict), never as aligner state: run_pipeline runs two collector
threads on one aligner.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..index.device import DeviceFMIndex
from ..index.format import FMIndex
from ..ops.extend import (ExtendParams, end_choice, extend_batch_auto,
                          extend_choose_desc)
from ..ops import fm as fmops
from ..ops.seeding import SeedConfig, bowtie_seed_batch, smem_seed_batch
from ..utils.shapes import bucket_count, bucket_len, bucket_read_len
from .chain import Chain
from .options import FILTER_COEF, MEM_F_NO_RESCUE, MemOptions, cal_max_gap
from .regions import AlnReg, mem_sort_dedup_patch

_LONG_READ = 500  # reads this long turn the per-seed SW filter on
LEFT, RIGHT = 0, 1


@dataclass
class ExtJob:
    query: np.ndarray
    target: np.ndarray
    h0: int
    reg: AlnReg
    side: int


def chain2aln_jobs(opt: MemOptions, idx: FMIndex, l_query: int,
                   query: np.ndarray, c: Chain, regs: list[AlnReg],
                   jobs: list[ExtJob]) -> None:
    """Build alignment regions + extension jobs for one chain
    (reference: src/bwamem.c:1170-1479 mem_chain2aln)."""
    if not c.seeds:
        return
    l_pac = idx.l_pac
    rmax0, rmax1 = l_pac << 1, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = (t.rbeg + t.len
             + (l_query - t.qbeg - t.len)
             + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:  # crossing the boundary; choose one side
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rmax0, rmax1, rseq, _rid = idx.fetch_seq_rid(rmax0, rmax1,
                                                 mid=c.seeds[0].rbeg)

    # process seeds best-score-first (ties: later index first)
    srt = sorted(range(len(c.seeds)),
                 key=lambda i: (c.seeds[i].score, i))
    skipped = [False] * len(c.seeds)
    for k in range(len(srt) - 1, -1, -1):
        s = c.seeds[srt[k]]
        # contained-in-existing-alignment test on ESTIMATED extents
        hit = -1
        for idx_p, p in enumerate(regs):
            if (s.rbeg < p.rb_est or s.rbeg + s.len > p.re_est
                    or s.qbeg < p.qb_est or s.qbeg + s.len > p.qe_est):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd, rd = s.qbeg - p.qb_est, s.rbeg - p.rb_est
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                hit = idx_p
                break
            qd = p.qe_est - (s.qbeg + s.len)
            rd = p.re_est - (s.rbeg + s.len)
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                hit = idx_p
                break
        if hit >= 0:
            # contained: only extend if an overlapping seed disagrees
            disagree = False
            for i2 in range(k + 1, len(srt)):
                if skipped[srt[i2]]:
                    continue
                t = c.seeds[srt[i2]]
                if t.len < s.len * 0.95:
                    continue
                if (s.qbeg <= t.qbeg
                        and s.qbeg + s.len - t.qbeg >= s.len >> 2
                        and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    disagree = True
                    break
                if (t.qbeg <= s.qbeg
                        and t.qbeg + t.len - s.qbeg >= s.len >> 2
                        and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    disagree = True
                    break
            if not disagree:
                skipped[srt[k]] = True
                continue

        a = AlnReg(w=opt.w, score=-1, truesc=-1, rid=c.rid,
                   frac_rep=c.frac_rep, is_alt=c.is_alt)
        # estimated extents (fork FILTER_COEF logic, src/bwamem.c:1284-1298)
        fwd = int(FILTER_COEF * (l_query - (s.qbeg + s.len)))
        a.qe_est = min(s.qbeg + s.len + fwd, l_query)
        a.re_est = min(s.rbeg + s.len + fwd, l_pac << 1)
        back = int(FILTER_COEF * (s.qbeg + 1))
        a.qb_est = max(s.qbeg - back, 0)
        a.rb_est = max(s.rbeg - back, 0)
        if a.rb_est < l_pac < a.re_est:
            if s.rbeg < l_pac:
                a.re_est = l_pac
            else:
                a.rb_est = l_pac
        a.seedlen0 = s.len
        a.query_seed_begin = s.qbeg
        a.target_seed_begin = s.rbeg
        a._chain_seeds = c.seeds  # for post-merge seedcov

        lql = s.qbeg
        lrl = s.rbeg - rmax0
        rql = l_query - (lql + s.len)
        rrl = (rmax1 - rmax0) - (lrl + s.len)
        h0 = s.len * opt.a
        if lql > 0:
            jobs.append(ExtJob(
                query=query[:lql][::-1].copy(),
                target=rseq[:lrl][::-1].copy(),
                h0=h0, reg=a, side=LEFT))
        if rql > 0:
            jobs.append(ExtJob(
                query=query[lql + s.len:].copy(),
                target=rseq[lrl + s.len:].copy(),
                h0=h0, reg=a, side=RIGHT))
        a.align_sides = (lql > 0) + (rql > 0)
        if a.align_sides == 0:  # seed spans the whole read
            # reference: s->score < 0 ? s->len * opt->a : s->score
            a.score = a.truesc = (s.score if s.sw_scored
                                  else s.len * opt.a)
            a.qb, a.qe = 0, l_query
            a.rb, a.re = s.rbeg, s.rbeg + s.len
            a.seedcov = sum(
                t.len for t in c.seeds
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re))
        regs.append(a)


def run_extension_jobs(fm_params: ExtendParams, mat, jobs: list[ExtJob],
                       pen_clip: int, bucket_bounds=(64, 192, 1 << 30),
                       device="cuda") -> None:
    """Execute all jobs on `device`, bucketed by query length (the
    generalization of the reference's SHORT/LONG split,
    src/bntseq.h:85-99), then scatter chosen (score, qle, tle) into
    reg.part[side]. The tiles are materialized on the host; a bucket's
    widths are the buckets of its longest query and target, so long
    targets reach the dense kernel's wide route. Job counts are not
    padded: the launch takes any count."""
    if not jobs:
        return
    buckets: dict[int, list[ExtJob]] = {}
    for j in jobs:
        for b in bucket_bounds:
            if len(j.query) <= b:
                buckets.setdefault(b, []).append(j)
                break
    mat_t = torch.as_tensor(np.asarray(mat, np.int32), device=device)
    for sub in buckets.values():
        QMAX = bucket_len(max(len(j.query) for j in sub))
        TMAX = bucket_len(max(len(j.target) for j in sub))
        N = len(sub)
        Q = np.full((N, QMAX), 4, np.int8)
        T = np.full((N, TMAX), 4, np.int8)
        ql = np.zeros(N, np.int32)
        tl = np.zeros(N, np.int32)
        h0 = np.ones(N, np.int32)
        for i, j in enumerate(sub):
            Q[i, : len(j.query)] = j.query
            T[i, : len(j.target)] = j.target
            ql[i], tl[i], h0[i] = len(j.query), len(j.target), j.h0
        Qt, Tt, qlt, tlt, h0t = (torch.from_numpy(a).to(device)
                                 for a in (Q, T, ql, tl, h0))
        out = extend_batch_auto(Qt, Tt, qlt, tlt, h0t, mat_t, fm_params)
        sc, qe, te = torch.stack(end_choice(
            out["score"], out["qle"], out["tle"], out["gscore"],
            out["gtle"], qlt, pen_clip)).cpu().numpy()
        for i, j in enumerate(sub):
            j.reg.part[j.side] = [int(sc[i]), int(qe[i]), int(te[i])]


def merge_extension_results(l_query: int, regs: list[AlnReg],
                            a_match: int = 1) -> None:
    """L/R merge (reference: src/bwamem.c:2296-2311) + post-merge seedcov
    (vanilla-style; the fork leaves seedcov 0 for extended regions, which
    only matters for the non-default mapQ_coef_len=0 formula).

    When both sides extended, each side's score counts the whole seed
    (h0 = seedlen0 * a), so one seed score must come back out. The
    reference subtracts bare `seedlen0` (src/bwamem.c:2298) — correct
    only at the default a=1; at -A 2 that inflates every two-sided score
    by seedlen0*(a-1) above the theoretical max. We subtract
    seedlen0 * a, which matches vanilla bwa-mem's chained-extension
    scores for every a (verified by the -A flag cell of the concordance
    matrix, tests/test_bwa_concordance_flags.py)."""
    for a in regs:
        if a.align_sides > 0:
            a.score = a.part[LEFT][0] + a.part[RIGHT][0]
            if a.align_sides == 2:
                a.score -= a.seedlen0 * a_match
            a.qb = a.query_seed_begin - a.part[LEFT][1]
            a.qe = a.query_seed_begin + a.seedlen0 + a.part[RIGHT][1]
            a.rb = a.target_seed_begin - a.part[LEFT][2]
            a.re = a.target_seed_begin + a.seedlen0 + a.part[RIGHT][2]
            a.truesc = a.score
            seeds = a._chain_seeds
            a.seedcov = sum(
                t.len for t in seeds
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re))


def _dump_chains(idx, seeds, per_read_chains) -> None:
    """Debug dump of seeds + chains (equivalent of the reference's
    bwa_verbose>=4 traces / mem_print_chain, src/bwamem.c:386-402 and
    mem_print_gpu, src/bwamem.c:304)."""
    import sys

    for b, chains in enumerate(per_read_chains):
        print(f"=====> read {b}: {len(seeds[b])} seeds, "
              f"{len(chains)} chains <=====", file=sys.stderr)
        for q0, q1, rb, occ in seeds[b]:
            print(f"  seed q[{q0},{q1}) r={rb} occ={occ}", file=sys.stderr)
        for ci, c in enumerate(chains):
            parts = "; ".join(f"{s.qbeg},{s.rbeg},{s.len}" for s in c.seeds)
            print(f"  chain({ci}) w={c.w} rid={c.rid}: {parts}",
                  file=sys.stderr)


def _dump_regs(per_read_regs, stage: str) -> None:
    import sys

    for b, regs in enumerate(per_read_regs):
        for a in regs:
            print(f"  [{stage}] read {b}: q[{a.qb},{a.qe}) r[{a.rb},{a.re})"
                  f" score={a.score} w={a.w} seedcov={a.seedcov}",
                  file=sys.stderr)


class MemAligner:
    """Index in device memory, batched device stages, host post-processing.
    Single- and paired-end reads of any length, every seeding mode (SMEM +
    re-seed rounds, -g, -u 2/3/4), the per-seed filters, the native host
    core or the per-seed-object path."""

    def __init__(self, opt: MemOptions, idx: FMIndex,
                 fm: DeviceFMIndex | None = None,
                 seed_cfg: SeedConfig | None = None, device="cuda"):
        self.opt = opt
        self.idx = idx
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        self.stats = {"n_reads": 0, "n_seeds": 0, "n_extensions": 0}
        # optional stage timing, set by run_pipeline
        self.timings = None
        self.pes_fixed = None  # -I fixed insert-size model
        self.fm = fm or DeviceFMIndex.from_host(idx, self.device)
        self.seed_cfg = seed_cfg or SeedConfig(
            min_seed_len=opt.min_seed_len, max_occ=opt.max_occ,
            reseed=opt.full_reseed, split_factor=opt.split_factor,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv)
        # -u 3 and -g pick the seeding mode, whatever the config says
        self.seed_cfg = replace(
            self.seed_cfg, mode=("fwdmem" if opt.seed_type == 3
                                 else "mem" if opt.re_seed else "smem"))
        self.ext_params = ExtendParams(
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, w=opt.w, zdrop=opt.zdrop,
            end_bonus=opt.pen_clip5, opt_ext=opt.opt_ext, max_mat=opt.a)
        self._mat = torch.from_numpy(np.array(opt.mat)).to(self.device)

    def _span(self, label: str):
        return (self.timings.span(label) if self.timings is not None
                else nullcontext())

    def seed_batch_arrays(self, seqs: list[np.ndarray]) -> dict:
        """Device seeding; returns flat seed arrays (qbeg/qend/rbeg/n_occ)
        + per-read bounds, plus the uploaded reads buffer."""
        B = len(seqs)
        L = bucket_read_len(max(len(s) for s in seqs))
        reads = np.full((B, L), 4, np.int8)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = s
            lens[i] = len(s)
        reads_t = torch.from_numpy(reads).to(self.device)
        lens_t = torch.from_numpy(lens).to(self.device)
        opt = self.opt
        # the JAX aligner scales its candidate pool with the read bucket
        # (the next power of two of ceil(L / 192), at most 4096 slots a
        # read) and keeps it for later batches; -g's compaction schedule
        # acts on that pool's width
        need = -(-L // 192)
        cand = min(self.seed_cfg.cand_pool << (need - 1).bit_length(), 4096)
        if self.seed_cfg.cand_pool > 0 and cand > self.seed_cfg.cand_pool:
            self.seed_cfg = replace(self.seed_cfg, cand_pool=cand)
        with self._span("seed_device"):
            if opt.seed_type in (2, 4):
                ktab_k = 8 if opt.min_seed_len > 8 else 0
                out = bowtie_seed_batch(
                    self.fm, reads_t, lens_t, seed_len=opt.min_seed_len,
                    stride=opt.seed_intv or opt.min_seed_len,
                    inexact=opt.seed_type == 4, max_occ=self.seed_cfg.max_occ,
                    ktab=(fmops.get_kmer_table(self.fm, ktab_k)
                          if ktab_k else None), ktab_k=ktab_k)
            else:
                # the JAX aligner pads the batch to bucket_count(B)
                out = smem_seed_batch(self.fm, reads_t, lens_t,
                                      self.seed_cfg,
                                      pool_reads=bucket_count(B))
                # -g: the pool its round-1 candidates grew, kept for later
                # batches as the JAX aligner keeps its retry's
                cand = out.pop("cand_pool")
                if cand != self.seed_cfg.cand_pool:
                    self.seed_cfg = replace(self.seed_cfg, cand_pool=cand)
            host = {k: v.cpu().numpy() for k, v in out.items()}
        self.stats["n_seeds"] += len(host["rbeg"])
        bounds = np.searchsorted(host["read_id"], np.arange(B + 1))
        return dict(qbeg=host["qbeg"], qend=host["qend"], rbeg=host["rbeg"],
                    n_occ=host["n_occ"], bounds=bounds.astype(np.int64),
                    reads_dev=(B, L, reads_t))

    def seed_batch(self, seqs: list[np.ndarray]) -> list[list[tuple]]:
        """Tuple-list view of seed_batch_arrays, one list of (qbeg, qend,
        rbeg, n_occ) per read (fastmap, tests)."""
        arr = self.seed_batch_arrays(seqs)
        cols = np.stack([arr["qbeg"], arr["qend"], arr["rbeg"],
                         arr["n_occ"]], axis=1)
        b = arr["bounds"]
        return [
            [tuple(int(x) for x in row) for row in cols[b[i]:b[i + 1]]]
            for i in range(len(seqs))
        ]

    def _collect_native(self, seqs, seeds):
        """Native chaining AND chain2aln job construction (flat arrays, no
        per-seed Python objects), the device extension, then the merge and
        native dedup."""
        opt, idx = self.opt, self.idx
        from ..native import loader
        from .chain import chain_batch_raw

        lib = loader.try_load()
        if lib is None:
            raise NotImplementedError(
                "the native C++ core failed to build or load; the Python "
                "fallback path is not ported (ROADMAP queue A)")
        lqs = [len(s) for s in seqs]
        with self._span("chain_native"):
            raw = chain_batch_raw(opt, idx, lqs, None, seed_arrays=seeds)
        if opt.shd_filter or max(lqs, default=0) >= _LONG_READ:
            # -F SHD / long-read SW per-seed filter: one batched device
            # launch over the flat arrays (no per-seed objects)
            from .seedflt import filter_seed_arrays

            with self._span("seed_filter"):
                filter_seed_arrays(opt, idx, raw, seqs, device=self.device)
        B = len(seqs)
        L = max(lqs)
        reads = np.full((B, L), 4, np.uint8)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = s
        with self._span("chain2aln_native"):
            out = loader.chain2aln_native(
                lib, opt, idx, raw, reads.reshape(-1), L,
                np.asarray(lqs, np.int32))
        nR = out["n_regs"]
        R = out["regs"]

        self.stats["n_reads"] += B
        self.stats["n_extensions"] += out["n_jobs"]
        partL = np.zeros((nR, 3), np.int64)
        partR = np.zeros((nR, 3), np.int64)
        self._run_jobs_arrays(out, (partL, partR),
                              reads_dev=seeds["reads_dev"][2])

        # vectorized L/R merge (reference rule: src/bwamem.c:2296-2311)
        with self._span("merge_numpy"):
            sides = R["sides"][:nR].astype(np.int64)
            seedlen0 = R["seedlen0"][:nR].astype(np.int64)
            qseed = R["qseed"][:nR].astype(np.int64)
            rseed = R["rseed"][:nR]
            ext = sides > 0
            # two-sided merge subtracts the double-counted seed at its SCORE
            # (seedlen0 * a), not its length
            score = np.where(
                ext,
                partL[:, 0] + partR[:, 0] - (sides == 2) * seedlen0 * opt.a,
                R["score0"][:nR])
            qb = np.where(ext, qseed - partL[:, 1], R["qb0"][:nR])
            qe = np.where(ext, qseed + seedlen0 + partR[:, 1], R["qe0"][:nR])
            rb = np.where(ext, rseed - partL[:, 2], R["rb0"][:nR])
            re = np.where(ext, rseed + seedlen0 + partR[:, 2], R["re0"][:nR])

            sq = raw["s_qbeg"].astype(np.int64)
            sr = raw["s_rbeg"]
            sl = raw["s_len"].astype(np.int64)
            soffs = R["chain_soff"][:nR].astype(np.int64)
            nss = R["chain_ns"][:nR].astype(np.int64)
            # vectorized seedcov: (reg, seed) pair table + masked bincount
            total = int(nss.sum())
            pair_reg = np.repeat(np.arange(nR), nss)
            cum = np.zeros(nR, np.int64)
            np.cumsum(nss[:-1], out=cum[1:])
            pair_seed = np.repeat(soffs - cum, nss) + np.arange(total)
            tq = sq[pair_seed]
            tr = sr[pair_seed]
            tl = sl[pair_seed]
            pm = ((tq >= qb[pair_reg]) & (tq + tl <= qe[pair_reg])
                  & (tr >= rb[pair_reg]) & (tr + tl <= re[pair_reg]))
            scov = np.bincount(pair_reg[pm], weights=tl[pm],
                               minlength=nR).astype(np.int64)
            scov = np.where(ext, scov, R["seedcov0"][:nR])
            rids = R["rid"][:nR]
            alts = R["is_alt"][:nR]
            fracs = R["frac"][:nR]
            reads_of = R["read"][:nR]

            # native dedup + patch over the flat arrays; regions arrive
            # grouped by read (chain2aln emits reads in order)
            if reads_of.size and not (np.diff(reads_of) >= 0).all():
                raise RuntimeError(
                    "chain2aln returned regions out of read order")
            reg_off = np.searchsorted(
                reads_of, np.arange(B + 1, dtype=np.int64)).astype(np.int64)
            qlens = np.fromiter((len(q) for q in seqs), np.int64, B)
            q_off = np.zeros(B, np.int64)
            np.cumsum(qlens[:-1], out=q_off[1:])
            qstream = (np.concatenate([np.asarray(q, np.uint8) for q in seqs])
                       if B else np.zeros(0, np.uint8))
            F = dict(
                rb=np.ascontiguousarray(rb, np.int64),
                re=np.ascontiguousarray(re, np.int64),
                qb=np.ascontiguousarray(qb, np.int32),
                qe=np.ascontiguousarray(qe, np.int32),
                score=np.ascontiguousarray(score, np.int32),
                truesc=np.ascontiguousarray(score, np.int32),
                w=np.full(nR, opt.w, np.int32),
                seedcov=np.ascontiguousarray(scov, np.int32),
                sub=np.zeros(nR, np.int32),
                csub=np.zeros(nR, np.int32),
                n_comp=np.ones(nR, np.int32),
                rid=np.ascontiguousarray(rids, np.int32),
            )
        with self._span("dedup_native"):
            oi, oc = loader.dedup_patch_native(lib, opt, idx, reg_off,
                                               qstream, q_off, F)
        # survivor selection into the array-backed region container
        from .regarrays import RegArrays

        oc64 = oc.astype(np.int64)
        new_off = np.zeros(B + 1, np.int64)
        np.cumsum(oc64, out=new_off[1:])
        tot = int(new_off[-1])
        row_start = np.repeat(reg_off[:B], oc64)
        within = np.arange(tot, dtype=np.int64) - np.repeat(
            new_off[:B], oc64)
        take = oi[row_start + within]
        cols = {name: F[name][take]
                for name in ("rb", "re", "qb", "qe", "score", "truesc",
                             "sub", "csub", "w", "seedcov", "rid")}
        cols["is_alt"] = alts[take].astype(np.int8)
        cols["frac"] = np.asarray(fracs, np.float64)[take]
        return RegArrays(new_off, cols, n_comp=F["n_comp"][take])

    def _run_jobs_arrays(self, out, parts, reads_dev) -> None:
        """One device extension over the batch's jobs, shipped as
        descriptors; results land in parts[side][reg, 0:3] =
        (score, qle, tle)."""
        opt = self.opt
        J = out["jobs"]
        nJ = out["n_jobs"]
        if nJ == 0:
            return
        qlen = J["qlen"][:nJ]

        # tlen clamp to the provable DP reach (output-exact for the chosen
        # (score, qle, tle): rows past it cannot update best/qle/tle, and
        # a gscore flatlined at 0 is discarded by end_choice)
        p = self.ext_params
        q64 = qlen.astype(np.int64)
        h064 = J["h0"][:nJ].astype(np.int64)
        e_min = max(min(p.e_del, p.e_ins), 1)
        o_min = min(p.o_del, p.o_ins)
        if p.opt_ext:
            reach = q64 + int(p.w) + 1
        else:
            reach = q64 + np.maximum(
                h064 + int(p.max_mat) * q64 - o_min, 0) // e_min + 2
        tlen = np.minimum(J["tlen"][:nJ].astype(np.int64),
                          reach).astype(np.int32)

        # window widths from the READ LENGTH bucket + score params, as the
        # JAX twin does (the kernel's work follows each job's own lengths)
        Lb = reads_dev.shape[1]
        QMAX = bucket_len(Lb)
        if p.opt_ext:
            TMAX = bucket_len(QMAX + int(p.w) + 1)
        else:
            TMAX = bucket_len(
                QMAX + (int(p.max_mat) * Lb - o_min) // e_min + 2)
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        with self._span("ext_device"):
            stacked = extend_choose_desc(
                self.fm, reads_dev, up(J["read"][:nJ], np.int32),
                up(J["qstart"][:nJ], np.int32), up(qlen, np.int32),
                up(J["tstart"][:nJ], np.int64), up(tlen, np.int32),
                up(J["dir"][:nJ], np.int8), up(J["h0"][:nJ], np.int32),
                self._mat, self.ext_params, int(opt.pen_clip5), QMAX, TMAX)
            sc, qe, te = stacked.cpu().numpy()
        jreg = J["reg"][:nJ]
        jside = J["side"][:nJ]
        for side in (0, 1):
            m = jside == side
            parts[side][jreg[m], 0] = sc[m]
            parts[side][jreg[m], 1] = qe[m]
            parts[side][jreg[m], 2] = te[m]

    def collect_regs_batch(self, seqs: list[np.ndarray]):
        """Device seeding + native chaining + ONE device extension + L/R
        merge + dedup/patch, before primary marking: a RegArrays. With -W
        or -v >= 4, the per-seed-object path: a list of AlnReg lists."""
        with self._span("seed_total"):
            seed_arr = self.seed_batch_arrays(seqs)
        if self.opt.min_chain_weight > 0 or self.opt.verbose >= 4:
            return self._collect_objects(seqs, seed_arr)
        with self._span("native_total"):
            return self._collect_native(seqs, seed_arr)

    def _collect_objects(self, seqs, seed_arr):
        """The per-seed-object path (the JAX twin's fallback body of
        collect_regs_batch): chains as Python objects, the per-seed filter,
        extension jobs built per chain, one launch per query-length bucket,
        merge and dedup per read."""
        from .chain import chain_batch
        from .seedflt import SeedFilterBatch

        opt, idx = self.opt, self.idx
        cols = np.stack([seed_arr["qbeg"], seed_arr["qend"],
                         seed_arr["rbeg"], seed_arr["n_occ"]], axis=1)
        bnd = seed_arr["bounds"]
        seeds = [
            [tuple(int(x) for x in row) for row in cols[bnd[i]:bnd[i + 1]]]
            for i in range(len(seqs))
        ]

        # phase 1: chains + chain filter for every read, then the per-seed
        # filter jobs of the whole batch in one launch
        per_read_chains = chain_batch(opt, idx, [len(s) for s in seqs],
                                      seeds)
        flt = SeedFilterBatch(opt, idx, device=self.device)
        for b, seq in enumerate(seqs):
            flt.add_read(len(seq), seq, per_read_chains[b])
        with self._span("seed_filter"):
            flt.run()

        if opt.verbose >= 4:
            _dump_chains(idx, seeds, per_read_chains)

        # phase 2: extension-job construction, then one launch per bucket
        per_read_regs: list[list[AlnReg]] = []
        jobs: list[ExtJob] = []
        for b, seq in enumerate(seqs):
            regs: list[AlnReg] = []
            for c in per_read_chains[b]:
                chain2aln_jobs(opt, idx, len(seq), seq, c, regs, jobs)
            per_read_regs.append(regs)
        if opt.verbose >= 4:
            _dump_regs(per_read_regs, stage="pre-extension")

        self.stats["n_reads"] += len(seqs)
        self.stats["n_extensions"] += len(jobs)
        with self._span("ext_device"):
            run_extension_jobs(self.ext_params, opt.mat, jobs, opt.pen_clip5,
                               device=self.device)

        out: list[list[AlnReg]] = []
        for b, seq in enumerate(seqs):
            regs = per_read_regs[b]
            merge_extension_results(len(seq), regs, a_match=opt.a)
            out.append(mem_sort_dedup_patch(opt, idx, seq, regs))
        if opt.verbose >= 4:
            _dump_regs(out, stage="post-dedup")
        return out

    def collect_pairs_batch(self, seqs: list[np.ndarray],
                            pes: list | None = None):
        """PE collection: regions + insert-size inference + batched mate
        rescue (one local-SW launch per chunk). Returns (pair_regs, pes)
        for the finalization stage."""
        from .pairing import mem_pe_rescue_batch, mem_pestat

        opt, idx = self.opt, self.idx
        if len(seqs) % 2:
            raise SystemExit(
                "[bwamem-tpu-torch] error: paired-end input has an odd "
                "number of reads — not valid interleaved PE data")
        per_read_regs = self.collect_regs_batch(seqs)
        if hasattr(per_read_regs, "to_lists"):
            # materialize ONCE: pestat iteration + pair grouping below
            # would otherwise each rebuild the objects per read
            per_read_regs = per_read_regs.to_lists()
        if pes is None:
            with self._span("pestat"):
                pes = self.pes_fixed or mem_pestat(opt, idx.l_pac,
                                                   per_read_regs)
        n_pairs = len(seqs) >> 1
        pair_seqs = [(seqs[i << 1], seqs[i << 1 | 1])
                     for i in range(n_pairs)]
        pair_regs = [[per_read_regs[i << 1], per_read_regs[i << 1 | 1]]
                     for i in range(n_pairs)]
        if not (opt.flag & MEM_F_NO_RESCUE):
            with self._span("pe_rescue"):
                mem_pe_rescue_batch(opt, idx, pes, pair_seqs, pair_regs,
                                    dev=self.fm, span=self._span,
                                    stats=self.stats)
        return pair_regs, pes

    def emit_sam_batch(self, names, seqs, quals, per_read_regs,
                       n_processed: int = 0, comments=None) -> list[str]:
        """Mark-primary + SAM text per read in ONE native call."""
        from ..native import loader

        opt = self.opt
        cms = comments if (comments and opt.copy_comment) else None
        lib = loader.try_load()
        if lib is None:
            raise NotImplementedError(
                "the native C++ core failed to build or load")
        blob = loader.finalize_se_native(
            lib, opt, self.idx, names, seqs, quals, per_read_regs,
            n_processed, cms, getattr(opt, "rg_id", None))
        return blob.decode().splitlines()

    def align_batch(self, names: list[str], seqs: list[np.ndarray],
                    quals: list[str | None] | None = None,
                    n_processed: int = 0) -> list[str]:
        """Single-end: SAM lines (one or more per read, in input order)."""
        quals = quals or [None] * len(seqs)
        per_read_regs = self.collect_regs_batch(seqs)
        return self.emit_sam_batch(names, seqs, quals, per_read_regs,
                                   n_processed)

    def align_pairs_batch(self, names: list[str], seqs: list[np.ndarray],
                          quals: list[str | None] | None = None,
                          n_processed: int = 0,
                          pes: list | None = None) -> list[str]:
        """Paired-end: `seqs` is interleaved (read1, read2, ...). Insert
        sizes are inferred from this chunk unless `pes` is given or
        pes_fixed is set."""
        from .hostpool import _emit_pe

        quals = quals or [None] * len(seqs)
        pair_regs, pes = self.collect_pairs_batch(seqs, pes)
        return _emit_pe(self.opt, self.idx, names, seqs, quals, pair_regs,
                        pes, n_processed >> 1)
