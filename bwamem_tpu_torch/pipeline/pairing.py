"""Paired-end alignment: insert-size inference, mate rescue, pairing, SAM.

Behavioral port of the reference PE module (reference: src/bwamem_pair.c)
re-architected for TPU batching: the reference performs one SSE ksw_align2
per (pair, orientation) serially inside mem_matesw; here every rescue round
across the whole chunk becomes ONE batched sw_align_batch device launch
(ops/swalign.py), preserving the reference's candidate ordering (all
candidates of end 0 before end 1, reference src/bwamem_pair.c:280-282, with
the per-call skip logic re-evaluated between rounds).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..index.format import FMIndex
from .options import MemOptions, MEM_F_ALL, MEM_F_NOPAIRING, hash_64
from .regions import AlnReg, mem_approx_mapq_se, mem_mark_primary_se, \
    mem_sort_dedup_patch
from .samgen import MemAln, mem_aln2sam, mem_gen_alt, mem_reg2aln

# reference: src/bwamem_pair.c:16-21
MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0

_M64 = (1 << 64) - 1


@dataclass
class PEStat:
    """Insert-size model for one orientation (reference: mem_pestat_t)."""
    low: int = 0
    high: int = 0
    failed: bool = True
    avg: float = 0.0
    std: float = 0.0


def mem_infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """Orientation (0=FF 1=FR 2=RF 3=RR) + distance of two hits in doubled
    coords (reference: src/bwamem_pair.c:23-30)."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt: MemOptions, regs: list[AlnReg]) -> int:
    """Second-best score among hits overlapping the top hit
    (reference: src/bwamem_pair.c:32-44)."""
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def mem_pestat(opt: MemOptions, l_pac: int,
               per_read_regs: list[list[AlnReg]],
               verbose: bool = False) -> list[PEStat]:
    """Infer the insert-size distribution for the 4 orientations from the
    chunk's unique high-confidence pairs (reference:
    src/bwamem_pair.c:46-117)."""
    import sys
    isize: list[list[int]] = [[], [], [], []]
    n = len(per_read_regs)
    for i in range(n >> 1):
        r0 = per_read_regs[i << 1]
        r1 = per_read_regs[i << 1 | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = mem_infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if 0 < dist <= opt.max_ins:
            isize[d].append(dist)
    pes = [PEStat() for _ in range(4)]
    for d in range(4):
        r, q = pes[d], isize[d]
        if len(q) < MIN_DIR_CNT:
            r.failed = True
            continue
        if verbose:
            print(f"[mem_pestat] analyzing insert size distribution for "
                  f"orientation {'FR'[d >> 1 & 1]}{'FR'[d & 1]}...",
                  file=sys.stderr)
        q.sort()
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        sel = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(sel) / len(sel)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in sel) / len(sel))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg - MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        r.low = max(r.low, 1)
        r.failed = False
        if verbose:
            print(f"[mem_pestat] (25,50,75) percentile: ({p25},{p50},{p75});"
                  f" mean/std: ({r.avg:.2f},{r.std:.2f});"
                  f" proper-pair bounds: ({r.low},{r.high})", file=sys.stderr)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if not pes[d].failed and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = True
    return pes


def pestat_from_spec(spec: str) -> list[PEStat]:
    """-I mean[,std[,max[,min]]]: fixed FR insert-size model (reference:
    src/fastmap.c:250-267); other orientations stay failed."""
    parts = [float(x) for x in spec.replace("/", ",").split(",") if x]
    pes = [PEStat() for _ in range(4)]
    fr = pes[1]
    fr.failed = False
    fr.avg = parts[0]
    fr.std = parts[1] if len(parts) > 1 else fr.avg * 0.1
    fr.high = int(fr.avg + 4.0 * fr.std + 0.499)
    fr.low = max(int(fr.avg - 4.0 * fr.std + 0.499), 1)
    if len(parts) > 2:
        fr.high = int(parts[2] + 0.499)
    if len(parts) > 3:
        fr.low = int(parts[3] + 0.499)
    return pes


# ---------------------------------------------------------------- rescue --

@dataclass
class _SWJob:
    seq: np.ndarray      # oriented mate sequence
    ref: np.ndarray | None  # window bases (None on the descriptor path:
    #                         targets are gathered on-device from rb/tlen)
    rb: int              # clipped window start (doubled coords)
    tlen: int            # clipped window length
    is_rev: bool
    l_ms: int
    rid: int
    is_alt: bool
    r: int = -1          # orientation (for deferred eligibility tests)


def _matesw_skip(pes: list[PEStat], l_pac: int, a: AlnReg,
                 ma: list[AlnReg]) -> list[bool]:
    """Orientation skip flags of mem_matesw (reference:
    src/bwamem_pair.c:122-133). Monotone in `ma`: adding hits can only
    turn a flag on — the fused rescue relies on this."""
    skip = [p.failed for p in pes]
    for m in ma:
        r, dist = mem_infer_dir(l_pac, a.rb, m.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = True
    return skip


def _matesw_build(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
                  a: AlnReg, ms: np.ndarray, ma: list[AlnReg],
                  materialize: bool = True) -> list[_SWJob]:
    """Window construction half of mem_matesw (reference:
    src/bwamem_pair.c:122-155): returns the SW jobs to run (<= 4).
    With materialize=False only the clipped window BOUNDS are computed
    (the descriptor path gathers the bases on-device; per-job base
    extraction dominated the host half of rescue)."""
    l_pac = idx.l_pac
    l_ms = len(ms)
    skip = _matesw_skip(pes, l_pac, a, ma)
    if all(skip):
        return []
    jobs: list[_SWJob] = []
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger
                  else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger
                  else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        if rb >= re:
            continue
        if materialize:
            rb, re, ref, rid = idx.fetch_seq_rid(rb, re,
                                                 mid=(rb + re) >> 1)
            ref = ref.astype(np.int32)
        else:
            rb, re, rid = idx.fetch_bounds_rid(rb, re, mid=(rb + re) >> 1)
            ref = None
        if a.rid != rid or re - rb < opt.min_seed_len:
            continue
        seq = ms if not is_rev else \
            np.where(ms < 4, 3 - ms, 4)[::-1].astype(ms.dtype)
        jobs.append(_SWJob(seq=seq, ref=ref, rb=rb, tlen=re - rb,
                           is_rev=is_rev, l_ms=l_ms, rid=rid,
                           is_alt=a.is_alt, r=r))
    return jobs


def _matesw_apply(opt: MemOptions, l_pac: int, job: _SWJob, res: dict,
                  ma: list[AlnReg]) -> bool:
    """Result half of mem_matesw (reference: src/bwamem_pair.c:156-180):
    convert a passing SW hit into an AlnReg and insert score-sorted."""
    score, qb, qe = int(res["score"]), int(res["qb"]), int(res["qe"])
    tb, te, score2 = int(res["tb"]), int(res["te"]), int(res["score2"])
    if score < opt.min_seed_len or qb < 0:
        return False
    l_ms, rb, is_rev = job.l_ms, job.rb, job.is_rev
    b = AlnReg(rid=job.rid, is_alt=job.is_alt, secondary=-1)
    b.qb = l_ms - (qe + 1) if is_rev else qb
    b.qe = l_ms - qb if is_rev else qe + 1
    b.rb = (l_pac << 1) - (rb + te + 1) if is_rev else rb + tb
    b.re = (l_pac << 1) - (rb + tb) if is_rev else rb + te + 1
    b.score = b.truesc = score
    b.csub = score2
    b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
    pos = len(ma)
    for i in range(len(ma)):
        if ma[i].score < b.score:
            pos = i
            break
    ma.insert(pos, b)
    return True


def _use_desc_rescue(dev) -> bool:
    """Rescue has one arm here: descriptor-driven, on the device that
    holds the aligner's index `dev` (windows gathered there; the local-SW
    kernel on a GPU, its plain version on the CPU)."""
    if dev is None:
        raise ValueError("mate rescue needs the aligner's device index")
    return True


def _run_sw_jobs(opt: MemOptions, jobs: list[_SWJob],
                 dev=None, use_desc: bool = False) -> list[dict]:
    """One batched device launch for a rescue round, descriptor-driven:
    the oriented mate queries go up as one int8 tile and the window
    descriptors (qlen, rb, tlen, minsc) as one array, the targets are
    gathered from the device-resident genome, the local SW runs, and the
    (6, N) result comes down once. No padding of N: every launch takes
    its own job count."""
    import torch

    from ..ops.swalign import SW_KEYS, sw_rescue_desc_stacked
    from ..utils.shapes import bucket_len

    n_real = len(jobs)
    QMAX = bucket_len(max(len(j.seq) for j in jobs))
    TMAX = bucket_len(max(j.tlen for j in jobs))
    Q = np.full((n_real, QMAX), 4, np.int8)
    desc = np.empty((4, n_real), np.int64)  # qlen, rb, tlen, minsc
    desc[3] = opt.min_seed_len * opt.a
    for i, j in enumerate(jobs):
        Q[i, : len(j.seq)] = j.seq
        desc[0, i], desc[1, i], desc[2, i] = len(j.seq), j.rb, j.tlen
    device = dev.pac_words.device
    desc_t = torch.from_numpy(desc).to(device)
    ql, tl, minsc = (desc_t[k].to(torch.int32) for k in (0, 2, 3))
    # rev_skip: _matesw_apply rejects score < min_seed_len before
    # reading qb/tb (reference src/bwamem_pair.c:156), so failed
    # probes — the common case — skip the reverse sweep entirely
    stacked = sw_rescue_desc_stacked(
        dev, torch.from_numpy(Q).to(device), ql, desc_t[1], tl, minsc,
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, TMAX,
        rev_skip=opt.min_seed_len).cpu().numpy()
    out = dict(zip(SW_KEYS, stacked))
    return [{k: out[k][i] for k in out} for i in range(n_real)]


def mem_pe_rescue_batch(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
                        pair_seqs: list[tuple[np.ndarray, np.ndarray]],
                        pair_regs: list[list[list[AlnReg]]],
                        dev=None, span=None, stats=None) -> int:
    """Mate rescue for a whole chunk, batched per candidate round
    (reference: src/bwamem_pair.c:273-284 driving mem_matesw). Mutates
    pair_regs in place; returns the number of SW jobs run.
    `span`: optional Timings.span factory for build/launch/apply
    sub-attribution."""
    from contextlib import nullcontext

    sp = span or (lambda _label: nullcontext())
    use_desc = _use_desc_rescue(dev)
    n_pairs = len(pair_seqs)
    # snapshot both ends' candidate lists BEFORE any rescue
    cand: list[list[list[AlnReg]]] = []
    for regs2 in pair_regs:
        both = []
        for i in (0, 1):
            ai = regs2[i]
            c = [r for r in ai
                 if r.score >= ai[0].score - opt.pen_unpaired] if ai else []
            both.append(c[: opt.max_matesw])
        cand.append(both)
    # FUSED rescue: the per-round skip test is monotone in the mate's
    # hit list, so building every round's jobs against the PRE-rescue
    # state yields an exact superset; ONE device launch serves all
    # rounds, and per-round eligibility is re-evaluated at apply time
    # against the live state (bit-identical to the sequential rounds,
    # which cost one dispatch+transfer round-trip each).
    rounds: list[tuple[int, int, int, list[_SWJob]]] = []  # (i, j, pi, jobs)
    with sp("pe_rescue_build"):
        for i in (0, 1):
            jmax = max((len(c[i]) for c in cand), default=0)
            for j in range(jmax):
                for pi in range(n_pairs):
                    if j >= len(cand[pi][i]):
                        continue
                    jobs = _matesw_build(opt, idx, pes, cand[pi][i][j],
                                         pair_seqs[pi][1 - i],
                                         pair_regs[pi][1 - i],
                                         materialize=not use_desc)
                    if jobs:
                        rounds.append((i, j, pi, jobs))
        flat = [jb for (_i, _j, _pi, jobs) in rounds for jb in jobs]
    if not flat:
        return 0
    with sp("pe_rescue_sw"):
        results = _run_sw_jobs(opt, flat, dev=dev, use_desc=use_desc)
    n_sw = 0
    k = 0
    with sp("pe_rescue_apply"):
        for (i, j, pi, jobs) in rounds:
            a = cand[pi][i][j]
            ma = pair_regs[pi][1 - i]
            skip = _matesw_skip(pes, idx.l_pac, a, ma)
            applied = False
            for jb in jobs:
                if not skip[jb.r]:
                    _matesw_apply(opt, idx.l_pac, jb, results[k], ma)
                    n_sw += 1
                    applied = True
                k += 1
            if applied:
                pair_regs[pi][1 - i] = mem_sort_dedup_patch(
                    opt, idx, None, ma, patch=False)
    if stats is not None:
        stats["rescue_jobs"] = stats.get("rescue_jobs", 0) + len(flat)
        stats["rescue_applied"] = stats.get("rescue_applied", 0) + n_sw
    return n_sw


# ---------------------------------------------------------------- pairing --

def mem_pair(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
             a: list[list[AlnReg]], id_: int,
             n_pri: list[int]) -> tuple[int, int, int, list[int]]:
    """Select the best proper pair (reference: src/bwamem_pair.c:190-251).
    Returns (o, sub, n_sub, z) with o=0 when no proper pair exists."""
    l_pac = idx.l_pac
    v: list[tuple[int, int]] = []
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | (x - idx.ann.offsets[e.rid])
            y = (e.score << 32) | (i << 2) | (int(e.rb >= l_pac) << 1) | r
            v.append((x, y))
    v.sort()
    y_last = [-1, -1, -1, -1]
    u: list[tuple[int, int]] = []
    for i in range(len(v)):
        for r in range(2):
            dr = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dr].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y_last[which] < 0:
                continue
            for k in range(y_last[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dr].high:
                    break
                if dist < pes[dr].low:
                    continue
                ns = (dist - pes[dr].avg) / max(pes[dr].std, 1e-6)
                prior = 2.0 * math.erfc(min(abs(ns) * (2 ** -0.5), 30.0))
                if prior > 0.0:
                    q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                            + 0.721 * math.log(prior) * opt.a + 0.499)
                else:  # erfc underflow: C's log(0) = -inf clamps to 0
                    q = 0
                q = max(q, 0)
                yp = ((k << 32) | i) & _M64
                xp = (q << 32) | (hash_64((yp ^ ((id_ << 8) & _M64)) & _M64)
                                 & 0xFFFFFFFF)
                u.append((xp, yp))
        y_last[v[i][1] & 3] = i
    if not u:
        return 0, 0, 0, [0, 0]
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    bi = u[-1][1] >> 32
    bk = u[-1][1] & 0xFFFFFFFF
    z = [0, 0]
    z[v[bi][1] & 1] = (v[bi][1] >> 2) & 0x3FFFFFFF
    z[v[bk][1] & 1] = (v[bk][1] >> 2) & 0x3FFFFFFF
    ret = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = sum(1 for x in u[:-1] if sub - (x[0] >> 32) <= tmp)
    return ret, sub, n_sub, z


def raw_mapq(diff: int, a: int) -> int:
    """reference: src/bwamem_pair.c:255."""
    return int(6.02 * diff / a + 0.499)


class Reg2AlnCtx:
    """Deferred-solve context for mem_reg2aln requests: plan phases
    register (l_query, query, ar) items, solve() runs ONE native batch
    (samgen.reg2aln_batch), render phases read results by handle."""

    def __init__(self, opt: MemOptions, idx: FMIndex):
        self.opt = opt
        self.idx = idx
        self.items: list = []
        self.out: list | None = None

    def add(self, l_query: int, query, ar) -> int:
        self.items.append((l_query, query, ar))
        return len(self.items) - 1

    def solve(self) -> None:
        from .samgen import reg2aln_batch

        self.out = reg2aln_batch(self.opt, self.idx, self.items)

    def get(self, h: int):
        return self.out[h]


def mem_sam_pe_plan(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
                    id_: int, names: list[str], seqs: list[np.ndarray],
                    quals: list, a: list[list[AlnReg]],
                    ctx: Reg2AlnCtx, comments=None) -> dict:
    """Phase A of mem_sam_pe (reference: src/bwamem_pair.c:257-397): all
    pairing decisions and region mutations; every needed mem_reg2aln is
    registered on ctx instead of being solved inline."""
    from .samgen import _get_pri_idx

    n_pri = [0, 0]
    for i in (0, 1):
        a[i], n_pri[i] = mem_mark_primary_se(opt, a[i], (id_ << 1) | i)
    plan = {"mode": "nopair", "a": a, "n_pri": n_pri, "names": names,
            "seqs": seqs, "quals": quals, "comments": comments,
            "pes": pes}

    def fail():
        # defer the two single-end representative alignments
        h_hdl = []
        for i in (0, 1):
            which = -1
            if a[i]:
                if a[i][0].score >= opt.T:
                    which = 0
                elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                    which = n_pri[i]
            reg = a[i][which] if which >= 0 else None
            h_hdl.append(ctx.add(len(seqs[i]), seqs[i], reg))
        plan["h_hdl"] = h_hdl
        return plan

    if opt.flag & MEM_F_NOPAIRING:
        return fail()
    if not (n_pri[0] and n_pri[1]):
        return fail()
    o, subo, n_sub, z = mem_pair(opt, idx, pes, a, id_, n_pri)
    if o <= 0:
        return fail()
    for i in (0, 1):
        if any(a[i][j].secondary < 0 and a[i][j].score >= opt.T
               for j in range(1, n_pri[i])):
            return fail()
    extra_flag = 1
    score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
    subo = max(subo, score_un)
    q_pe = raw_mapq(o - subo, opt.a)
    if n_sub > 0:
        q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
    q_pe = min(max(q_pe, 0), 60)
    q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep + a[1][0].frac_rep))
               + 0.499)
    q_se = [0, 0]
    if o > score_un:  # paired alignment preferred
        c = [a[0][z[0]], a[1][z[1]]]
        for i in (0, 1):
            if c[i].secondary >= 0:
                c[i].sub = a[i][c[i].secondary].score
                c[i].secondary = -2
            q_se[i] = mem_approx_mapq_se(opt, c[i])
        for i in (0, 1):
            if q_se[i] <= q_pe:
                q_se[i] = q_pe if q_pe < q_se[i] + 40 else q_se[i] + 40
            q_se[i] = min(q_se[i], raw_mapq(c[i].score - c[i].csub, opt.a))
        extra_flag |= 2
    else:  # unpaired preferred
        z = [0, 0]
        q_se[0] = mem_approx_mapq_se(opt, a[0][0])
        q_se[1] = mem_approx_mapq_se(opt, a[1][0])
    # promote the chosen hit to primary if it was a secondary of a non-ALT
    for i in (0, 1):
        k = a[i][z[i]].secondary_all
        if 0 <= k < n_pri[i]:
            for j in range(len(a[i])):
                if a[i][j].secondary_all == k or j == k:
                    a[i][j].secondary_all = z[i]
            a[i][z[i]].secondary_all = -1
    # XA selection (mem_gen_alt structure; numerics deferred)
    xa_picks = [None, None]
    if not (opt.flag & MEM_F_ALL):
        for i in (0, 1):
            regs = a[i]
            n = len(regs)
            cnt = [0] * n
            has_alt = [False] * n
            tot = 0
            for j in range(n):
                r = _get_pri_idx(opt.XA_drop_ratio, regs, j)
                if r >= 0:
                    cnt[r] += 1
                    tot += 1
                    if regs[j].is_alt:
                        has_alt[r] = True
            picks = []
            if tot:
                for j in range(n):
                    r = _get_pri_idx(opt.XA_drop_ratio, regs, j)
                    if r < 0:
                        continue
                    if cnt[r] > opt.max_XA_hits_alt or \
                            (not has_alt[r] and cnt[r] > opt.max_XA_hits):
                        continue
                    picks.append((j, r,
                                  ctx.add(len(seqs[i]), seqs[i], regs[j])))
            xa_picks[i] = picks
    h_hdl = [ctx.add(len(seqs[i]), seqs[i], a[i][z[i]]) for i in (0, 1)]
    supp_hdl = [None, None]
    for i in (0, 1):
        if n_pri[i] < len(a[i]):
            pr = a[i][n_pri[i]]
            if pr.score >= opt.T and pr.secondary < 0 and pr.is_alt:
                supp_hdl[i] = ctx.add(len(seqs[i]), seqs[i], pr)
    plan.update(mode="pair", z=z, q_se=q_se, extra_flag=extra_flag,
                xa_picks=xa_picks, h_hdl=h_hdl, supp_hdl=supp_hdl)
    return plan


def mem_sam_pe_render(opt: MemOptions, idx: FMIndex, plan: dict,
                      ctx: Reg2AlnCtx,
                      rg_id=None) -> tuple[list[str], list[str]]:
    """Phase C of mem_sam_pe: assemble SAM lines from solved alignments."""
    from .samgen import CIGAR_CHARS, mem_aln2sam, mem_reg2sam

    a = plan["a"]
    names, seqs, quals = plan["names"], plan["seqs"], plan["quals"]
    comments = plan["comments"]
    n_pri = plan["n_pri"]
    if plan["mode"] == "nopair":
        pes = plan["pes"]
        extra_flag = 1
        h = [ctx.get(plan["h_hdl"][i]) for i in (0, 1)]
        if not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid \
                and h[0].rid >= 0:
            d, dist = mem_infer_dir(idx.l_pac, a[0][0].rb, a[1][0].rb)
            if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
                extra_flag |= 2
        l0 = mem_reg2sam(opt, idx, names[0], seqs[0], quals[0], a[0],
                         extra_flag=0x41 | extra_flag, mate=h[1],
                         rg_id=rg_id,
                         comment=comments[0] if comments else None)
        l1 = mem_reg2sam(opt, idx, names[1], seqs[1], quals[1], a[1],
                         extra_flag=0x81 | extra_flag, mate=h[0],
                         rg_id=rg_id,
                         comment=comments[1] if comments else None)
        return l0, l1

    z, q_se = plan["z"], plan["q_se"]
    extra_flag = plan["extra_flag"]
    XA = [None, None]
    if not (opt.flag & MEM_F_ALL):
        for i in (0, 1):
            parts = [[] for _ in range(len(a[i]))]
            for (j, r, hdl) in plan["xa_picks"][i]:
                t = ctx.get(hdl)
                cig = "".join(f"{ln}{CIGAR_CHARS[op]}"
                              for op, ln in t.cigar)
                parts[r].append(
                    f"{idx.ann.names[t.rid]},{'+-'[t.is_rev]}{t.pos + 1},"
                    f"{cig},{t.NM};")
            XA[i] = ["".join(pt) if pt else None for pt in parts]
    h = [None, None]
    aa: list[list] = [[], []]
    for i in (0, 1):
        h[i] = ctx.get(plan["h_hdl"][i])
        h[i].mapq = q_se[i]
        h[i].flag |= (0x40 << i) | extra_flag
        h[i].XA = XA[i][z[i]] if XA[i] else None
        aa[i].append(h[i])
        if plan["supp_hdl"][i] is not None:
            g = ctx.get(plan["supp_hdl"][i])
            g.flag |= 0x800 | (0x40 << i) | extra_flag
            g.XA = XA[i][n_pri[i]] if XA[i] else None
            aa[i].append(g)
    lines = [[], []]
    for i in (0, 1):
        for w in range(len(aa[i])):
            lines[i].append(
                mem_aln2sam(opt, idx, names[i], seqs[i], quals[i],
                            len(aa[i]), aa[i], w, h[1 - i], rg_id=rg_id,
                            comment=comments[i] if comments else None))
    return lines[0], lines[1]


def mem_sam_pe_finalize(opt: MemOptions, idx: FMIndex, pes: list[PEStat],
                        id_: int, names: list[str],
                        seqs: list[np.ndarray], quals: list,
                        a: list[list[AlnReg]],
                        rg_id=None,
                        comments=None) -> tuple[list[str], list[str]]:
    """Pairing + SAM for one pair, after rescue (reference:
    src/bwamem_pair.c:257-397 mem_sam_pe, minus the rescue block which
    runs batched in mem_pe_rescue_batch). Thin wrapper over
    plan/solve/render; slice-level callers (hostpool._emit_pe) share one
    ctx across many pairs for a single native solve."""
    ctx = Reg2AlnCtx(opt, idx)
    plan = mem_sam_pe_plan(opt, idx, pes, id_, names, seqs, quals, a, ctx,
                           comments=comments)
    ctx.solve()
    return mem_sam_pe_render(opt, idx, plan, ctx, rg_id=rg_id)
