"""Per-seed filtering between chain filtering and extension, batched.

Two variants, matching the reference's dispatch (src/bwamem.c:2071-2073):
  * default: SW test of a +-50bp window around each seed against
    min_HSP_score (reference: mem_flt_chained_seeds src/bwamem.c:970-990 +
    mem_seed_sw :774-807) — a no-op for short reads, active for long ones;
  * -F: shifted-Hamming-distance test of the 128-bp flanks
    (reference: mem_shd_flt_chained_seeds src/bwamem.c:809-969).

The reference runs one SSE call per seed inside the per-read loop; here
every window of the whole chunk goes through ONE batched device launch
(ops/swalign or ops/shd).

Port of bwamem_tpu/pipeline/seedflt.py: the same job construction and
survivorship, with the batched launch on a torch device — the SW filter
on ops/swalign.sw_align_batch (the local-SW kernel on CUDA, its plain
version on the CPU), -F on ops/shd.shd_filter_batch. Job counts are not
padded to a bucket: the launches take any count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..index.format import FMIndex
from ..ops.shd import shd_filter_batch
from ..ops.swalign import sw_align_batch
from ..utils import timing
from .chain import Chain
from .options import (MemOptions, MEM_HSP_COEF, MEM_MINSC_COEF,
                      MEM_SEEDSW_COEF, MEM_SHORT_EXT, MEM_SHORT_LEN)

SHD_WIN = 128     # flank window (reference: src/bwamem.c:833)
SHD_OVL = 5       # flank starts 5bp inside the seed (reference: :832)
SHD_MAX_ERR = 7   # reference: :889


@dataclass
class _SWJob:
    chain: Chain
    seed_idx: int
    query_w: np.ndarray
    rseq: np.ndarray


@dataclass
class _SHDJob:
    chain: Chain
    seed_idx: int
    side: int          # 0 = right, 1 = left
    read_w: np.ndarray
    ref_w: np.ndarray


class SeedFilterBatch:
    """Collects filter jobs across a chunk, runs one device launch, then
    applies survivorship back onto the chains."""

    def __init__(self, opt: MemOptions, idx: FMIndex, device="cuda"):
        self.opt = opt
        self.idx = idx
        self.device = torch.device(device)
        self.sw_jobs: list[_SWJob] = []
        self.shd_jobs: list[_SHDJob] = []
        self._sw_min: dict[int, float] = {}

    # ---------------- job construction (per read) ----------------

    def add_read(self, l_query: int, query: np.ndarray,
                 chains: list[Chain]) -> None:
        if self.opt.shd_filter:
            self._add_shd(l_query, query, chains)
        else:
            self._add_sw(l_query, query, chains)

    def _add_sw(self, l_query: int, query: np.ndarray,
                chains: list[Chain]) -> None:
        opt, idx = self.opt, self.idx
        min_l = (MEM_HSP_COEF * opt.min_chain_weight
                 if opt.min_chain_weight else MEM_MINSC_COEF
                 * math.log(l_query))
        if min_l > MEM_SEEDSW_COEF * l_query:
            return  # short read: filter disabled (reference :976)
        l_pac = idx.l_pac
        for c in chains:
            for j, s in enumerate(c.seeds):
                # untested seeds of a filtered read score len * opt.a
                # (mem_seed_sw returns -1 -> reference :984 rescale);
                # a != 1 would otherwise sort them against SW-scored
                # seeds on a different scale in chain2aln's srt order
                if s.len >= MEM_SHORT_LEN:
                    s.score = s.len * opt.a
                    s.sw_scored = True
                    continue
                qb = max(s.qbeg - MEM_SHORT_EXT, 0)
                qe = min(s.qbeg + s.len + MEM_SHORT_EXT, l_query)
                rb = max(s.rbeg - MEM_SHORT_EXT, 0)
                re = min(s.rbeg + s.len + MEM_SHORT_EXT, l_pac << 1)
                mid = (s.rbeg + s.rbeg + s.len) >> 1
                if rb < l_pac < re:
                    if mid < l_pac:
                        re = l_pac
                    else:
                        rb = l_pac
                if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
                    s.score = s.len * opt.a
                    s.sw_scored = True
                    continue
                rb, re, rseq, _ = idx.fetch_seq_rid(rb, re, mid=mid)
                self.sw_jobs.append(_SWJob(
                    chain=c, seed_idx=j,
                    query_w=np.asarray(query[qb:qe], np.int32),
                    rseq=rseq.astype(np.int32)))
                self._sw_min[id(c)] = int(opt.a * min_l + 0.499)

    def _windows(self, seq: np.ndarray, beg: int, end: int,
                 reverse: bool) -> np.ndarray:
        w = np.asarray(seq[beg:end], np.int32)
        return w[::-1].copy() if reverse else w

    def _add_shd(self, l_query: int, query: np.ndarray,
                 chains: list[Chain]) -> None:
        idx = self.idx
        l_pac = idx.l_pac
        for c in chains:
            for j, s in enumerate(c.seeds):
                qb, qe = s.qbeg, s.qbeg + s.len
                rb, re = s.rbeg, s.rbeg + s.len
                if qe < l_query:  # right flank (reference :829-896)
                    qbeg = max(qe - SHD_OVL, 0)
                    qend = min(qbeg + SHD_WIN, l_query)
                    rbeg = max(re - SHD_OVL, 0)
                    rend = min(rbeg + SHD_WIN, l_pac << 1)
                    mid = (rbeg + rend) >> 1
                    if rbeg < l_pac < rend:
                        if mid < l_pac:
                            rend = l_pac
                        else:
                            rbeg = l_pac
                    rbeg, rend, rseq, _ = idx.fetch_seq_rid(rbeg, rend, mid)
                    self.shd_jobs.append(_SHDJob(
                        c, j, 0, self._windows(query, qbeg, qend, False),
                        rseq.astype(np.int32)))
                if qb > 0:        # left flank, reversed (reference :897-957)
                    qend = min(qb + SHD_OVL, l_query)
                    qbeg = max(qend - SHD_WIN, 0)
                    rend = min(rb + SHD_OVL, l_pac << 1)
                    rbeg = max(rend - SHD_WIN, 0)
                    mid = (rbeg + rend) >> 1
                    if rbeg < l_pac < rend:
                        if mid < l_pac:
                            rend = l_pac
                        else:
                            rbeg = l_pac
                    rbeg, rend, rseq, _ = idx.fetch_seq_rid(rbeg, rend, mid)
                    self.shd_jobs.append(_SHDJob(
                        c, j, 1, self._windows(query, qbeg, qend, True),
                        rseq[::-1].astype(np.int32)))

    # ---------------- batched execution + application ----------------

    def run(self) -> None:
        if self.opt.shd_filter:
            self._run_shd()
        else:
            self._run_sw()

    def _run_sw(self) -> None:
        jobs = self.sw_jobs
        if not jobs:
            return
        scores = _sw_scores(self.opt, [(j.query_w, j.rseq) for j in jobs],
                            self.device)
        # group survivors per chain
        drop: dict[int, set[int]] = {}
        for i, j in enumerate(jobs):
            min_hsp = self._sw_min[id(j.chain)]
            sc = int(scores[i])
            if sc < min_hsp:
                drop.setdefault(id(j.chain), set()).add(j.seed_idx)
            else:
                j.chain.seeds[j.seed_idx].score = sc
                j.chain.seeds[j.seed_idx].sw_scored = True
        self._apply_drops(drop, {id(j.chain): j.chain for j in jobs})
        self.sw_jobs.clear()

    def _run_shd(self) -> None:
        jobs = self.shd_jobs
        if not jobs:
            return
        ok = _shd_pass([(j.read_w, j.ref_w) for j in jobs], self.device)
        # a seed survives if ANY tested side passes; untested side = pass
        verdict: dict[tuple[int, int], bool] = {}
        chains: dict[int, Chain] = {}
        for i, j in enumerate(jobs):
            key = (id(j.chain), j.seed_idx)
            verdict[key] = verdict.get(key, False) or bool(ok[i])
            chains[id(j.chain)] = j.chain
        drop: dict[int, set[int]] = {}
        for (cid, sidx), passed in verdict.items():
            if not passed:
                drop.setdefault(cid, set()).add(sidx)
        self._apply_drops(drop, chains)
        self.shd_jobs.clear()

    @staticmethod
    def _apply_drops(drop: dict[int, set[int]],
                     chains: dict[int, Chain]) -> None:
        for cid, idxs in drop.items():
            c = chains[cid]
            c.seeds = [s for j, s in enumerate(c.seeds) if j not in idxs]


def _sw_scores(opt: MemOptions, pairs, device) -> np.ndarray:
    """Local-SW scores of (query window, reference window) pairs of at
    most MEM_SHORT_LEN bases each, in one launch on `device` (minsc 0)."""
    N = len(pairs)
    Q = np.full((N, MEM_SHORT_LEN), 4, np.int8)
    T = np.full((N, MEM_SHORT_LEN), 4, np.int8)
    ql = np.zeros(N, np.int32)
    tl = np.zeros(N, np.int32)
    for i, (qw, rw) in enumerate(pairs):
        Q[i, : len(qw)] = qw
        T[i, : len(rw)] = rw
        ql[i], tl[i] = len(qw), len(rw)

    def up(a):
        return torch.from_numpy(a).to(device)

    out = sw_align_batch(up(Q), up(T), up(ql), up(tl),
                         up(np.asarray(opt.mat, np.int32)),
                         up(np.zeros(N, np.int32)), opt.o_del, opt.e_del,
                         opt.o_ins, opt.e_ins, opt.a)
    scores = out["score"].cpu().numpy()
    timing.count("host_syncs")
    return scores


def _shd_pass(pairs, device) -> np.ndarray:
    """SHD pass flags of (read window, reference window) pairs, compared
    over their common length (at most SHD_WIN), in one batch on
    `device`."""
    N = len(pairs)
    R = np.zeros((N, SHD_WIN), np.int8)
    F = np.zeros((N, SHD_WIN), np.int8)
    lens = np.zeros(N, np.int32)
    for i, (rd, rf) in enumerate(pairs):
        n = min(len(rd), len(rf), SHD_WIN)
        R[i, :n] = rd[:n]
        F[i, :n] = rf[:n]
        lens[i] = n
    ok = shd_filter_batch(torch.from_numpy(R).to(device),
                          torch.from_numpy(F).to(device),
                          torch.from_numpy(lens).to(device), SHD_MAX_ERR)
    ok = ok.cpu().numpy()
    timing.count("host_syncs")
    return ok


def _sw_window(idx: FMIndex, query, qb0: int, ln: int, rb0: int):
    """The +-MEM_SHORT_EXT windows of one seed for the SW filter
    (reference mem_seed_sw src/bwamem.c:774-807): (query window,
    reference window), or None when either reaches MEM_SHORT_LEN and the
    seed stays untested."""
    l_pac = idx.l_pac
    qb = max(qb0 - MEM_SHORT_EXT, 0)
    qe = min(qb0 + ln + MEM_SHORT_EXT, len(query))
    rb = max(rb0 - MEM_SHORT_EXT, 0)
    re_ = min(rb0 + ln + MEM_SHORT_EXT, l_pac << 1)
    mid = (rb0 + rb0 + ln) >> 1
    if rb < l_pac < re_:
        if mid < l_pac:
            re_ = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re_ - rb >= MEM_SHORT_LEN:
        return None
    rseq = idx.fetch_seq_rid(rb, re_, mid=mid)[2]
    return np.asarray(query[qb:qe], np.int32), rseq.astype(np.int32)


def _shd_flanks(idx: FMIndex, query, qb: int, ln: int, rb: int) -> list:
    """The SHD_WIN flanks of one seed for -F: (read window, reference
    window) of the right flank when the seed ends before the read does
    (reference :829-896), then of the left flank, both reversed, when it
    starts after the read's first base (reference :897-957)."""
    l_query, l_pac = len(query), idx.l_pac
    qe, re_ = qb + ln, rb + ln
    out = []
    if qe < l_query:
        qbeg = max(qe - SHD_OVL, 0)
        qend = min(qbeg + SHD_WIN, l_query)
        rbeg = max(re_ - SHD_OVL, 0)
        rend = min(rbeg + SHD_WIN, l_pac << 1)
        mid = (rbeg + rend) >> 1
        if rbeg < l_pac < rend:
            rend = l_pac if mid < l_pac else rend
            rbeg = rbeg if mid < l_pac else l_pac
        rseq = idx.fetch_seq_rid(rbeg, rend, mid)[2]
        out.append((np.asarray(query[qbeg:qend], np.int32),
                    rseq.astype(np.int32)))
    if qb > 0:
        qend = min(qb + SHD_OVL, l_query)
        qbeg = max(qend - SHD_WIN, 0)
        rend = min(rb + SHD_OVL, l_pac << 1)
        rbeg = max(rend - SHD_WIN, 0)
        mid = (rbeg + rend) >> 1
        if rbeg < l_pac < rend:
            rend = l_pac if mid < l_pac else rend
            rbeg = rbeg if mid < l_pac else l_pac
        rseq = idx.fetch_seq_rid(rbeg, rend, mid)[2]
        out.append((np.asarray(query[qbeg:qend], np.int32)[::-1].copy(),
                    rseq[::-1].astype(np.int32)))
    return out


def filter_seed_arrays(opt: MemOptions, idx: FMIndex, raw: dict,
                       seqs: list, device="cuda") -> None:
    """Per-seed SW/SHD filtering over chain_batch_raw's FLAT arrays —
    the native fast path's equivalent of SeedFilterBatch (so -F and
    long-read inputs no longer fall back to the per-seed object path).

    Mutates `raw` in place: adds `s_score` (SW-rescored short seeds,
    reference mem_seed_sw src/bwamem.c:774-807), drops failing seeds
    compacting the seed arrays + per-chain table, and drops emptied
    chains. One batched device launch per chunk on `device`, like the
    object path.
    """
    nC, nS = raw["n_chains"], raw["n_seeds"]
    if nC == 0 or nS == 0:
        return
    c_read = raw["c_read"][:nC]
    c_soff = raw["c_soff"][:nC]
    c_ns = raw["c_ns"][:nC]
    sq = raw["s_qbeg"][:nS]
    sr = raw["s_rbeg"][:nS]
    sl = raw["s_len"][:nS]
    s_score = sl.astype(np.int32).copy()
    keep = np.ones(nS, bool)
    # seed index -> owning read (chains are consecutive seed ranges)
    seed_read = np.repeat(c_read, c_ns)

    if opt.shd_filter:
        jobs: list[tuple[int, np.ndarray, np.ndarray]] = []  # (si, rd, rf)
        for si in range(nS):
            flanks = _shd_flanks(idx, seqs[seed_read[si]], int(sq[si]),
                                 int(sl[si]), int(sr[si]))
            jobs += [(si, rd, rf) for rd, rf in flanks]
            if flanks:
                keep[si] = False  # survives only if a side passes
        if jobs:
            ok = _shd_pass([(rd, rf) for _, rd, rf in jobs], device)
            for i, (si, _, _) in enumerate(jobs):
                keep[si] = keep[si] or bool(ok[i])
    else:
        # default SW filter — inactive for short reads (reference :976)
        min_hsp = np.zeros(len(seqs), np.int64)
        active = np.zeros(len(seqs), bool)
        for b, s in enumerate(seqs):
            lq = len(s)
            if lq < 1:
                continue
            min_l = (MEM_HSP_COEF * opt.min_chain_weight
                     if opt.min_chain_weight
                     else MEM_MINSC_COEF * math.log(lq))
            if min_l <= MEM_SEEDSW_COEF * lq:
                active[b] = True
                min_hsp[b] = int(opt.a * min_l + 0.499)
        # every seed of a filtered read is rescored: untested ones
        # (mem_seed_sw -1: long seed / oversized window) score
        # len * opt.a (reference :984); tested ones get their SW score
        # below. Seeds of inactive reads keep creation score = len.
        act_seed = active[seed_read]
        s_score[act_seed] = sl[act_seed].astype(np.int32) * opt.a
        sjobs: list[tuple[int, np.ndarray, np.ndarray]] = []
        for si in np.flatnonzero(active[seed_read]
                                 & (sl < MEM_SHORT_LEN)):
            si = int(si)
            win = _sw_window(idx, seqs[seed_read[si]], int(sq[si]),
                             int(sl[si]), int(sr[si]))
            if win is not None:
                sjobs.append((si, *win))
        if sjobs:
            scores = _sw_scores(opt, [(qw, rw) for _, qw, rw in sjobs],
                                device)
            for i, (si, _, _) in enumerate(sjobs):
                sc = int(scores[i])
                if sc < min_hsp[seed_read[si]]:
                    keep[si] = False
                else:
                    s_score[si] = sc

    if keep.all():
        raw["s_score"] = s_score
        return
    # compact seeds + chain table; drop emptied chains
    new_ns = np.array([int(keep[int(c_soff[i]):int(c_soff[i])
                                + int(c_ns[i])].sum())
                       for i in range(nC)], np.int32)
    ckeep = new_ns > 0
    order = np.flatnonzero(keep)
    raw["s_rbeg"] = sr[order].astype(np.int64)
    raw["s_qbeg"] = sq[order].astype(np.int32)
    raw["s_len"] = sl[order].astype(np.int32)
    raw["s_score"] = s_score[order]
    raw["n_seeds"] = len(order)
    soff_new = np.zeros(nC, np.int64)
    np.cumsum(new_ns[:-1], out=soff_new[1:])
    for key, arr in (("c_read", c_read), ("c_rid", raw["c_rid"][:nC]),
                     ("c_w", raw["c_w"][:nC]),
                     ("c_kept", raw["c_kept"][:nC]),
                     ("c_frac", raw["c_frac"][:nC])):
        raw[key] = arr[ckeep]
    raw["c_soff"] = soff_new[ckeep]
    raw["c_ns"] = new_ns[ckeep]
    raw["n_chains"] = int(ckeep.sum())
