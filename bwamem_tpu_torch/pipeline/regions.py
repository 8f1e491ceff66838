"""Alignment regions: dedup/patch, primary marking, mapQ.

Ports of the reference's post-extension region logic (reference:
src/bwamem.c:580-761 mem_patch_reg / mem_sort_dedup_patch /
mem_mark_primary_se, :1690-1717 mem_approx_mapq_se), including the exact
sort keys and hash-based tie-breaking.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..index.format import FMIndex
from ..ops.globalalign import ksw_global
from .options import (MemOptions, MEM_MAPQ_COEF, PATCH_MAX_R_BW,
                      PATCH_MIN_SC_RATIO, hash_64)


@dataclass(slots=True)
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: bool = False
    frac_rep: float = 0.0
    hash: int = 0
    # fork staging fields (estimated extents for the contained-seed test,
    # reference src/bwamem.h:82-112 / src/bwamem.c:1284-1298)
    qb_est: int = 0
    qe_est: int = 0
    rb_est: int = 0
    re_est: int = 0
    align_sides: int = 0
    where_is_long: int = 0
    query_seed_begin: int = 0
    target_seed_begin: int = 0
    part: list = field(default_factory=lambda: [[0, 0, 0], [0, 0, 0]])
    _chain_seeds: list = field(default_factory=list)
    # part[side] = [score, query_end, ref_end]


def _gen_cigar_score(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                     rb: int, re: int, w: int) -> int:
    """Score-only banded global alignment over [rb, re) in doubled coords
    (the mem_patch_reg probe; reference calls bwa_gen_cigar2 with
    n_cigar=0, src/bwamem.c:612)."""
    from .samgen import fetch_ref_window  # local import to avoid a cycle

    rseq, _ = fetch_ref_window(idx, rb, re)
    q = query
    if rb >= idx.l_pac:
        q = q[::-1]
        rseq = rseq[::-1]
    score, _ = ksw_global(q, rseq, opt.mat, opt.o_del, opt.e_del,
                          opt.o_ins, opt.e_ins, w, want_cigar=False)
    return score


def mem_patch_reg(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                  a: AlnReg, b: AlnReg):
    """reference: src/bwamem.c:580-618. Returns (score, w) or None."""
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < idx.l_pac and b.rb >= idx.l_pac:
        return None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return None
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return None
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return None
    w += a.w + b.w
    w = min(w, opt.w << 2)
    score = _gen_cigar_score(opt, idx, query[a.qb:b.qe], a.rb, b.re, w)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return None
    return score, w


def mem_sort_dedup_patch(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                         regs: list[AlnReg],
                         patch: bool = True) -> list[AlnReg]:
    """reference: src/bwamem.c:620-680. With patch=False runs dedup only
    (the mem_matesw call passes null bns/pac, src/bwamem_pair.c:183)."""
    n = len(regs)
    if n <= 1:
        return regs
    a = sorted(regs, key=lambda r: r.re)  # sort by END position
    for r in a:
        r.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        for j in range(i - 1, -1, -1):
            q = a[j]
            if not (p.rid == q.rid and p.rb < q.re + opt.max_chain_gap):
                break
            if q.qe == q.qb:
                continue  # excluded
            pr = q.re - p.rb
            pq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if pr > opt.mask_level_redun * mr and pq > opt.mask_level_redun * mq:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb:
                res = mem_patch_reg(opt, idx, query, q, p) if patch else None
                if res is not None:
                    score, w = res
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [r for r in a if r.qe > r.qb]
    # sort by score desc, then rb, then qb (reference alnreg_slt)
    a.sort(key=lambda r: (-r.score, r.rb, r.qb))
    for i in range(1, len(a)):
        if (a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb
                and a[i].qb == a[i - 1].qb):
            a[i].qe = a[i].qb
    return [r for i, r in enumerate(a) if i == 0 or r.qe > r.qb]


def _mark_primary_core(opt: MemOptions, a: list[AlnReg]) -> None:
    """reference: src/bwamem.c:686-713 mem_mark_primary_se_core."""
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z: list[int] = [0]
    for i in range(1, len(a)):
        placed = False
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if (a[k].score - a[i].score <= tmp
                            and (a[k].is_alt or not a[i].is_alt)):
                        a[k].sub_n += 1
                    a[i].secondary = k
                    placed = True
                    break
        if not placed:
            z.append(i)


def mem_mark_primary_se(opt: MemOptions, regs: list[AlnReg],
                        read_id: int) -> tuple[list[AlnReg], int]:
    """reference: src/bwamem.c:715-761. Returns (sorted regs, n_pri)."""
    n = len(regs)
    if n == 0:
        return regs, 0
    n_pri = 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64(read_id + i)
        if not r.is_alt:
            n_pri += 1
    # sort: score desc, is_alt asc, hash asc (reference alnreg_hlt)
    regs.sort(key=lambda r: (-r.score, r.is_alt, r.hash))
    _mark_primary_core(opt, regs)
    for i, p in enumerate(regs):
        p.secondary_all = i
        if not p.is_alt and p.secondary >= 0 and regs[p.secondary].is_alt:
            p.alt_sc = regs[p.secondary].score
    if 0 <= n_pri < n:
        z = [0] * n
        if n_pri > 0:
            regs.sort(key=lambda r: (r.is_alt, -r.score, r.hash))
        for i, r in enumerate(regs):
            z[r.secondary_all] = i
        for r in regs:
            if r.secondary >= 0:
                r.secondary_all = z[r.secondary]
                if r.is_alt:
                    r.secondary = 1 << 30
            else:
                r.secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                regs[i].sub = 0
                regs[i].secondary = -1
            _mark_primary_core(opt, regs[:n_pri])
    else:
        for r in regs:
            r.secondary_all = r.secondary
    return regs, n_pri


def mem_approx_mapq_se(opt: MemOptions, a: AlnReg) -> int:
    """reference: src/bwamem.c:1690-1717."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score)
                   * math.log(max(a.seedcov, 1)) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq
