"""Seed chaining and chain filtering (host side).

Port of the reference's chaining semantics (reference: src/bwamem.c:317-559
mem_chain / test_and_merge / mem_chain_weight / mem_chain_flt), consuming
the device seeding output. The reference keeps chains in a B-tree keyed by
the first seed's rbeg and merges each new seed into its closest
lower-or-equal chain only; we keep a sorted list + bisect, which reproduces
that nearest-lower lookup.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

from ..index.format import FMIndex
from .options import MemOptions


@dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int  # initially = len (occurrence count lives on the group head)
    sw_scored: bool = False  # True once the SW seed filter set a real score
    #   (reference keeps score=-1 until mem_seed_sw, src/bwamem.c:982)


@dataclass
class Chain:
    pos: int                 # rbeg of the first seed (B-tree key)
    rid: int
    seeds: list[Seed]
    is_alt: bool = False
    frac_rep: float = 0.0
    w: int = 0
    kept: int = 0
    first: int = -1


def depos(l_pac: int, pos: int) -> tuple[int, bool]:
    """Doubled -> forward coordinates (reference: src/bntseq.h bns_depos)."""
    is_rev = pos >= l_pac
    return ((l_pac << 1) - 1 - pos) if is_rev else pos, is_rev


def pos2rid(idx: FMIndex, pos: int) -> int:
    return idx.ann.pos_to_rid(pos)


def intv2rid(idx: FMIndex, rb: int, re: int) -> int:
    """reference: src/bntseq.c bns_intv2rid — -1/-2 when the interval
    bridges sequences or the forward-reverse boundary."""
    l_pac = idx.l_pac
    if rb < l_pac < re:
        return -2
    rid_b = pos2rid(idx, depos(l_pac, rb)[0])
    rid_e = pos2rid(idx, depos(l_pac, re - 1)[0]) if rb < re else rid_b
    return rid_b if rid_b == rid_e else -1


def _test_and_merge(opt: MemOptions, l_pac: int, c: Chain, s: Seed,
                    rid: int) -> bool:
    """reference: src/bwamem.c:337-359."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if rid != c.rid:
        return False
    if (s.qbeg >= c.seeds[0].qbeg and s.qbeg + s.len <= qend
            and s.rbeg >= c.seeds[0].rbeg and s.rbeg + s.len <= rend):
        return True  # contained seed
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and s.rbeg >= l_pac:
        return False  # different strand
    x = s.qbeg - last.qbeg
    y = s.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(s)
        return True
    return False


def chain_batch_raw(opt: MemOptions, idx: FMIndex, l_queries: list[int],
                    per_read_seeds, seed_arrays: dict | None = None):
    """Native chaining returning the raw flat arrays (chain table +
    kept-seed arrays) for zero-object downstream consumption; None when
    the native lib is unavailable. `seed_arrays` (from
    seed_batch_arrays) avoids the tuple round-trip."""
    import numpy as np

    from ..native import loader

    lib = loader.try_load()
    if lib is None:
        return None

    import ctypes

    n_reads = len(l_queries)
    if seed_arrays is not None:
        qb = np.ascontiguousarray(seed_arrays["qbeg"], np.int32)
        qe = np.ascontiguousarray(seed_arrays["qend"], np.int32)
        rb = np.ascontiguousarray(seed_arrays["rbeg"], np.int64)
        oc = np.ascontiguousarray(seed_arrays["n_occ"], np.int64)
        bounds = np.ascontiguousarray(seed_arrays["bounds"], np.int64)
        n = len(qb)
    else:
        flat = [t for sl in per_read_seeds for t in sl]
        n = len(flat)
        bounds = np.zeros(n_reads + 1, np.int64)
        for b in range(n_reads):
            bounds[b + 1] = bounds[b] + len(per_read_seeds[b])
        qb = np.fromiter((t[0] for t in flat), np.int32, n)
        qe = np.fromiter((t[1] for t in flat), np.int32, n)
        rb = np.fromiter((t[2] for t in flat), np.int64, n)
        oc = np.fromiter((t[3] for t in flat), np.int64, n)
    lq = np.asarray(l_queries, np.int32)
    ann_off = np.asarray(idx.ann.offsets, np.int64)
    ann_alt = np.asarray(
        [1 if idx.ann.alt_of(r) else 0 for r in range(len(ann_off))],
        np.int8)

    seed_cap = max(n * 2, 64)
    chain_cap = max(n, 64)
    while True:
        o_srb = np.empty(seed_cap, np.int64)
        o_sqb = np.empty(seed_cap, np.int32)
        o_sln = np.empty(seed_cap, np.int32)
        o_crd = np.empty(chain_cap, np.int32)
        o_rid = np.empty(chain_cap, np.int32)
        o_w = np.empty(chain_cap, np.int32)
        o_kept = np.empty(chain_cap, np.int32)
        o_off = np.empty(chain_cap, np.int64)
        o_ns = np.empty(chain_cap, np.int32)
        o_fr = np.empty(chain_cap, np.float64)
        counts = np.zeros(3, np.int64)
        p32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        pdb = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        p8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        lib.bm_chain_batch(
            p32(qb), p32(qe), p64(rb), p64(oc), p64(bounds), n_reads,
            p32(lq), p64(ann_off), p8(ann_alt), len(ann_off), idx.l_pac,
            opt.w, opt.max_chain_gap, opt.max_occ, opt.min_seed_len,
            opt.mask_level, opt.drop_ratio, opt.min_chain_weight,
            min(opt.max_chain_extend, 1 << 62),
            p64(o_srb), p32(o_sqb), p32(o_sln), seed_cap,
            p32(o_crd), p32(o_rid), p32(o_w), p32(o_kept), p64(o_off),
            p32(o_ns), pdb(o_fr), chain_cap,
            p64(counts))
        if not counts[2]:
            break
        seed_cap *= 2
        chain_cap *= 2

    return dict(n_chains=int(counts[0]), n_seeds=int(counts[1]),
                c_read=o_crd, c_rid=o_rid, c_w=o_w, c_kept=o_kept,
                c_soff=o_off, c_ns=o_ns, c_frac=o_fr,
                s_rbeg=o_srb, s_qbeg=o_sqb, s_len=o_sln)


def chain_batch(opt: MemOptions, idx: FMIndex, l_queries: list[int],
                per_read_seeds) -> list[list[Chain]]:
    """Chain + filter a whole batch: native C++ core when available
    (native/chain.cpp — GIL-free, one call per chunk), Python fallback
    otherwise. Both produce identical chains (tests/test_native_chain.py).
    """
    raw = chain_batch_raw(opt, idx, l_queries, per_read_seeds)
    if raw is None:
        return [mem_chain_flt(opt, mem_chain(opt, idx, l_queries[b],
                                             per_read_seeds[b]))
                for b in range(len(l_queries))]
    out: list[list[Chain]] = [[] for _ in range(len(l_queries))]
    for ci in range(raw["n_chains"]):
        off, ns = int(raw["c_soff"][ci]), int(raw["c_ns"][ci])
        seeds = [Seed(rbeg=int(raw["s_rbeg"][off + t]),
                      qbeg=int(raw["s_qbeg"][off + t]),
                      len=int(raw["s_len"][off + t]),
                      score=int(raw["s_len"][off + t]))
                 for t in range(ns)]
        rid_i = int(raw["c_rid"][ci])
        c = Chain(pos=seeds[0].rbeg, rid=rid_i, seeds=seeds,
                  frac_rep=float(raw["c_frac"][ci]), w=int(raw["c_w"][ci]),
                  kept=int(raw["c_kept"][ci]), is_alt=idx.ann.alt_of(rid_i))
        out[int(raw["c_read"][ci])].append(c)
    return out


def mem_chain(opt: MemOptions, idx: FMIndex, l_query: int,
              seeds) -> list[Chain]:
    """Build chains from the device seed list for one read.

    `seeds` is an iterable of (qbeg, qend, rbeg, n_occ) in group order
    (group = one SMEM; consecutive entries of a group share qbeg/qend).
    reference: src/bwamem.c:404-477.
    """
    if l_query < opt.min_seed_len:
        return []
    l_pac = idx.l_pac

    # group the flat seed list back into SMEM groups (consecutive same
    # (qbeg,qend)); the device already applied the occurrence subsampling.
    groups: list[tuple[int, int, int, list[int]]] = []
    for qbeg, qend, rbeg, n_occ in seeds:
        if groups and groups[-1][0] == qbeg and groups[-1][1] == qend:
            groups[-1][3].append(rbeg)
        else:
            groups.append((qbeg, qend, n_occ, [rbeg]))

    # frac_rep: union of query spans of groups with n_occ > max_occ
    b = e = l_rep = 0
    for qbeg, qend, n_occ, _ in groups:
        if n_occ <= opt.max_occ:
            continue
        if qbeg > e:
            l_rep += e - b
            b, e = qbeg, qend
        else:
            e = max(e, qend)
    l_rep += e - b

    chains: list[Chain] = []          # kept sorted by .pos
    keys: list[int] = []
    for qbeg, qend, n_occ, rbegs in groups:
        slen = qend - qbeg
        for rbeg in rbegs:
            s = Seed(rbeg=rbeg, qbeg=qbeg, len=slen, score=slen)
            rid = intv2rid(idx, rbeg, rbeg + slen)
            if rid < 0:
                continue
            to_add = False
            if chains:
                j = bisect.bisect_right(keys, rbeg) - 1
                if j < 0 or not _test_and_merge(opt, l_pac, chains[j], s, rid):
                    to_add = True
            else:
                to_add = True
            if to_add:
                c = Chain(pos=rbeg, rid=rid, seeds=[s],
                          is_alt=idx.ann.alt_of(rid))
                j = bisect.bisect_right(keys, rbeg)
                keys.insert(j, rbeg)
                chains.insert(j, c)

    fr = l_rep / l_query if l_query else 0.0
    for c in chains:
        c.frac_rep = fr
    return chains


def chain_weight(c: Chain) -> int:
    """min(query coverage, ref coverage) (reference: src/bwamem.c:361-384)."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return min(w, (1 << 30) - 1)


def mem_chain_flt(opt: MemOptions, chains: list[Chain]) -> list[Chain]:
    """reference: src/bwamem.c:488-559."""
    if not chains:
        return []
    kept_chains = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            kept_chains.append(c)
    if not kept_chains:
        return []
    a = sorted(kept_chains, key=lambda c: -c.w)  # stable, weight descending

    def chn_beg(c):
        return c.seeds[0].qbeg

    def chn_end(c):
        return c.seeds[-1].qbeg + c.seeds[-1].len

    a[0].kept = 3
    kept_idx = [0]
    for i in range(1, len(a)):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(chn_beg(a[j]), chn_beg(a[i]))
            e_min = min(chn_end(a[j]), chn_end(a[i]))
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = chn_end(a[i]) - chn_beg(a[i])
                lj = chn_end(a[j]) - chn_beg(a[j])
                min_l = min(li, lj)
                if (e_min - b_max >= min_l * opt.mask_level
                        and min_l < opt.max_chain_gap):
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (a[i].w < a[j].w * opt.drop_ratio
                            and a[j].w - a[i].w >= opt.min_seed_len << 1):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of kept=1/2 chains at max_chain_extend
    k = 0
    cut = len(a)
    for i, c in enumerate(a):
        if c.kept in (0, 3):
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i
            break
    for c in a[cut:]:
        if c.kept < 3:
            c.kept = 0
    return [c for c in a if c.kept != 0]
