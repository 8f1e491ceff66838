"""Final alignment records: CIGAR/NM/MD generation and SAM emission.

Ports of the reference's hit->SAM conversion (reference:
src/bwamem.c:2344-2438 mem_reg2aln, :1506-1688 mem_aln2sam,
src/bwa.c:111-217 bwa_gen_cigar2, src/bwamem_extra.c mem_gen_alt), with the
same band inference, band-doubling retry, leading/trailing-deletion squeeze,
clipping rules, NM/MD computation and tag set.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..index.format import FMIndex
from ..oracle.ksw import CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_S
from ..ops.globalalign import ksw_global
from .options import (MemOptions, MEM_F_SOFTCLIP, MEM_F_ALL,
                      MEM_F_NO_MULTI)

INT_MAX = 1 << 30
from .regions import AlnReg, mem_approx_mapq_se

CIGAR_CHARS = "MIDSH"
_FWD_BASES = "ACGTN"
_REV_BASES = "TGCAN"
_FWD_LUT = np.frombuffer(b"ACGTN", np.uint8)
_REV_LUT = np.frombuffer(b"TGCAN", np.uint8)


@dataclass
class MemAln:
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: bool = False
    is_alt: bool = False
    mapq: int = 0
    NM: int = -1
    cigar: list = field(default_factory=list)  # [(op, len)]
    md: str = ""
    score: int = 0
    sub: int = -1
    alt_sc: int = 0
    XA: str | None = None


def fetch_ref_window(idx: FMIndex, rb: int, re: int):
    """[rb, re) in doubled coords, single strand (reference: bns_get_seq)."""
    lp = idx.l_pac
    if rb < lp < re:
        raise ValueError("window bridges the forward-reverse boundary")
    b, e, seq = idx.fetch_seq(rb, re, mid=rb)
    assert b == rb and e == re
    return seq, rb >= lp


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """reference: src/bwamem.c:1483-1491."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar(opt: MemOptions, idx: FMIndex, query: np.ndarray,
              rb: int, re: int, w_: int):
    """bwa_gen_cigar2 equivalent. query = read slice [qb:qe] (codes).
    Returns (score, cigar [(op,len)], NM, MD)."""
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < idx.l_pac < re):
        return 0, [], -1, ""
    rseq, is_rev = fetch_ref_window(idx, rb, re)
    rlen = len(rseq)
    q = query
    if is_rev:  # reverse both to place indels at the leftmost position
        q = q[::-1]
        rseq = rseq[::-1]
    mat = opt.mat
    if l_query == re - rb and w_ == 0:
        cigar = [(CIGAR_M, l_query)]
        score = int(mat[rseq, q].sum())
    else:
        max_ins = int((((l_query + 1) >> 1) * mat[0, 0] - opt.o_ins)
                      / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * mat[0, 0] - opt.o_del)
                      / opt.e_del + 1.0)
        max_gap = max(max_ins, max_del, 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        w = max(w, abs(rlen - l_query) + 3)
        score, cigar = ksw_global(q, rseq, mat, opt.o_del, opt.e_del,
                                  opt.o_ins, opt.e_ins, w)
    # NM / MD
    int2base = _REV_BASES if is_rev else _FWD_BASES
    md_parts: list[str] = []
    x = y = u = 0
    n_mm = n_gap = 0
    for k, (op, ln) in enumerate(cigar):
        if op == CIGAR_M:
            mism = np.nonzero(q[x : x + ln] != rseq[y : y + ln])[0]
            prev = -1
            for i in mism:
                i = int(i)
                md_parts.append(str(u + i - prev - 1))
                md_parts.append(int2base[int(rseq[y + i])])
                prev = i
                u = 0
            n_mm += len(mism)
            if len(mism):
                u = ln - 1 - int(mism[-1])
            else:
                u += ln
            x += ln
            y += ln
        elif op == CIGAR_D:
            if 0 < k < len(cigar) - 1:
                md_parts.append(str(u))
                md_parts.append("^" + "".join(
                    int2base[int(rseq[y + i])] for i in range(ln)))
                u = 0
                n_gap += ln
            y += ln
        elif op == CIGAR_I:
            x += ln
            n_gap += ln
    md_parts.append(str(u))
    return score, cigar, n_mm + n_gap, "".join(md_parts)


def _reg2aln_pre(opt: MemOptions, idx: FMIndex, l_query: int,
                 ar: AlnReg | None):
    """Unmapped corner + mapq/flag; returns (a, request | None) where
    request = (qb, qe, rb, re, truesc, ar_w) for a solver
    (reference: src/bwamem.c:2344-2384)."""
    a = MemAln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a, None
    a.mapq = mem_approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    return a, (ar.qb, ar.qe, ar.rb, ar.re, ar.truesc, ar.w)


def _reg2aln_solve_scalar(opt: MemOptions, idx: FMIndex, query: np.ndarray,
                          req) -> tuple[list, int, str]:
    """Band-growth retry loop around gen_cigar (the Python twin of
    native/reg2aln.cpp; reference: src/bwamem.c:2386-2398)."""
    qb, qe, rb, re, truesc, arw = req
    w2 = max(
        infer_bw(qe - qb, re - rb, truesc, opt.a, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, truesc, opt.a, opt.o_ins, opt.e_ins),
    )
    if w2 > opt.w:
        w2 = min(w2, arw)
    last_sc = -(1 << 30)
    i = 0
    while True:
        w2 = min(w2, opt.w << 2)
        score, cigar, NM, md = gen_cigar(opt, idx, query[qb:qe], rb, re, w2)
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < truesc - opt.a):
            break
    return cigar, NM, md


def _reg2aln_post(opt: MemOptions, idx: FMIndex, a: MemAln, ar: AlnReg,
                  l_query: int, cigar: list, NM: int, md: str) -> MemAln:
    """Coordinates, D-squeeze, soft clips, final fields
    (reference: src/bwamem.c:2400-2438)."""
    qb, qe, rb, re = ar.qb, ar.qe, ar.rb, ar.re
    a.NM = NM
    a.md = md
    lp = idx.l_pac
    pos_d = rb if rb < lp else re - 1
    is_rev = pos_d >= lp
    pos = ((lp << 1) - 1 - pos_d) if is_rev else pos_d
    a.is_rev = is_rev
    if cigar:  # squeeze out leading or trailing deletions
        if cigar[0][0] == CIGAR_D:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == CIGAR_D:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(CIGAR_S, clip5)] + cigar
        if clip3:
            cigar = cigar + [(CIGAR_S, clip3)]
    a.cigar = cigar
    a.rid = idx.ann.pos_to_rid(pos)
    assert a.rid == ar.rid, (a.rid, ar.rid)
    a.pos = pos - idx.ann.offsets[a.rid]
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a


def mem_reg2aln(opt: MemOptions, idx: FMIndex, l_query: int,
                query: np.ndarray, ar: AlnReg | None) -> MemAln:
    """reference: src/bwamem.c:2344-2438 (native-core when available)."""
    return reg2aln_batch(opt, idx, [(l_query, query, ar)])[0]


def mem_reg2aln_scalar(opt: MemOptions, idx: FMIndex, l_query: int,
                       query: np.ndarray, ar: AlnReg | None) -> MemAln:
    """Pure-Python twin (test oracle for the native core)."""
    a, req = _reg2aln_pre(opt, idx, l_query, ar)
    if req is None:
        return a
    cigar, NM, md = _reg2aln_solve_scalar(opt, idx, query, req)
    return _reg2aln_post(opt, idx, a, ar, l_query, cigar, NM, md)


def reg2aln_batch(opt: MemOptions, idx: FMIndex, items) -> list:
    """Batched mem_reg2aln over items = [(l_query, query, ar | None)].
    Semantics identical to [mem_reg2aln(opt, idx, *it) for it in items];
    the numeric core (band loop + DP + NM/MD) runs in one native call
    when the C++ library is available."""
    from ..native.loader import reg2aln_native, try_load

    pres = [_reg2aln_pre(opt, idx, lq, ar) for (lq, _q, ar) in items]
    req_ids = [i for i, (_a, req) in enumerate(pres) if req is not None]
    lib = try_load()
    out: list = [None] * len(items)
    if lib is None or not req_ids:
        for i, ((lq, q, ar), (a, req)) in enumerate(zip(items, pres)):
            if req is None:
                out[i] = a
                continue
            cigar, NM, md = _reg2aln_solve_scalar(opt, idx, q, req)
            out[i] = _reg2aln_post(opt, idx, a, ar, lq, cigar, NM, md)
        return out
    nr = len(req_ids)
    qoff = np.empty(nr, np.int64)
    qlen = np.empty(nr, np.int32)
    rbs = np.empty(nr, np.int64)
    res = np.empty(nr, np.int64)
    ts = np.empty(nr, np.int32)
    ws = np.empty(nr, np.int32)
    qs = []
    off = 0
    for j, i in enumerate(req_ids):
        _lq, q, _ar = items[i]
        qb, qe, rb, re, tsc, arw = pres[i][1]
        qs.append(np.ascontiguousarray(q[qb:qe], dtype=np.uint8))
        qoff[j] = off
        qlen[j] = qe - qb
        off += qe - qb
        rbs[j] = rb
        res[j] = re
        ts[j] = tsc
        ws[j] = arw
    qstream = np.concatenate(qs) if qs else np.zeros(0, np.uint8)
    cp, coff, cn, nm, mdraw, moff, mlen = reg2aln_native(
        lib, opt, idx, qstream, qoff, qlen, rbs, res, ts, ws)
    for j, i in enumerate(req_ids):
        lq, _q, ar = items[i]
        a = pres[i][0]
        o, k = int(coff[j]), int(cn[j])
        cigar = [(int(c & 0xF), int(c >> 4)) for c in cp[o:o + k]]
        mo, ml = int(moff[j]), int(mlen[j])
        md = bytes(mdraw[mo:mo + ml]).decode()
        out[i] = _reg2aln_post(opt, idx, a, ar, lq, cigar, int(nm[j]), md)
    for i, (a, req) in enumerate(pres):
        if req is None:
            out[i] = a
    return out


def _get_pri_idx(xa_drop: float, regs: list[AlnReg], i: int) -> int:
    k = regs[i].secondary_all
    if k >= 0 and regs[i].score >= regs[k].score * xa_drop:
        return k
    return -1


def mem_gen_alt(opt: MemOptions, idx: FMIndex, regs: list[AlnReg],
                l_query: int, query: np.ndarray) -> list[str | None]:
    """XA:Z strings per region (reference: src/bwamem_extra.c mem_gen_alt).
    Only valid after mem_mark_primary_se."""
    n = len(regs)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    XA: list[str | None] = [None] * n
    if tot == 0:
        return XA
    parts: list[list[str]] = [[] for _ in range(n)]
    picked = []
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or \
                (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        picked.append((i, r))
    solved = reg2aln_batch(opt, idx,
                           [(l_query, query, regs[i]) for (i, _r) in picked])
    for (i, r), t in zip(picked, solved):
        cig = "".join(f"{ln}{CIGAR_CHARS[op]}" for op, ln in t.cigar)
        parts[r].append(
            f"{idx.ann.names[t.rid]},{'+-'[t.is_rev]}{t.pos + 1},{cig},{t.NM};"
        )
    for k in range(n):
        if parts[k]:
            XA[k] = "".join(parts[k])
    return XA


def get_rlen(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (CIGAR_M, CIGAR_D))


def mem_aln2sam(opt: MemOptions, idx: FMIndex, name: str, seq: np.ndarray,
                qual: str | None, n: int, alns: list[MemAln], which: int,
                m: MemAln | None = None, comment: str | None = None,
                rg_id: str | None = None) -> str:
    """One SAM line (reference: src/bwamem.c:1506-1688). `seq` is the
    original read in 0..4 codes, forward orientation."""
    p = alns[which]
    flag = p.flag
    rid, pos, is_rev, cigar = p.rid, p.pos, p.is_rev, list(p.cigar)
    n_cigar = len(cigar)
    if m is not None:
        flag |= 0x1
        if m.rid < 0:
            flag |= 0x8
    if rid < 0:
        flag |= 0x4
        if m is not None and m.rid >= 0:  # copy mate coordinates
            rid, pos, is_rev, cigar, n_cigar = m.rid, m.pos, m.is_rev, [], 0
    mrid, mpos, mis_rev = (m.rid, m.pos, m.is_rev) if m is not None else (-1, -1, False)
    mcigar = list(m.cigar) if m is not None else []
    if m is not None and m.rid < 0 and rid >= 0:
        mrid, mpos, mis_rev, mcigar = rid, pos, is_rev, []
    if is_rev:
        flag |= 0x10
    if m is not None and mis_rev:
        flag |= 0x20

    out = [name, str((flag & 0xFFFF) | (0x100 if flag & 0x10000 else 0))]
    if rid >= 0:
        cig_str = ""
        if n_cigar:
            ops = []
            for c_op, ln in cigar:
                c = c_op
                if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt \
                        and c in (3, 4):
                    c = 4 if which else 3
                ops.append(f"{ln}{CIGAR_CHARS[c]}")
            cig_str = "".join(ops)
        else:
            cig_str = "*"
        out += [idx.ann.names[rid], str(pos + 1), str(p.mapq), cig_str]
    else:
        out += ["*", "0", "0", "*"]

    # mate position
    if m is not None and mrid >= 0:
        rnext = "=" if rid == mrid else idx.ann.names[mrid]
        if rid == mrid:
            p0 = pos + (get_rlen(cigar) - 1 if is_rev else 0)
            p1 = mpos + (get_rlen(mcigar) - 1 if mis_rev else 0)
            if not mcigar or not cigar:
                tlen = 0
            else:
                tlen = -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
        else:
            tlen = 0
        out += [rnext, str(mpos + 1), str(tlen)]
    else:
        out += ["*", "0", "0"]

    # SEQ / QUAL
    if flag & 0x100:
        out += ["*", "*"]
    else:
        qb, qe = 0, len(seq)
        if n_cigar and which and not (opt.flag & MEM_F_SOFTCLIP) \
                and not p.is_alt:
            if cigar[0][0] in (3, 4):
                if is_rev:
                    qe -= cigar[0][1]
                else:
                    qb += cigar[0][1]
            if cigar[-1][0] in (3, 4):
                if is_rev:
                    qb += cigar[-1][1]
                else:
                    qe -= cigar[-1][1]
        if not is_rev:
            s_str = _FWD_LUT[np.asarray(seq[qb:qe])].tobytes().decode()
            q_str = qual[qb:qe] if qual else "*"
        else:
            s_str = _REV_LUT[np.asarray(seq[qb:qe][::-1])].tobytes().decode()
            q_str = qual[qb:qe][::-1] if qual else "*"
        out += [s_str if s_str else "*", q_str if q_str else "*"]

    # tags
    tags = []
    if n_cigar:
        tags.append(f"NM:i:{p.NM}")
        tags.append(f"MD:Z:{p.md}")
    if p.score >= 0:
        tags.append(f"AS:i:{p.score}")
    if p.sub >= 0:
        tags.append(f"XS:i:{p.sub}")
    if rg_id:
        tags.append(f"RG:Z:{rg_id}")
    if not (flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            sa = []
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{CIGAR_CHARS[op]}" for op, ln in r.cigar)
                sa.append(f"{idx.ann.names[r.rid]},{r.pos + 1},"
                          f"{'+-'[r.is_rev]},{cig},{r.mapq},{r.NM};")
            tags.append("SA:Z:" + "".join(sa))
        if p.alt_sc > 0:
            tags.append(f"pa:f:{p.score / p.alt_sc:.3f}")
    if p.XA:
        tags.append(f"XA:Z:{p.XA}")
    from .options import MEM_F_REF_HDR

    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0:
        anno = idx.ann.anno_of(p.rid)
        if anno:  # reference replaces TABs with spaces (src/bwamem.c:1678)
            tags.append("XR:Z:" + anno.replace("\t", " "))
    if comment:
        tags.append(comment)
    return "\t".join(out + tags)


def mem_reg2sam(opt: MemOptions, idx: FMIndex, name: str, seq: np.ndarray,
                qual, regs: list[AlnReg], extra_flag: int = 0,
                mate: MemAln | None = None, rg_id=None,
                comment: str | None = None) -> list[str]:
    """reference: src/bwamem.c:1721-1775."""
    XA = None
    if not (opt.flag & MEM_F_ALL):
        XA = mem_gen_alt(opt, idx, regs, len(seq), seq)
    alns: list[MemAln] = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (0 <= p.secondary < INT_MAX
                and p.score < regs[p.secondary].score * opt.drop_ratio):
            continue
        q = mem_reg2aln(opt, idx, len(seq), seq, p)
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1
        if alns and p.secondary < 0:
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if alns and not p.is_alt and q.mapq > alns[0].mapq:
            q.mapq = alns[0].mapq
        alns.append(q)
    if not alns:
        t = mem_reg2aln(opt, idx, len(seq), seq, None)
        t.flag |= extra_flag
        return [mem_aln2sam(opt, idx, name, seq, qual, 1, [t], 0, mate,
                            rg_id=rg_id, comment=comment)]
    return [mem_aln2sam(opt, idx, name, seq, qual, len(alns), alns, k, mate,
                        rg_id=rg_id, comment=comment)
            for k in range(len(alns))]


def mem_reg2sam_batch(opt: MemOptions, idx: FMIndex, names, seqs, quals,
                      regs_lists, comments=None, rg_id=None) -> list[str]:
    """Batched SE twin of per-read mem_reg2sam: identical selection and
    output, with every mem_reg2aln numeric core (main alignments + XA
    entries + unmapped placeholders) solved in one native batch call
    (reference: src/bwamem.c:1721-1775 + src/bwamem_extra.c mem_gen_alt).
    Expects regs_lists already mark-primary'd; comments pre-filtered for
    opt.copy_comment."""
    B = len(seqs)
    items: list = []   # reg2aln requests across the whole slice
    plan = []          # per read: (sel, xa_req, unmapped_slot)
    gen_xa = not (opt.flag & MEM_F_ALL)
    for b in range(B):
        regs = regs_lists[b]
        seq = seqs[b]
        lq = len(seq)
        xa_req: list = []  # (i, r, slot) in i order (mem_gen_alt order)
        if gen_xa:
            n = len(regs)
            cnt = [0] * n
            has_alt = [False] * n
            tot = 0
            for i in range(n):
                r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
                if r >= 0:
                    cnt[r] += 1
                    tot += 1
                    if regs[i].is_alt:
                        has_alt[r] = True
            if tot:
                for i in range(n):
                    r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
                    if r < 0:
                        continue
                    if cnt[r] > opt.max_XA_hits_alt or                             (not has_alt[r] and cnt[r] > opt.max_XA_hits):
                        continue
                    xa_req.append((i, r, len(items)))
                    items.append((lq, seq, regs[i]))
        sel: list = []  # (k, slot) — the kept alignments, in reg order
        for k, p in enumerate(regs):
            if p.score < opt.T:
                continue
            if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
                continue
            if (0 <= p.secondary < INT_MAX
                    and p.score < regs[p.secondary].score * opt.drop_ratio):
                continue
            sel.append((k, len(items)))
            items.append((lq, seq, p))
        unmapped_slot = None
        if not sel:
            unmapped_slot = len(items)
            items.append((lq, seq, None))
        plan.append((sel, xa_req, unmapped_slot))

    solved = reg2aln_batch(opt, idx, items)

    lines: list[str] = []
    for b in range(B):
        regs = regs_lists[b]
        seq = seqs[b]
        qual = quals[b]
        sel, xa_req, unmapped_slot = plan[b]
        cm = comments[b] if comments else None
        XA = None
        if gen_xa and regs:
            parts: list[list[str]] = [[] for _ in range(len(regs))]
            for (i, r, slot) in xa_req:
                t = solved[slot]
                cig = "".join(f"{ln}{CIGAR_CHARS[op]}" for op, ln in t.cigar)
                parts[r].append(
                    f"{idx.ann.names[t.rid]},{'+-'[t.is_rev]}{t.pos + 1},"
                    f"{cig},{t.NM};")
            XA = ["".join(pt) if pt else None for pt in parts]
        alns: list[MemAln] = []
        for (k, slot) in sel:
            p = regs[k]
            q = solved[slot]
            q.XA = XA[k] if XA else None
            if p.secondary >= 0:
                q.sub = -1
            if alns and p.secondary < 0:
                q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
            if alns and not p.is_alt and q.mapq > alns[0].mapq:
                q.mapq = alns[0].mapq
            alns.append(q)
        if not alns:
            t = solved[unmapped_slot]
            lines.append(mem_aln2sam(opt, idx, names[b], seq, qual, 1, [t],
                                     0, None, rg_id=rg_id, comment=cm))
        else:
            lines.extend(
                mem_aln2sam(opt, idx, names[b], seq, qual, len(alns), alns,
                            kk, None, rg_id=rg_id, comment=cm)
                for kk in range(len(alns)))
    return lines
