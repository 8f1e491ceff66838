"""Scalar oracle for the DP kernels: ksw-extend and ksw-global semantics.

These reproduce, step for step, the observable semantics of the reference's
CPU kernels (reference: src/ksw.c:864-988 ksw_extend2, the executable
contract for the GPU extension library per decoy_cpu_align
src/bwamem.c:1791-1908; and src/ksw.c ksw_global2 for CIGAR generation).
They anchor the tests of the batched TPU kernels in ops/.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG_INF = -0x40000000

# CIGAR op codes (BAM convention): M=0, I=1, D=2, S=3(soft clip)
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_S = 0, 1, 2, 3


@dataclass
class ExtendResult:
    score: int      # best extension score (>= h0 never guaranteed; max vs h0)
    qle: int        # query end (exclusive length consumed) of best local cell
    tle: int        # target end of best local cell
    gtle: int       # target end of best to-query-end cell
    gscore: int     # best score among cells in the last query column (-1 if none)
    max_off: int    # max band offset observed at improvements


def ksw_extend(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,          # (m, m) int
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    w: int, end_bonus: int, zdrop: int, h0: int,
    opt_ext: bool = True,
) -> ExtendResult:
    q, t = np.asarray(query), np.asarray(target)
    qlen, tlen = len(q), len(t)
    assert h0 > 0
    m = mat.shape[0]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat[:, q].astype(np.int64)  # (m, qlen) profile

    eh_h = np.zeros(qlen + 2, dtype=np.int64)
    eh_e = np.zeros(qlen + 2, dtype=np.int64)
    eh_h[0] = h0
    eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > e_ins:
        eh_h[j] = eh_h[j - 1] - e_ins
        j += 1

    # clamp w to the maximum possible gap lengths
    mx = int(mat.max())
    max_ins = max(int((qlen * mx + end_bonus - o_ins) / e_ins + 1.0), 1)
    max_del = max(int((qlen * mx + end_bonus - o_del) / e_del + 1.0), 1)
    w = min(w, max_ins, max_del)

    best = h0
    max_i = max_j = -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        f = 0
        mrow = 0
        mj = -1
        qrow = qp[t[i]]
        if opt_ext:
            beg = max(beg, i - w)
            end = min(end, i + w + 1, qlen)
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for jj in range(beg, end):
            # eh[j] = {H(i-1,j-1), E(i,j)}, f = F(i,j), h1 = H(i,j-1)
            M, e = int(eh_h[jj]), int(eh_e[jj])
            eh_h[jj] = h1
            M = M + int(qrow[jj]) if M else 0
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            if h >= mrow:  # reference tie-break: later column wins the row max
                mrow, mj = h, jj
            tt = M - oe_del
            tt = tt if tt > 0 else 0
            e -= e_del
            e = e if e > tt else tt
            eh_e[jj] = e
            tt = M - oe_ins
            tt = tt if tt > 0 else 0
            f -= e_ins
            f = f if f > tt else tt
        eh_h[end] = h1
        eh_e[end] = 0
        if end == qlen:
            # reference rule: on ties the LATER row wins max_ie
            if h1 >= gscore:
                max_ie, gscore = i, h1
        if mrow == 0:
            break
        if mrow > best:
            best, max_i, max_j = mrow, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if best - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if best - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink the computed window to the non-zero span
        jj = beg
        while jj < end and eh_h[jj] == 0 and eh_e[jj] == 0:
            jj += 1
        beg = jj
        jj = end
        while jj >= beg and eh_h[jj] == 0 and eh_e[jj] == 0:
            jj -= 1
        end = min(jj + 2, qlen)

    return ExtendResult(
        score=int(best), qle=max_j + 1, tle=max_i + 1,
        gtle=max_ie + 1, gscore=int(gscore), max_off=int(max_off),
    )


def extend_with_end_choice(
    query, target, mat, o_del, e_del, o_ins, e_ins, w,
    zdrop, h0, pen_clip, opt_ext=True,
):
    """The local-vs-to-end choice applied by the extension consumer
    (reference: src/bwamem.c:1887-1901 in decoy_cpu_align): returns
    (score, qle, tle) where reaching the query end is preferred unless the
    clipped local alignment is better by more than the clip penalty."""
    r = ksw_extend(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                   end_bonus=pen_clip, zdrop=zdrop, h0=h0, opt_ext=opt_ext)
    if r.gscore <= 0 or r.gscore <= r.score - pen_clip:
        return r.score, r.qle, r.tle
    return r.gscore, len(query), r.gtle


@dataclass
class LocalResult:
    score: int
    qb: int
    qe: int      # inclusive 0-based, -1 when score == 0
    tb: int
    te: int
    score2: int


def ksw_local(query, target, mat, o_del, e_del, o_ins, e_ins,
              minsc: int = 0, _with_start: bool = True) -> LocalResult:
    """Scalar local affine-gap SW with start positions and second-best —
    the oracle for ops/swalign.sw_align_batch (semantics of the
    reference's ksw_align2, src/ksw.c:355-612). E/F gaps open from the
    full H; ties: earliest target row (strict >), earliest query column."""
    q, t = np.asarray(query), np.asarray(target)
    qlen, tlen = len(q), len(t)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H_prev = np.zeros(qlen, np.int64)
    E = np.zeros(qlen, np.int64)
    best, qe, te = 0, -1, -1
    rowmax = np.zeros(tlen, np.int64)
    for i in range(tlen):
        H = np.zeros(qlen, np.int64)
        f = NEG_INF
        for j in range(qlen):
            M = (H_prev[j - 1] if j else 0) + int(mat[t[i], q[j]])
            E[j] = max(E[j] - e_del, H_prev[j] - oe_del, 0)
            h = max(M, E[j], f, 0)
            H[j] = h
            f = max(f - e_ins, h - oe_ins)
        rowmax[i] = H.max() if qlen else 0
        if rowmax[i] > best:
            best = int(rowmax[i])
            qe = int(np.argmax(H))
            te = i
        H_prev = H
    # second best: outside te +- ceil(best / max_mat)
    mx = int(mat.max())
    halfw = (best + mx - 1) // mx if best else 0
    score2 = 0
    for i in range(tlen):
        if (i < te - halfw or i > te + halfw) and rowmax[i] >= minsc:
            score2 = max(score2, int(rowmax[i]))
    # reverse pass for starts
    qb = tb = -1
    if best > 0 and _with_start:
        rr = ksw_local(q[: qe + 1][::-1], t[: te + 1][::-1], mat,
                       o_del, e_del, o_ins, e_ins, _with_start=False)
        if rr.score == best:
            qb, tb = qe - rr.qe, te - rr.te
    return LocalResult(score=best, qb=qb, qe=qe, tb=tb, te=te, score2=score2)


def ksw_global(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int, e_del: int, o_ins: int, e_ins: int,
    w: int,
    want_cigar: bool = True,
):
    """Banded global alignment; returns (score, cigar) with cigar a list of
    (op, len). Exact port of ksw_global2 semantics including traceback
    tie-breaking (reference: src/ksw.c ksw_global2)."""
    q, t = np.asarray(query), np.asarray(target)
    qlen, tlen = len(q), len(t)
    if qlen == 0 or tlen == 0:
        cigar = []
        if tlen:
            cigar.append((CIGAR_D, tlen))
        if qlen:
            cigar.append((CIGAR_I, qlen))
        return (NEG_INF if (qlen or tlen) else 0), cigar
    # a band narrower than |tlen - qlen| can never reach the corner cell;
    # the reference relies on callers enforcing this (bwa_gen_cigar2 sets
    # w >= |rlen - l_query| + 3) and would read stale memory otherwise —
    # clamp instead so the function is total.
    w = max(w, abs(tlen - qlen))
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat[:, q].astype(np.int64)
    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None

    eh_h = np.full(qlen + 2, NEG_INF, dtype=np.int64)
    eh_e = np.full(qlen + 2, NEG_INF, dtype=np.int64)
    eh_h[0] = 0
    for j in range(1, min(qlen, w) + 1):
        eh_h[j] = -(o_ins + e_ins * j)

    for i in range(tlen):
        f = NEG_INF
        qrow = qp[t[i]]
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG_INF
        for j in range(beg, end):
            M, e = int(eh_h[j]), int(eh_e[j])
            eh_h[j] = h1
            M += int(qrow[j])
            d = 0 if M >= e else 1
            h = M if M >= e else e
            d = d if h >= f else 2
            h = h if h >= f else f
            h1 = h
            tt = M - oe_del
            e -= e_del
            d |= (1 << 2) if e > tt else 0
            e = e if e > tt else tt
            eh_e[j] = e
            tt = M - oe_ins
            f -= e_ins
            d |= (2 << 4) if f > tt else 0
            f = f if f > tt else tt
            if want_cigar:
                z[i, j - beg] = d
        eh_h[end] = h1
        eh_e[end] = NEG_INF

    score = int(eh_h[qlen])
    cigar: list[tuple[int, int]] = []
    if want_cigar:
        ops: list[int] = []
        which = 0
        i = tlen - 1
        k = min(i + w + 1, qlen) - 1
        while i >= 0 and k >= 0:
            which = (int(z[i, k - max(i - w, 0)]) >> (which << 1)) & 3
            if which == 0:
                ops.append(CIGAR_M)
                i -= 1
                k -= 1
            elif which == 1:
                ops.append(CIGAR_D)
                i -= 1
            else:
                ops.append(CIGAR_I)
                k -= 1
        if i >= 0:
            ops.extend([CIGAR_D] * (i + 1))
        if k >= 0:
            ops.extend([CIGAR_I] * (k + 1))
        ops.reverse()
        for op in ops:
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + 1)
            else:
                cigar.append((op, 1))
    return score, cigar
