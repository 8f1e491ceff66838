"""K5: the finalize's CIGAR solve, a banded global alignment with traceback
for every record the SAM needs (bm_ksw_global semantics inside
solve_record's band-growth retry loop): the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (csrc/cigar_kernel.cu) replaces no TPU kernel: the JAX package
solves CIGARs on the host (native/reg2aln_core.h gen_cigar via
native/ksw.cpp bm_ksw_global). It takes the jobs that the port's split
finalize plans (pipeline/finalize.py), one warp a job: the query slice and
the reference window gathered on the card from the packed genome, the
retry loop's gen_cigar calls one DP pass each at the bands the plan
computed (ending where the loop ends, and never repeating a band), each
pass's traceback kept at 4 bits a cell, then the walk of the last pass's
traceback into run-length CIGAR ops. The traceback is in the warp's shared
memory where the whole job fits in JOB_SMEM_CAP bytes (`job_smem`), else
in global scratch (1 kb reads, `-x pacbio`), at most TILE_BYTES a launch:
`launch_plan` tiles the jobs into launches. A job whose codes and DP rows
alone pass JOB_SMEM_CAP, whose traceback passes TILE_BYTES, or whose CIGAR
has more runs than the launch's cap (`ops_cap`) comes back unsolved (its
row's op count < 0) for the host's gen_cigar.

`solve` launches the kernel for CUDA tensors and runs `solve_plain` for
CPU tensors; it never falls back from one to the other. `ksw_global_plain`
is the plain version's DP: bm_ksw_global on a batch.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import build as _kbuild
from .build import check as _check

NEG = -0x40000000
OPS_CAP = 16            # CIGAR runs a job brings back (queries to LONG_Q)
LONG_Q, LONG_OPS_CAP = 512, 128   # ... and where a launch has longer ones
DESC = 8                # a job's descriptor (finalize_split.cpp bmt_plan_jobs)
JOB_SMEM_CAP = 48 * 1024
TILE_BYTES = 256 << 20  # a launch's global traceback scratch, at most
SMEM_BLOCK = 232448 - 256   # a block's dynamic shared memory, less smat
MAX_WARPS = 8
OP_M, OP_I, OP_D = 0, 1, 2

SOURCE = _kbuild.CSRC / "cigar_kernel.cu"
_LIB_PATH = _kbuild.BUILD_DIR / "libcigar_kernel.so"

# kernel launches since import (or the last reset by the caller); the
# wrapper adds one per launch and nowhere else
LAUNCHES = 0
BUILD_LOG = ""

_lock = threading.Lock()
_lib = None


def build() -> float:
    """Compile the kernel library if it is missing or older than its
    source. Returns the seconds spent compiling (0 when up to date); the
    compiler's output (register and spill report) is kept in BUILD_LOG."""
    global BUILD_LOG
    secs, log = _kbuild.build(SOURCE, _LIB_PATH)
    if log is not None:
        BUILD_LOG = log
    return secs


def _load():
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.bmt_cigar_solve.argtypes = (
                [vp] * 5 + [ctypes.c_longlong, vp] + [ci] * 8 + [vp] * 4)
            lib.bmt_cigar_solve.restype = ci
            lib.bmt_cigar_error_string.argtypes = [ci]
            lib.bmt_cigar_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _sizes(desc: np.ndarray):
    """(bytes of a job's codes and DP rows, bytes of its traceback): the
    kernel's `carve`, query and window codes, three DP rows of lq + 2
    int32 cells, and 16 bytes a row for every 32 columns of the widest
    band."""
    d = np.asarray(desc, np.int64).reshape(-1, DESC)
    lq, rlen, bmax = d[:, 0], d[:, 1], d[:, 7]
    r16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    w = np.maximum(bmax, np.abs(rlen - lq))   # bm_ksw_global's clamp
    ncol = np.where(bmax >= 0, np.minimum(lq, 2 * w + 1), 0)
    rows = 3 * ((lq + 2 + 3) // 4 * 4) * 4
    return r16(lq) + r16(rlen) + rows, rlen * ((ncol + 31) // 32) * 16


def job_smem(desc: np.ndarray) -> np.ndarray:
    """Bytes of shared memory a job's warp takes with its traceback in
    shared memory."""
    base, tb = _sizes(desc)
    return base + tb


def takes(desc: np.ndarray) -> np.ndarray:
    """The jobs K5 takes: a window gen_cigar accepts (at least one call),
    codes and DP rows in at most JOB_SMEM_CAP bytes of shared memory and a
    traceback of at most TILE_BYTES."""
    d = np.asarray(desc).reshape(-1, DESC)
    base, tb = _sizes(d)
    return (d[:, 3] > 0) & (base <= JOB_SMEM_CAP) & (tb <= TILE_BYTES)


def ops_cap(desc: np.ndarray) -> int:
    """The CIGAR runs a launch over `desc` brings back a job: OPS_CAP,
    LONG_OPS_CAP where a job's query is longer than LONG_Q."""
    d = np.asarray(desc).reshape(-1, DESC)
    return LONG_OPS_CAP if len(d) and int(d[:, 0].max()) > LONG_Q else OPS_CAP


class LaunchPlan(NamedTuple):
    """How `solve` launches K5 over a batch of jobs (`launch_plan`)."""
    take: np.ndarray    # (N,) bool: the jobs K5 takes
    cap: int            # CIGAR runs a row holds
    smem: int           # a warp's shared memory (0: K5 takes no job)
    tboff: np.ndarray | None   # (N,) int64 traceback offsets in its tile's
    #                            scratch, -1 in shared memory; None: all are
    tiles: list         # (first job, end, scratch bytes) a launch


def launch_plan(desc: np.ndarray) -> LaunchPlan:
    """The jobs K5 takes (`takes`) and where their tracebacks go: all in
    shared memory where every job fits there whole in JOB_SMEM_CAP bytes
    (a warp's shared memory the most a job needs); else a warp holds the
    most codes and DP rows a job needs, and each traceback that does not
    fit beside them goes to global scratch. The launches: runs of jobs in
    order whose scratch stays within TILE_BYTES (one launch where no
    traceback leaves shared memory)."""
    d = np.asarray(desc).reshape(-1, DESC)
    take = takes(d)
    if not take.any():
        return LaunchPlan(take, ops_cap(d), 0, None, [])
    base, tb = _sizes(d)
    full = base + tb
    if int(full[take].max()) <= JOB_SMEM_CAP:
        return LaunchPlan(take, ops_cap(d), int(full[take].max()), None,
                          [(0, len(d), 0)])
    smem = int(base[take].max())
    tboff = np.full(len(d), -1, np.int64)
    tiles, j0, used = [], 0, 0
    for j in np.flatnonzero(take & (full > smem)):
        if used + int(tb[j]) > TILE_BYTES:
            tiles.append((j0, int(j), used))
            j0, used = int(j), 0
        tboff[j] = used
        used += int(tb[j])
    tiles.append((j0, len(d), used))
    return LaunchPlan(take, ops_cap(d), smem, tboff, tiles)


def solve(qstream, qoff, rb, desc, pac_words, l_pac: int, mat, o_del: int,
          e_del: int, o_ins: int, e_ins: int, plan: LaunchPlan):
    """Score and CIGAR of N finalize jobs.

    qstream (S,) uint8 read codes 0..4; qoff (N,) int64 offset of each
    job's query slice in qstream; rb (N,) int64 window start in doubled
    coordinates; desc (N, DESC) int32 (finalize_split.cpp bmt_plan_jobs);
    pac_words (ceil(l_pac / 16),) int32 packed genome; mat (25,) int32;
    plan: `launch_plan` of the caller's host copy of desc. Returns (N, 2 +
    plan.cap) int32 rows: score, the number of CIGAR runs (< 0: left to the
    host) and the runs as len << 4 | op (M 0, I 1, D 2). The launches
    (one a tile of the plan) go on the current stream in order."""
    global LAUNCHES
    if qstream.device.type == "cpu":
        return solve_plain(qstream, qoff, rb, desc, pac_words, l_pac, mat,
                           o_del, e_del, o_ins, e_ins, plan.cap)
    if qstream.device.type != "cuda":
        raise ValueError(f"unsupported device {qstream.device}")
    N = desc.shape[0]
    _check(qstream, "qstream", torch.uint8, (qstream.shape[0],))
    _check(qoff, "qoff", torch.int64, (N,))
    _check(rb, "rb", torch.int64, (N,))
    _check(desc, "desc", torch.int32, (N, DESC))
    _check(pac_words, "pac_words", torch.int32, (pac_words.shape[0],))
    _check(mat, "mat", torch.int32, (25,))
    for x in (qoff, rb, desc, pac_words, mat):
        if x.device != qstream.device:
            raise ValueError("all inputs must be on one device")
    row = 2 + plan.cap
    out = torch.empty((N, row), dtype=torch.int32, device=qstream.device)
    if N == 0 or plan.smem == 0:
        out[:, 0] = 0
        out[:, 1] = -1
        return out
    warps = max(1, min(MAX_WARPS, SMEM_BLOCK // plan.smem))
    lib = _load()
    stream = torch.cuda.current_stream(qstream.device).cuda_stream
    tboff = (None if plan.tboff is None else
             torch.from_numpy(plan.tboff).to(qstream.device))
    for j0, j1, nbytes in plan.tiles:
        scratch = (torch.empty(nbytes, dtype=torch.uint8,
                               device=qstream.device) if nbytes else None)
        rc = lib.bmt_cigar_solve(
            qstream.data_ptr(), qoff[j0:].data_ptr(), rb[j0:].data_ptr(),
            desc[j0:].data_ptr(), pac_words.data_ptr(), int(l_pac),
            mat.data_ptr(), int(o_del), int(e_del), int(o_ins), int(e_ins),
            j1 - j0, plan.cap, plan.smem, warps,
            None if tboff is None else tboff[j0:].data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out[j0:].data_ptr(), stream)
        if rc != 0:
            raise RuntimeError("CIGAR kernel launch failed: "
                               + lib.bmt_cigar_error_string(rc).decode())
        with _lock:
            LAUNCHES += 1
    return out


# ------------------------------------------------------------ plain version

def _windows(qstream, qoff, rb, lq, rlen, pac_words, l_pac):
    """(N, Q) query codes (reversed on the reverse strand, padding 4) and
    (N, T) window codes (the reverse strand's complemented and reversed,
    padding 0), as gen_cigar orients them."""
    N = lq.shape[0]
    Q = int(lq.max()) if N else 0
    T = int(rlen.max()) if N else 0
    rev = rb >= l_pac
    j = torch.arange(Q, dtype=torch.int64)
    qi = torch.where(rev[:, None], lq[:, None] - 1 - j, j)
    qv = j < lq[:, None]
    q = qstream.long()[(qoff[:, None] + qi).clamp(0, max(qstream.numel() - 1,
                                                        0))]
    q = torch.where(qv, q, 4)
    i = torch.arange(T, dtype=torch.int64)
    f0 = torch.where(rev, 2 * l_pac - (rb + rlen), rb)
    p = (f0[:, None] + i).clamp(0, max(l_pac - 1, 0))
    words = pac_words.long() & 0xFFFFFFFF
    b = (words[p >> 4] >> (30 - 2 * (p & 15))) & 3
    t = torch.where(rev[:, None], 3 - b, b)
    t = torch.where(i < rlen[:, None], t, 0)
    return q, t


def ksw_global_plain(q, t, qlen, tlen, w, mat, o_del: int, e_del: int,
                     o_ins: int, e_ins: int, want_cigar: bool = True):
    """bm_ksw_global (native/ksw.cpp) on a batch: q (N, Q) and t (N, T)
    codes, qlen, tlen, w (N,). Returns (scores (N,) int64, cigars: a list
    of [(op, len), ...] or None). The row's query-gap state F is an
    exclusive prefix max along the row: F(j) + e_ins*j = max(F(beg) +
    e_ins*beg, max over beg <= j' < j of diag(j') - o_ins - e_ins + e_ins*(j'
    + 1)), which is the sequential recurrence unrolled."""
    q = q.long()
    t = t.long()
    qlen, tlen, w = qlen.long(), tlen.long(), w.long()
    mat = mat.long().reshape(5, 5)
    N, Q = q.shape
    T = t.shape[1]
    w = torch.maximum(w, (tlen - qlen).abs())
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    vneg = -(1 << 40)
    jj = torch.arange(Q, dtype=torch.int64)
    jq = torch.arange(1, Q + 1, dtype=torch.int64)
    H = torch.full((N, Q + 1), NEG, dtype=torch.int64)
    H[:, 0] = 0
    H[:, 1:] = torch.where(jq[None] <= torch.minimum(qlen, w)[:, None],
                           -(o_ins + e_ins * jq)[None], NEG)
    E = torch.full((N, Q + 1), NEG, dtype=torch.int64)
    score = torch.full((N,), NEG, dtype=torch.int64)
    tb = torch.zeros((N, T, Q), dtype=torch.uint8) if want_cigar else None
    for i in range(T):
        live = i < tlen
        beg = (i - w).clamp(min=0)
        end = torch.minimum(i + w + 1, qlen)
        inb = (jj >= beg[:, None]) & (jj < end[:, None]) & live[:, None]
        diag = H[:, :Q] + mat[t[:, i:i + 1], q.clamp(0, 4)]
        ed = E[:, :Q]
        g = torch.where(inb, diag - oe_ins + e_ins * (jj + 1), vneg)
        incl = torch.cummax(g, dim=1).values
        excl = torch.cat([torch.full((N, 1), vneg, dtype=torch.int64),
                          incl[:, :-1]], dim=1)
        f = torch.maximum(excl, (NEG + e_ins * beg)[:, None]) - e_ins * jj
        take_d = diag >= ed
        best = torch.where(take_d, diag, ed)
        src = torch.where(take_d, 0, 1)
        ins = f > best
        best = torch.where(ins, f, best)
        src = torch.where(ins, 2, src)
        ext_d = ed - e_del > diag - oe_del
        ext_i = f - e_ins > diag - oe_ins
        bound = torch.where(beg == 0, -(o_del + e_del * (i + 1)), NEG)
        Hn = torch.cat([bound[:, None], torch.where(inb, best, NEG)], dim=1)
        En = E.clone()
        En[:, :Q] = torch.where(inb, torch.where(ext_d, ed - e_del,
                                                 diag - oe_del), ed)
        En.scatter_(1, end.clamp(max=Q)[:, None], NEG)
        H = torch.where(live[:, None], Hn, H)
        E = torch.where(live[:, None], En, E)
        score = torch.where(i == tlen - 1,
                            Hn.gather(1, qlen.clamp(max=Q)[:, None])[:, 0],
                            score)
        if want_cigar:
            cell = src | (ext_d.long() << 2) | (ext_i.long() << 3)
            tb[:, i] = torch.where(inb, cell, 0).to(torch.uint8)
    empty = (qlen == 0) | (tlen == 0)
    score = torch.where(empty, torch.where((qlen == 0) & (tlen == 0), 0, NEG),
                        score)
    if not want_cigar:
        return score, None
    return score, _traceback(tb, qlen, tlen, w, empty)


def _traceback(tb, qlen, tlen, w, empty):
    """bm_ksw_global's 3-state walk from the corner, all jobs in step."""
    N = qlen.shape[0]
    n = torch.arange(N)
    i = tlen - 1
    k = torch.minimum(i + w + 1, qlen) - 1
    st = torch.zeros(N, dtype=torch.int64)
    act = (i >= 0) & (k >= 0) & ~empty
    steps = []
    while bool(act.any()):
        cell = tb[n, i.clamp(min=0), k.clamp(min=0)].long()
        ns = torch.where(st == 0, cell & 3,
                         torch.where(st == 1, ((cell >> 2) & 1),
                                     ((cell >> 3) & 1) * 2))
        st = torch.where(act, ns, st)
        op = torch.where(st == 0, OP_M, torch.where(st == 1, OP_D, OP_I))
        steps.append(torch.where(act, op, -1))
        i = torch.where(act & (st != 2), i - 1, i)
        k = torch.where(act & (st != 1), k - 1, k)
        act = act & (i >= 0) & (k >= 0)
    walk = (torch.stack(steps).numpy() if steps
            else np.zeros((0, N), np.int64))
    i, k = i.numpy(), k.numpy()
    cigars = []
    for b in range(N):
        if empty[b]:
            cigars.append([(OP_D, int(tlen[b]))] * bool(tlen[b])
                          + [(OP_I, int(qlen[b]))] * bool(qlen[b]))
            continue
        col = walk[:, b]
        ops = np.concatenate([col[col >= 0],
                              np.full(max(int(i[b]) + 1, 0), OP_D),
                              np.full(max(int(k[b]) + 1, 0), OP_I)])[::-1]
        if not len(ops):
            cigars.append([])
            continue
        cut = np.flatnonzero(np.diff(ops)) + 1
        starts = np.concatenate([[0], cut])
        lens = np.diff(np.concatenate([starts, [len(ops)]]))
        cigars.append([(int(ops[s]), int(ln)) for s, ln in zip(starts, lens)])
    return cigars


def solve_plain(qstream, qoff, rb, desc, pac_words, l_pac: int, mat,
                o_del: int, e_del: int, o_ins: int, e_ins: int, cap: int):
    """`solve` on the CPU: the jobs K5 takes (`takes`), each gen_cigar call
    of the retry loop a pass of ksw_global_plain at its band (the ungapped
    call a plain sum), the loop's exit rule, then the traceback of the
    pass it ends on."""
    d = desc.cpu().numpy().reshape(-1, DESC)
    N = d.shape[0]
    out = torch.zeros((N, 2 + cap), dtype=torch.int32)
    out[:, 1] = -1
    sel = np.flatnonzero(takes(d))
    if not len(sel):
        return out
    d = d[sel].astype(np.int64)
    lq, rlen = torch.from_numpy(d[:, 0]), torch.from_numpy(d[:, 1])
    thr, nb = d[:, 2], d[:, 3]
    q, t = _windows(qstream.cpu(), qoff.cpu()[sel], rb.cpu()[sel], lq, rlen,
                    pac_words.cpu(), int(l_pac))
    mat = mat.cpu().long().reshape(5, 5)
    n = len(sel)
    scores = np.zeros((3, n), np.int64)
    for c in range(3):
        band = d[:, 4 + c]
        run = nb > c
        if c:
            run &= band != d[:, 3 + c]   # a repeated band repeats its score
            scores[c] = scores[c - 1]
        gap = np.flatnonzero(run & (band >= 0))
        if len(gap):
            s, _ = ksw_global_plain(q[gap], t[gap], lq[gap], rlen[gap],
                                    torch.from_numpy(band[gap]), mat, o_del,
                                    e_del, o_ins, e_ins, want_cigar=False)
            scores[c, gap] = s.numpy()
        flat = np.flatnonzero(run & (band < 0))
        if len(flat):   # lq == rlen: the codes side by side
            ii = torch.from_numpy(flat)
            L = min(q.shape[1], t.shape[1])
            s = mat[t[ii][:, :L], q[ii][:, :L]]
            scores[c, flat] = torch.where(torch.arange(L) < lq[ii][:, None],
                                          s, 0).sum(1).numpy()
    # solve_record's loop: the call it ends on
    fin = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    last = np.full(n, NEG, np.int64)
    for c in range(3):
        act = ~done & (nb > c)
        s = scores[c]
        stop = (c > 0) & (s == last) | (c == nb - 1) | ~(s < thr)
        fin[act] = c
        done |= act & stop
        last = np.where(act, s, last)
    band = d[np.arange(n), 4 + fin]
    res = out[sel]
    res[:, 0] = torch.from_numpy(scores[fin, np.arange(n)]).int()
    cig = [None] * n
    for b in np.flatnonzero(band < 0):
        cig[b] = [(OP_M, int(lq[b]))]
    gap = np.flatnonzero(band >= 0)
    if len(gap):
        _, cg = ksw_global_plain(q[gap], t[gap], lq[gap], rlen[gap],
                                 torch.from_numpy(band[gap]), mat, o_del,
                                 e_del, o_ins, e_ins)
        for b, c in zip(gap, cg):
            cig[b] = c
    for b, c in enumerate(cig):
        if len(c) <= cap:
            res[b, 1] = len(c)
            res[b, 2:2 + len(c)] = torch.tensor(
                [(ln << 4) | op for op, ln in c], dtype=torch.int32)
    out[sel] = res
    return out
