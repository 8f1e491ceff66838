"""Batched local Smith-Waterman (ksw_align2 semantics): the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel (csrc/swalign_kernel.cu) replaces the Pallas TPU kernel
bwamem_tpu/ops/pallas/swalign_kernel.py:_make_sw_kernel together with the
XLA around its two launches in sw_align_batch_pallas_stacked: forward
sweep, score2 and reverse sweep run in one launch. Each job runs on a
group of lanes sized to its qlen: the kernel first bins the jobs by width
class, then those that take 16-bit cells (fits_i16), then by rows
(extend_kernel.job_bins states the rule, which K1 shares), into a
workspace this wrapper allocates. It is compiled with nvcc for sm_90a
into the package's `_build/` directory on first use (ops/kernels/build.py)
and called through a plain C entry point with ctypes.

`sw_align_batch` launches the kernel for CUDA tensors and runs
`sw_align_batch_plain` — a torch port of the row loop in
bwamem_tpu/ops/swalign.py:_sw_forward plus score2, the reverse sweep and
rev_skip — for CPU tensors. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build as _kbuild
from .build import check as _check
from .extend_kernel import CLASS_COLS, FITS16, WORK_HEADER
from .extend_kernel import job_bins  # noqa: F401  (K2 bins as K1 does)

NEG = -0x40000000
NEG16 = -0x4000       # F's sentinel in 16-bit cells
I16_LIMIT = 1 << 14   # every 16-bit cell value stays below this
_PLAIN_BLOCK = 8192  # jobs per step of the plain version
QMAX_LIMIT = 1023
TMAX_LIMIT = 232448 // 4
# one warp's row maxima in a block's shared memory: 4 bytes a row for
# each of the 4 groups of 8 lanes a warp holds on the narrowest strips;
# past this the kernel keeps them in a global buffer this wrapper gives
SMEM_TMAX = 232448 // 16

SOURCE = _kbuild.CSRC / "swalign_kernel.cu"
_LIB_PATH = _kbuild.BUILD_DIR / "libswalign_kernel.so"

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
            lib.bm_sw_local.argtypes = [vp] * 9 + [ci] * 9 + [vp]
            lib.bm_sw_local.restype = ci
            lib.bm_sw_error_string.argtypes = [ci]
            lib.bm_sw_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def sw_align_batch(query, target, qlen, tlen, minsc, mat, o_del: int,
                   e_del: int, o_ins: int, e_ins: int, a: int,
                   rev_skip: int = 0):
    """Local SW over N jobs.

    query (N, QMAX) and target (N, TMAX) base codes 0..4 (int8 on CUDA);
    qlen, tlen, minsc (N,) int32; mat (5, 5) int32; `a` is the match
    score that sizes score2's exclusion window. Returns a (6, N) int32
    tensor in SW_KEYS order: score, qb, qe, tb, te (0-based inclusive
    ends) and score2. rev_skip > 0: jobs with score < rev_skip skip the
    reverse sweep and report qb = tb = -1."""
    global LAUNCHES
    if query.device.type == "cpu":
        return sw_align_batch_plain(query, target, qlen, tlen, minsc, mat,
                                    o_del, e_del, o_ins, e_ins, a, rev_skip)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    N, QMAX = query.shape
    TMAX = target.shape[1]
    _check(query, "query", torch.int8, (N, QMAX))
    _check(target, "target", torch.int8, (N, TMAX))
    for name, x in (("qlen", qlen), ("tlen", tlen), ("minsc", minsc)):
        _check(x, name, torch.int32, (N,))
    _check(mat, "mat", torch.int32, (5, 5))
    for x in (target, qlen, tlen, minsc, mat):
        if x.device != query.device:
            raise ValueError("all inputs must be on one device")
    if not 1 <= QMAX <= QMAX_LIMIT:
        raise ValueError(f"QMAX {QMAX} outside 1..{QMAX_LIMIT}")
    if not 1 <= TMAX <= TMAX_LIMIT:
        raise ValueError(f"TMAX {TMAX} outside 1..{TMAX_LIMIT}")
    if a < 1:
        raise ValueError("the match score a must be >= 1")
    out = torch.empty((6, N), dtype=torch.int32, device=query.device)
    if N == 0:
        return out
    if N >= FITS16:
        raise ValueError(f"{N} jobs: at most {FITS16 - 1} a launch")
    work = torch.empty(N + WORK_HEADER, dtype=torch.int32,
                       device=query.device)
    rowmax = (torch.empty(N * TMAX, dtype=torch.int32, device=query.device)
              if TMAX > SMEM_TMAX else None)
    lib = _load()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.bm_sw_local(
        query.data_ptr(), target.data_ptr(), qlen.data_ptr(),
        tlen.data_ptr(), minsc.data_ptr(), mat.data_ptr(), work.data_ptr(),
        0 if rowmax is None else rowmax.data_ptr(), out.data_ptr(), N,
        QMAX, TMAX, int(o_del), int(e_del), int(o_ins), int(e_ins),
        int(a), int(rev_skip), stream)
    if rc != 0:
        raise RuntimeError("local SW kernel launch failed: "
                           + lib.bm_sw_error_string(rc).decode())
    with _lock:
        LAUNCHES += 1
    return out


def fits_i16(qlen, tlen, mat, o_del: int, e_del: int, o_ins: int,
             e_ins: int, QMAX: int, TMAX: int):
    """The per-job condition under which the kernel runs a job on 16-bit
    cells. A local score is at most amax (the matrix's largest entry, at
    least 0) times the matched pairs, so every H, E and M of a job is at
    most amax * min(qcol, rows) (qcol = min(qlen, QMAX), rows =
    min(tlen, TMAX); the kernel scores the columns past qcol at -128, so
    they stay below the live ones). F's running term adds e_ins times the
    columns of the job's width class plus one (class_cols), and the
    largest gap open is kept as margin. All of it must stay below 2^14,
    which keeps the sentinel NEG16 = -2^14 and the terms subtracted from
    it above -2^15. The matrix's entries must fit a signed byte (the
    kernel's score profile) and the gap penalties must not be negative.
    Local SW needs no bound on amax: the 16-bit step is max(hd + s, E, 0)
    as on int32 cells. Returns an (N,) bool tensor on qlen's device, with
    no host sync."""
    m = mat.to(device=qlen.device, dtype=torch.int64)
    amax = m.max().clamp(min=0)
    cols = qlen.to(torch.int64).clamp(0, QMAX)
    rows = tlen.to(torch.int64).clamp(0, TMAX)
    top = (amax * torch.minimum(cols, rows) + e_ins * (class_cols(cols) + 1)
           + max(o_del + e_del, o_ins + e_ins))
    gaps_ok = min(o_del, e_del, o_ins, e_ins) >= 0
    return ((top < I16_LIMIT) & (m.min() >= -128) & (m.max() <= 127)
            & gaps_ok)


def class_cols(cols):
    """The most query columns of each job's width class (the first of
    extend_kernel.CLASS_COLS that holds its cols columns)."""
    cc = torch.tensor(CLASS_COLS, device=cols.device)
    return cc[torch.bucketize(cols, cc).clamp(max=len(CLASS_COLS) - 1)]


def _sweep_plain(q, t, qlen, tlen, matf, o_del, e_del, o_ins, e_ins,
                 want_rowmax: bool, dp_dtype=torch.int64):
    """One forward local-SW sweep over all rows for all jobs, the DP cells
    (H, E, M and F's running term) in `dp_dtype`. Returns best, qe, te
    (-1 when best is 0) and, if asked, the (N, TMAX) row maxima (0 at
    rows past tlen), all int64."""
    N, QMAX = q.shape
    TMAX = t.shape[1]
    dev = q.device
    dt = dp_dtype
    neg = NEG16 if dt == torch.int16 else NEG
    oe_del = o_del + e_del
    j = torch.arange(QMAX, device=dev, dtype=torch.int64)[None, :]
    ej = (e_ins * j).to(dt)
    qmask = j < qlen[:, None]
    zcol = torch.zeros((N, 1), dtype=dt, device=dev)
    negcol = torch.full((N, 1), neg, dtype=dt, device=dev)
    H = torch.zeros((N, QMAX), dtype=dt, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(N, dtype=torch.int64, device=dev)
    qe = torch.full_like(best, -1)
    te = torch.full_like(best, -1)
    rowmax = (torch.zeros((N, TMAX), dtype=torch.int64, device=dev)
              if want_rowmax else None)
    nrows = min(TMAX, int(tlen.max())) if N else 0
    matf = matf.to(dt)
    # rows past a job's tlen update its H and E but nothing it reports
    for i in range(nrows):
        active = i < tlen
        S = matf[t[:, i, None] * 5 + q]
        M = torch.cat([zcol, H[:, :-1]], dim=1) + S
        E = torch.maximum(E - e_del, H - oe_del).clamp(min=0)
        Hp = torch.where(qmask, torch.maximum(M, E).clamp(min=0), 0)
        # columns past qlen feed no live column: they stay out of F's
        # running max, so its terms stay within the live cells' range
        Gc = torch.cummax(torch.where(qmask, Hp + ej, neg), dim=1).values
        F = torch.cat([negcol, Gc[:, :-1]], dim=1) - ej - o_ins
        H = torch.where(qmask, torch.maximum(Hp, F).clamp(min=0), 0)
        rmax = H.max(dim=1).values.to(torch.int64)
        rj = torch.where(H == rmax[:, None], j, QMAX).min(dim=1).values
        upd = active & (rmax > best)
        best = torch.where(upd, rmax, best)
        qe = torch.where(upd, rj, qe)
        te = torch.where(upd, i, te)
        if want_rowmax:
            rowmax[:, i] = torch.where(active, rmax, 0)
    return best, qe, te, rowmax


def sw_align_batch_plain(query, target, qlen, tlen, minsc, mat, o_del: int,
                         e_del: int, o_ins: int, e_ins: int, a: int,
                         rev_skip: int = 0, dp_dtype=torch.int64):
    """Plain PyTorch version of the kernel: one target row for all jobs
    per step, the intra-row F dependency closed with torch.cummax; then
    score2 and the reverse sweep over the reversed prefixes. Same contract
    as sw_align_batch. dp_dtype torch.int16 holds the DP cells in 16 bits
    with NEG16 as F's sentinel, as the kernel's 16-bit route does (tests
    hold it to the int64 version on the jobs fits_i16 admits)."""
    N = query.shape[0]
    if N > _PLAIN_BLOCK:  # bound the (N, QMAX) and (N, TMAX) temporaries
        return torch.cat([sw_align_batch_plain(
            *(x[i:i + _PLAIN_BLOCK] for x in (query, target, qlen, tlen,
                                               minsc)),
            mat, o_del, e_del, o_ins, e_ins, a, rev_skip, dp_dtype)
            for i in range(0, N, _PLAIN_BLOCK)], dim=1)
    dev = query.device
    QMAX = query.shape[1]
    TMAX = target.shape[1]
    q = query.to(torch.int64).clamp(0, 4)
    t = target.to(torch.int64).clamp(0, 4)
    qlen = qlen.to(torch.int64).clamp(0, QMAX)
    tlen = tlen.to(torch.int64).clamp(0, TMAX)
    matf = mat.to(device=dev, dtype=torch.int64).reshape(-1)
    gaps = (o_del, e_del, o_ins, e_ins)
    best, qe, te, rowmax = _sweep_plain(q, t, qlen, tlen, matf, *gaps, True,
                                        dp_dtype)

    # score2: best row max >= minsc outside te +- ceil(best / a)
    r = torch.arange(TMAX, device=dev, dtype=torch.int64)[None, :]
    halfw = (best + a - 1) // a
    outside = (r < (te - halfw)[:, None]) | (r > (te + halfw)[:, None])
    ok = outside & (rowmax >= minsc.to(torch.int64)[:, None])
    score2 = torch.where(ok, rowmax, 0).max(dim=1).values if TMAX else \
        torch.zeros_like(best)

    # reverse sweep over q[qe..0], t[te..0]
    live = best >= max(rev_skip, 0)
    rqlen = torch.where(live, (qe + 1).clamp(min=0), 0)
    rtlen = torch.where(live, (te + 1).clamp(min=0), 0)
    jq = torch.arange(QMAX, device=dev, dtype=torch.int64)[None, :]
    rq = q.gather(1, (qe[:, None] - jq).clamp(0, QMAX - 1))
    rt = t.gather(1, (te[:, None] - r).clamp(0, max(TMAX - 1, 0)))
    rbest, rqe, rte, _ = _sweep_plain(rq, rt, rqlen, rtlen, matf, *gaps,
                                      False, dp_dtype)
    good = live & (rbest == best)
    qb = torch.where(good, qe - rqe, -1)
    tb = torch.where(good, te - rte, -1)
    return torch.stack([best, qb, qe, tb, te, score2]).to(torch.int32)
