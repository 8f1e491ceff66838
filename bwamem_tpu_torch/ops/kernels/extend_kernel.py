"""Dense ksw_extend2 over a batch: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (csrc/extend_kernel.cu) replaces the Pallas TPU kernel
bwamem_tpu/ops/pallas/extend_kernel.py:_make_kernel. Each job runs on a
group of lanes sized to its own width, its qcol = min(qlen, QMAX) query
columns: the kernel first bins the jobs by width class, then those that
take 16-bit cells (fits_i16), then by rows (job_bins states the rule),
and writes each result at its job's index. Jobs of up to 1024 columns run
from registers; wider ones take the kernel's wide route, which walks each
row in 512-column chunks with the row kept in shared memory, or in a
global scratch buffer that this wrapper allocates when one row does not
fit there. It is
compiled with nvcc for sm_90a into the package's `_build/` directory on
first use (ops/kernels/build.py) and called through a plain C entry
point with ctypes.

`extend_batch` launches the kernel for CUDA tensors and runs
`extend_batch_plain` — a torch port of the row loop in
bwamem_tpu/ops/extend.py:extend_batch — for CPU tensors. It never falls
back from one to the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build as _kbuild
from .build import check as _check

NEG = -0x40000000
NEG16 = -0x4000        # F's sentinel in 16-bit cells
I16_LIMIT = 1 << 14    # every 16-bit cell value stays below this
_PLAIN_BLOCK = 16384  # jobs per step of the plain version
REG_QMAX = 1024       # QMAX up to which every job takes the register route
# the kernel's width classes: the most query columns (qcol) each one
# takes; wider jobs are class len(CLASS_COLS), the wide route
CLASS_COLS = (32, 64, 128, 256, 512, 1024)
ROW_BINS = 22         # a job's rows in bins 0, 1, 2-3, 4-7, ..., 2^20 or more
FITS16 = 1 << 30      # a job-order entry's flag: the job takes 16-bit cells
WORK_HEADER = 1024    # int32 of the kernel's workspace before the job order
_CHUNK = 512          # the wide route's columns per chunk
_SMEM_BYTES = 232448  # shared memory a block may use on sm_90
QMAX_LIMIT = 1 << 20  # widest row the wrapper accepts

SOURCE = _kbuild.CSRC / "extend_kernel.cu"
_LIB_PATH = _kbuild.BUILD_DIR / "libextend_kernel.so"

# kernel launches since import (or the last reset by the caller); the
# wrapper adds one per launch and nowhere else, and WIDE_LAUNCHES one more
# when the launch runs the wide route (QMAX > REG_QMAX: the C entry point
# then launches it for the jobs past REG_QMAX columns)
LAUNCHES = 0
WIDE_LAUNCHES = 0
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
            lib.bm_extend_dense.argtypes = [vp] * 9 + [ci] * 12 + [vp]
            lib.bm_extend_dense.restype = ci
            lib.bm_error_string.argtypes = [ci]
            lib.bm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _fields(out):
    return dict(score=out[:, 0], qle=out[:, 1], tle=out[:, 2],
                gscore=out[:, 3], gtle=out[:, 4], max_off=out[:, 5])


def extend_batch(query, target, qlen, tlen, h0, mat, params):
    """Dense ksw_extend2 over N alignments.

    query (N, QMAX) and target (N, TMAX) base codes 0..4 (int8 on CUDA);
    qlen, tlen, h0 (N,) int32 (h0 > 0 for real lanes); mat (5, 5) int32;
    params: ExtendParams. Returns a dict of (N,) int32 tensors: score,
    qle, tle, gscore, gtle, max_off (qle/tle are consumed lengths,
    gscore = -1 when the query end was never reached)."""
    global LAUNCHES, WIDE_LAUNCHES
    if query.device.type == "cpu":
        return extend_batch_plain(query, target, qlen, tlen, h0, mat, params)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    N, QMAX = query.shape
    TMAX = target.shape[1]
    _check(query, "query", torch.int8, (N, QMAX))
    _check(target, "target", torch.int8, (N, TMAX))
    for name, x in (("qlen", qlen), ("tlen", tlen), ("h0", h0)):
        _check(x, name, torch.int32, (N,))
    _check(mat, "mat", torch.int32, (5, 5))
    for x in (target, qlen, tlen, h0, mat):
        if x.device != query.device:
            raise ValueError("all inputs must be on one device")
    p = params
    if p.e_del < 1 or p.e_ins < 1:
        raise ValueError("gap extension penalties must be >= 1")
    if not 1 <= QMAX <= QMAX_LIMIT:
        raise ValueError(f"QMAX {QMAX} outside 1..{QMAX_LIMIT}")
    out = torch.empty((N, 6), dtype=torch.int32, device=query.device)
    if N == 0:
        return _fields(out)
    if N >= FITS16:
        raise ValueError(f"{N} jobs: at most {FITS16 - 1} a launch")
    scratch = _wide_scratch(N, QMAX, query.device)
    work = torch.empty(N + WORK_HEADER, dtype=torch.int32,
                       device=query.device)
    lib = _load()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.bm_extend_dense(
        query.data_ptr(), target.data_ptr(), qlen.data_ptr(),
        tlen.data_ptr(), h0.data_ptr(), mat.data_ptr(), work.data_ptr(),
        out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), N,
        QMAX, TMAX,
        int(p.o_del), int(p.e_del), int(p.o_ins), int(p.e_ins), int(p.w),
        int(p.zdrop), int(p.end_bonus), int(bool(p.opt_ext)),
        int(p.max_mat), stream)
    if rc != 0:
        raise RuntimeError("extend kernel launch failed: "
                           + lib.bm_error_string(rc).decode())
    with _lock:
        LAUNCHES += 1
        WIDE_LAUNCHES += QMAX > REG_QMAX
    return _fields(out)


def job_bins(qlen, tlen, fits, QMAX: int, TMAX: int):
    """The kernel's job order, stated in torch ops (the kernel builds it
    on the device, csrc/extend_kernel.cu job_bin): each job's bin, the
    jobs taken in ascending bin order. A bin is the job's width class
    (the first of CLASS_COLS that holds its qcol columns, else the wide
    route), widest first; then the jobs that take 16-bit cells (`fits`,
    fits_i16's (N,) bool) first; then its rows, min(tlen, TMAX), by
    powers of two (ROW_BINS of them), most first: so the jobs a warp runs
    side by side are alike and the longest start first. Returns (bins,
    classes): (N,) int64 tensors on the inputs' device."""
    cols = qlen.to(torch.int64).clamp(0, QMAX)
    cls = torch.bucketize(cols, torch.tensor(CLASS_COLS, device=qlen.device))
    rows = tlen.to(torch.int64).clamp(0, TMAX)
    # 0 rows -> 0, else floor(log2(rows)) + 1, at most ROW_BINS - 1
    rb = torch.where(rows > 0, torch.frexp(rows.double())[1].to(torch.int64),
                     0).clamp(max=ROW_BINS - 1)
    key = (len(CLASS_COLS) - cls) * 2 + (~fits.to(torch.bool)).to(torch.int64)
    return key * ROW_BINS + (ROW_BINS - 1 - rb), cls


def _wide_scratch(N: int, QMAX: int, device):
    """The global row buffer of the wide route (H and E, 8 bytes a
    column) when one warp's row does not fit in a block's shared memory;
    None when it does, or when the register route takes the row."""
    if QMAX <= REG_QMAX:
        return None
    ncols = -(-QMAX // _CHUNK) * _CHUNK
    if ncols * 8 <= _SMEM_BYTES:
        return None
    return torch.empty(N * 2 * ncols, dtype=torch.int32, device=device)


def strip_cols(QMAX: int) -> int:
    """The most columns a register-route strip group of a launch of
    width QMAX spans: the width class that holds QMAX (1024 past it)."""
    return next((c for c in CLASS_COLS if c >= QMAX), CLASS_COLS[-1])


def fits_i16(tlen, h0, mat, params, QMAX: int, TMAX: int):
    """The per-job condition under which K1 runs a job on 16-bit cells
    (the JAX kernel's `use_i16` in per-job terms). A cell of target row i
    is at most h0 + amax * (i + 1) (amax: the matrix's largest entry, at
    least 0), whatever column it is in, so every H, E and M of a job is
    at most h0 + amax * min(tlen, TMAX); F's running term adds e_ins
    times the columns of the job's strip group plus one (strip_cols:
    the class's padded width, QMAX + 1 or more), and the largest gap open
    and the end bonus are kept as margin. All of it must stay below
    2^14, which also keeps the 16-bit sentinel NEG16 = -2^14 and the
    terms subtracted from it above -2^15. h0 must not be negative; the
    matrix's entries must fit a signed byte (the kernel's score profile)
    and its largest must be at most 1 (bwa's match score: the kernel's
    16-bit M step doubles the diagonal instead of multiplying). Returns
    an (N,) bool tensor on the inputs' device, with no host sync."""
    p = params
    m = mat.to(device=h0.device, dtype=torch.int64)
    amax = m.max().clamp(min=0)
    rows = tlen.to(torch.int64).clamp(0, TMAX)
    h = h0.to(torch.int64)
    top = (h + amax * rows + p.e_ins * (strip_cols(QMAX) + 1)
           + max(p.o_del + p.e_del, p.o_ins + p.e_ins) + p.end_bonus)
    return ((h >= 0) & (top < I16_LIMIT) & (amax <= 1)
            & (m.min() >= -128))


def extend_batch_plain(query, target, qlen, tlen, h0, mat, params):
    """Plain PyTorch version of the kernel: the row loop of the JAX
    twin's extend_batch, one target row for all alignments per step, the
    intra-row F dependency closed with torch.cummax. Same contract as
    extend_batch, plus `rows`: the (N,) count of target rows each
    alignment ran (its DP work)."""
    return _plain(query, target, qlen, tlen, h0, mat, params, torch.int64)


def _plain(query, target, qlen, tlen, h0, mat, params, dp_dtype):
    """extend_batch_plain with the DP cells (H, E, M, F and F's running
    term) held in `dp_dtype`; the trackers stay int64. torch.int16 runs
    the recurrence as a 16-bit kernel would, with NEG16 as F's sentinel
    (tests hold it to the int64 version on jobs fits_i16 admits)."""
    N = query.shape[0]
    if N > _PLAIN_BLOCK:  # bound the (N, QMAX) temporaries
        parts = [_plain(*(a[i:i + _PLAIN_BLOCK] for a in (
            query, target, qlen, tlen, h0)), mat, params, dp_dtype)
            for i in range(0, N, _PLAIN_BLOCK)]
        return {k: torch.cat([o[k] for o in parts]) for k in parts[0]}
    p = params
    dev = query.device
    QMAX = query.shape[1]
    TMAX = target.shape[1]
    dt = dp_dtype
    neg = NEG16 if dt == torch.int16 else NEG
    query = query.to(torch.int64)
    target = target.to(torch.int64)
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    h0 = h0.to(torch.int64)
    matf = mat.to(device=dev, dtype=dt).reshape(-1)
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins
    u = torch.arange(QMAX + 1, device=dev, dtype=torch.int64)[None, :]

    # per-lane band width (floor division, as the JAX twin)
    max_ins = ((qlen * p.max_mat + p.end_bonus - p.o_ins) // p.e_ins + 1
               ).clamp(min=1)
    max_del = ((qlen * p.max_mat + p.end_bonus - p.o_del) // p.e_del + 1
               ).clamp(min=1)
    w_lane = torch.minimum(torch.minimum(max_ins, max_del),
                           torch.full_like(max_ins, p.w))

    # first row: H(0, u) = max(h0 - o_ins - e_ins*u, 0), H(0, 0) = h0
    H = (h0[:, None] - p.o_ins - p.e_ins * u).clamp(min=0)
    H[:, 0] = h0
    H = H.to(dt)
    E = torch.zeros_like(H)
    ud = u.to(dt)
    qmask = u <= qlen[:, None]
    qcol = qlen.clamp(0, QMAX)[:, None]
    qcodes = query.clamp(0, 4)
    zcol = torch.zeros((N, 1), dtype=dt, device=dev)
    negcol = torch.full((N, 1), neg, dtype=dt, device=dev)

    best = h0.clone()
    qle = torch.zeros_like(h0)
    tle = torch.zeros_like(h0)
    gscore = torch.full_like(h0, -1)
    gtle = torch.zeros_like(h0)
    max_off = torch.zeros_like(h0)
    dead = tlen <= 0
    rows = torch.zeros_like(h0)
    for i in range(TMAX):
        if i % 8 == 0 and bool(dead.all()):
            break  # every later row is a no-op
        tchar = target[:, i].clamp(0, 4)
        active = ~dead & (i < tlen)
        rows += active
        S = matf[tchar[:, None] * 5 + qcodes]                   # (N, QMAX)
        Hd = H[:, :-1]                                          # H(i-1, u-1)
        M = torch.cat([zcol, torch.where(Hd > 0, Hd + S, 0)], dim=1)
        live = qmask
        if p.opt_ext:
            j = u - 1
            in_band = ((j >= i - w_lane[:, None])
                       & (j < i + w_lane[:, None] + 1)) | (u == 0)
            live = in_band & qmask
        Mx = torch.where(live, M, 0)
        Ex = torch.where(live, E, 0)

        G = (Mx - oe_ins).clamp(min=0) + p.e_ins * ud
        G[:, 0] = neg
        Gc = torch.cummax(G, dim=1).values
        F = (torch.cat([negcol, Gc[:, :-1]], dim=1)
             - p.e_ins * (ud - 1)).clamp(min=0)
        F = torch.where(live, F, 0)

        Hn = torch.maximum(torch.maximum(Mx, Ex), F)
        Hn[:, 0] = (h0 - (p.o_del + p.e_del * (i + 1))).clamp(min=0)
        En = torch.where(live, torch.maximum(Ex - p.e_del,
                                             (Mx - oe_del).clamp(min=0)), 0)

        # row max over real columns u >= 1, tie -> LAST column
        Ht = torch.where(live & (u >= 1), Hn, -1)
        rowmax = Ht.max(dim=1).values.to(torch.int64)
        mj = torch.where(Ht == rowmax[:, None], u, -1).max(dim=1).values

        # gscore (to-query-end), tie -> LATER row
        h_end = Hn.gather(1, qcol)[:, 0].to(torch.int64)
        g_upd = active & (h_end >= gscore)
        if p.opt_ext:
            g_upd = g_upd & (i + w_lane + 1 >= qlen)
        gscore = torch.where(g_upd, h_end, gscore)
        gtle = torch.where(g_upd, i + 1, gtle)

        # best local, strict improvement -> EARLIER row wins ties
        b_upd = active & (rowmax > best)
        best = torch.where(b_upd, rowmax, best)
        qle = torch.where(b_upd, mj, qle)
        tle = torch.where(b_upd, i + 1, tle)
        max_off = torch.where(
            b_upd, torch.maximum(max_off, (mj - 1 - i).abs()), max_off)

        # termination: row max 0, or z-drop (only when not improving)
        dead = dead | (active & (rowmax == 0))
        if p.zdrop > 0:
            di = i - (tle - 1)
            dj = (mj - 1) - (qle - 1)
            zd = torch.where(di > dj,
                             best - rowmax - (di - dj) * p.e_del > p.zdrop,
                             best - rowmax - (dj - di) * p.e_ins > p.zdrop)
            dead = dead | (active & ~b_upd & zd)
        dead = dead | (i + 1 >= tlen)

        H = torch.where(active[:, None], Hn, H)
        E = torch.where(active[:, None], En, E)
    out = torch.stack([best, qle, tle, gscore, gtle, max_off, rows], dim=1)
    return dict(_fields(out.to(torch.int32)), rows=out[:, 6].to(torch.int32))
