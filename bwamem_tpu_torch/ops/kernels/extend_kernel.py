"""Dense ksw_extend2 over a batch: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (csrc/extend_kernel.cu) replaces the Pallas TPU kernel
bwamem_tpu/ops/pallas/extend_kernel.py:_make_kernel. It is compiled with
nvcc for sm_90a into the package's `_build/` directory on first use
(ops/kernels/build.py) and called through a plain C entry point with
ctypes.

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
_PLAIN_BLOCK = 16384  # jobs per step of the plain version

SOURCE = _kbuild.CSRC / "extend_kernel.cu"
_LIB_PATH = _kbuild.BUILD_DIR / "libextend_kernel.so"

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
            lib.bm_extend_dense.argtypes = [vp] * 7 + [ci] * 12 + [vp]
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
    global LAUNCHES
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
    if QMAX + 1 > 32 * 32:
        raise ValueError(f"QMAX {QMAX} > 1023 is not supported")
    out = torch.empty((N, 6), dtype=torch.int32, device=query.device)
    if N == 0:
        return _fields(out)
    lib = _load()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.bm_extend_dense(
        query.data_ptr(), target.data_ptr(), qlen.data_ptr(),
        tlen.data_ptr(), h0.data_ptr(), mat.data_ptr(), out.data_ptr(),
        N, QMAX, TMAX, int(p.o_del), int(p.e_del), int(p.o_ins),
        int(p.e_ins), int(p.w), int(p.zdrop), int(p.end_bonus),
        int(bool(p.opt_ext)), int(p.max_mat), stream)
    if rc != 0:
        raise RuntimeError("extend kernel launch failed: "
                           + lib.bm_error_string(rc).decode())
    with _lock:
        LAUNCHES += 1
    return _fields(out)


def extend_batch_plain(query, target, qlen, tlen, h0, mat, params):
    """Plain PyTorch version of the kernel: the row loop of the JAX
    twin's extend_batch, one target row for all alignments per step, the
    intra-row F dependency closed with torch.cummax. Same contract as
    extend_batch."""
    N = query.shape[0]
    if N > _PLAIN_BLOCK:  # bound the (N, QMAX) temporaries
        parts = [extend_batch_plain(*(a[i:i + _PLAIN_BLOCK] for a in (
            query, target, qlen, tlen, h0)), mat, params)
            for i in range(0, N, _PLAIN_BLOCK)]
        return {k: torch.cat([o[k] for o in parts]) for k in parts[0]}
    p = params
    dev = query.device
    QMAX = query.shape[1]
    TMAX = target.shape[1]
    query = query.to(torch.int64)
    target = target.to(torch.int64)
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    h0 = h0.to(torch.int64)
    matf = mat.to(device=dev, dtype=torch.int64).reshape(-1)
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
    E = torch.zeros_like(H)
    qmask = u <= qlen[:, None]
    qcol = qlen.clamp(0, QMAX)[:, None]
    qcodes = query.clamp(0, 4)
    zcol = torch.zeros((N, 1), dtype=torch.int64, device=dev)
    negcol = torch.full((N, 1), NEG, dtype=torch.int64, device=dev)

    best = h0.clone()
    qle = torch.zeros_like(h0)
    tle = torch.zeros_like(h0)
    gscore = torch.full_like(h0, -1)
    gtle = torch.zeros_like(h0)
    max_off = torch.zeros_like(h0)
    dead = tlen <= 0
    for i in range(TMAX):
        if i % 8 == 0 and bool(dead.all()):
            break  # every later row is a no-op
        tchar = target[:, i].clamp(0, 4)
        active = ~dead & (i < tlen)
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

        G = (Mx - oe_ins).clamp(min=0) + p.e_ins * u
        G[:, 0] = NEG
        Gc = torch.cummax(G, dim=1).values
        F = (torch.cat([negcol, Gc[:, :-1]], dim=1)
             - p.e_ins * (u - 1)).clamp(min=0)
        F = torch.where(live, F, 0)

        Hn = torch.maximum(torch.maximum(Mx, Ex), F)
        Hn[:, 0] = (h0 - (p.o_del + p.e_del * (i + 1))).clamp(min=0)
        En = torch.where(live, torch.maximum(Ex - p.e_del,
                                             (Mx - oe_del).clamp(min=0)), 0)

        # row max over real columns u >= 1, tie -> LAST column
        Ht = torch.where(live & (u >= 1), Hn, -1)
        rowmax = Ht.max(dim=1).values
        mj = torch.where(Ht == rowmax[:, None], u, -1).max(dim=1).values

        # gscore (to-query-end), tie -> LATER row
        h_end = Hn.gather(1, qcol)[:, 0]
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
    out = torch.stack([best, qle, tle, gscore, gtle, max_off], dim=1)
    return _fields(out.to(torch.int32))
