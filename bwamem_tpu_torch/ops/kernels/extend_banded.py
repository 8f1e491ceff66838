"""Banded ksw_extend2 over a batch, on a sliding window of
WP = round128(2w + 3) lanes: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (csrc/extend_banded.cu) replaces the Pallas TPU kernel
bwamem_tpu/ops/pallas/extend_banded.py:_make_banded_kernel. It first
orders the alignments on the device (those that take 16-bit cells,
fits_i16, first, then by rows) into a workspace this wrapper allocates,
and runs two a warp on 16-bit cells where both fit. It is compiled
with nvcc for sm_90a into the package's `_build/` directory on first use
(ops/kernels/build.py) and called through a plain C entry point with
ctypes. Its contract is the dense kernel's with opt_ext (the band applied
inside the DP), so for a band window narrower than the query it gives
what extend_kernel.extend_batch gives, at O(WP) work per target row.

`extend_batch_banded` launches the kernel for CUDA tensors and runs
`extend_batch_banded_plain` — a torch port of the Pallas kernel's window
row loop, kept apart from the dense plain version so that the window
anchoring itself is held on the CPU — for CPU tensors. It never falls back
from one to the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build as _kbuild
from .build import check as _check
from .extend_kernel import (_SMEM_BYTES, FITS16, I16_LIMIT, NEG, NEG16,
                            WORK_HEADER, _fields)

_PLAIN_BLOCK = 16384  # jobs per step of the plain version
WP_LIMIT = 1024       # window lanes the kernel holds in registers


def qmax_limit(w: int) -> int:
    """The widest query the kernel takes at band w: one warp's two score
    profiles (5 bytes a column of QMAX + w + WP/32 + 8, rounded to 4)
    must fit a block's shared memory."""
    return _SMEM_BYTES // 10 // 4 * 4 - 3 - int(w) - window_lanes(w) // 32 - 8

SOURCE = _kbuild.CSRC / "extend_banded.cu"
_LIB_PATH = _kbuild.BUILD_DIR / "libextend_banded.so"

# kernel launches since import (or the last reset by the caller); the
# wrapper adds one per launch and nowhere else
LAUNCHES = 0
BUILD_LOG = ""

_lock = threading.Lock()
_lib = None


def window_lanes(w: int) -> int:
    """WP = round128(2w + 3): the band window's lane count."""
    return -(-(2 * int(w) + 3) // 128) * 128


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
            lib.bm_extend_banded.argtypes = [vp] * 8 + [ci] * 11 + [vp]
            lib.bm_extend_banded.restype = ci
            lib.bm_banded_error_string.argtypes = [ci]
            lib.bm_banded_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def extend_batch_banded(query, target, qlen, tlen, h0, mat, params):
    """Banded ksw_extend2 (opt_ext semantics) over N alignments.

    query (N, QMAX) and target (N, TMAX) base codes 0..4 (int8 on CUDA);
    qlen, tlen, h0 (N,) int32 (h0 > 0 for real lanes, qlen <= QMAX);
    mat (5, 5) int32; params: ExtendParams (opt_ext is implied; w sets
    the window; QMAX at most qmax_limit(w)). Returns
    the dense kernel's dict of (N,) int32 tensors: score, qle, tle,
    gscore, gtle, max_off."""
    global LAUNCHES
    if query.device.type == "cpu":
        return extend_batch_banded_plain(query, target, qlen, tlen, h0, mat,
                                         params)
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
    if p.w < 0 or window_lanes(p.w) > WP_LIMIT:
        raise ValueError(f"band w={p.w}: the window of "
                         f"{window_lanes(p.w)} lanes is outside "
                         f"128..{WP_LIMIT}")
    if QMAX > qmax_limit(p.w):
        raise ValueError(f"QMAX {QMAX} past {qmax_limit(p.w)} at w={p.w}")
    out = torch.empty((N, 6), dtype=torch.int32, device=query.device)
    if N == 0:
        return _fields(out)
    if N >= FITS16:
        raise ValueError(f"{N} jobs: at most {FITS16 - 1} a launch")
    work = torch.empty(N + WORK_HEADER, dtype=torch.int32,
                       device=query.device)
    lib = _load()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.bm_extend_banded(
        query.data_ptr(), target.data_ptr(), qlen.data_ptr(),
        tlen.data_ptr(), h0.data_ptr(), mat.data_ptr(), work.data_ptr(),
        out.data_ptr(), N, QMAX, TMAX, int(p.o_del), int(p.e_del), int(p.o_ins),
        int(p.e_ins), int(p.w), int(p.zdrop), int(p.end_bonus),
        int(p.max_mat), stream)
    if rc != 0:
        raise RuntimeError("banded extension kernel launch failed: "
                           + lib.bm_banded_error_string(rc).decode())
    with _lock:
        LAUNCHES += 1
    return _fields(out)


def fits_i16(tlen, h0, mat, params, QMAX: int, TMAX: int):
    """The per-job condition under which the kernel runs an alignment on
    16-bit cells: extend_kernel.fits_i16 with the window's WP lanes in
    place of the strip group's columns (F's running term adds e_ins per
    window lane). Returns an (N,) bool tensor, with no host sync."""
    p = params
    m = mat.to(device=h0.device, dtype=torch.int64)
    amax = m.max().clamp(min=0)
    rows = tlen.to(torch.int64).clamp(0, TMAX)
    h = h0.to(torch.int64)
    top = (h + amax * rows + p.e_ins * (window_lanes(p.w) + 1)
           + max(p.o_del + p.e_del, p.o_ins + p.e_ins) + p.end_bonus)
    return ((h >= 0) & (top < I16_LIMIT) & (amax <= 1)
            & (m.min() >= -128))


def extend_batch_banded_plain(query, target, qlen, tlen, h0, mat, params,
                              dp_dtype=torch.int64):
    """Plain PyTorch version of the kernel: the Pallas kernel's window row
    loop, one target row for all alignments per step; lane v of row i is
    column u = i + v - w, the diagonal is the same lane of the previous
    window, E comes from the lane to its right, F is an exclusive running
    max along the window (torch.cummax). Same contract as
    extend_batch_banded, plus `rows`: the (N,) count of target rows each
    alignment ran (its DP work). dp_dtype torch.int16 holds the DP cells
    in 16 bits with NEG16 as F's sentinel, as the kernel's 16-bit route
    does (tests hold it to the int64 version where fits_i16 admits)."""
    N = query.shape[0]
    if N > _PLAIN_BLOCK:  # bound the temporaries
        parts = [extend_batch_banded_plain(*(a[i:i + _PLAIN_BLOCK] for a in (
            query, target, qlen, tlen, h0)), mat, params, dp_dtype)
            for i in range(0, N, _PLAIN_BLOCK)]
        return {k: torch.cat([o[k] for o in parts]) for k in parts[0]}
    p = params
    w = int(p.w)
    WP = window_lanes(w)
    dev = query.device
    QMAX = query.shape[1]
    TMAX = target.shape[1]
    q = query.to(torch.int64).clamp(0, 4)
    target = target.to(torch.int64)
    qlen = qlen.to(torch.int64)[:, None]
    tlen = tlen.to(torch.int64)
    h0 = h0.to(torch.int64)
    dt = dp_dtype
    neg = NEG16 if dt == torch.int16 else NEG
    matf = mat.to(device=dev, dtype=dt).reshape(-1)
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins
    v = torch.arange(WP, device=dev, dtype=torch.int64)[None, :]

    # per-lane band width (floor division, as the JAX twin)
    max_ins = ((qlen * p.max_mat + p.end_bonus - p.o_ins) // p.e_ins + 1
               ).clamp(min=1)
    max_del = ((qlen * p.max_mat + p.end_bonus - p.o_del) // p.e_del + 1
               ).clamp(min=1)
    w_lane = torch.minimum(torch.minimum(max_ins, max_del),
                           torch.full_like(max_ins, w))
    lane_live = (v >= w - w_lane + 1) & (v <= w + w_lane + 1)

    # the virtual row -1: lane v holds H(0, u0) at u0 = v - w - 1
    u0 = v - w - 1
    H = (h0[:, None] - p.o_ins - p.e_ins * u0).clamp(min=0)
    H = torch.where(u0 == 0, h0[:, None], H)
    H = torch.where((u0 >= 0) & (u0 <= qlen), H, 0).to(dt)
    E = torch.zeros_like(H)
    four = torch.full((N, 1), 4, dtype=torch.int64, device=dev)
    qi0 = u0[0]
    qwin = torch.where(((qi0 >= 0) & (qi0 < QMAX))[None, :],
                       q[:, qi0.clamp(0, QMAX - 1)], 4)
    eu = (p.e_ins * v).to(dt)
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
    w_lane = w_lane[:, 0]
    for i in range(TMAX):
        if i % 8 == 0 and bool(dead.all()):
            break  # every later row is a no-op
        tchar = target[:, i].clamp(0, 4)
        active = ~dead & (i < tlen)
        rows += active
        u = v + (i - w)
        live = (u >= 1) & (u <= qlen) & lane_live
        S = matf[tchar[:, None] * 5 + qwin]
        M = torch.where(H > 0, H + S, 0)
        Ex = torch.cat([E[:, 1:], zcol], dim=1)
        Mx = torch.where(live, M, 0)
        Exl = torch.where(live, Ex, 0)

        G = torch.where(u <= 0, neg, (Mx - oe_ins).clamp(min=0) + eu)
        Gc = torch.cummax(G, dim=1).values
        F = (torch.cat([negcol, Gc[:, :-1]], dim=1) - eu + p.e_ins
             ).clamp(min=0)
        F = torch.where(live, F, 0)

        Hn = torch.maximum(torch.maximum(Mx, Exl), F)
        b0 = (h0 - (p.o_del + p.e_del * (i + 1))).clamp(min=0)
        Hn = torch.where(u == 0, b0[:, None].to(dt), Hn)
        En = torch.maximum(Exl - p.e_del, (Mx - oe_del).clamp(min=0))

        # row max over live lanes, tie -> LARGEST u; mj -1 when none live
        Ht = torch.where(live, Hn, -1)
        rowmax = Ht.max(dim=1).values.to(torch.int64)
        lane = torch.where(Ht == rowmax[:, None], v, -1).max(dim=1).values
        mj = torch.where(rowmax >= 0, lane + (i - w), -1)

        # H(i, qlen); once the band has passed the query end, the dense
        # row's stored 0
        h_end = torch.where(u == qlen, Hn, neg).max(dim=1).values.to(
            torch.int64)
        h_end = torch.where(i - w > qlen[:, 0], 0, h_end)
        g_upd = active & (h_end >= gscore) & (i + w_lane + 1 >= qlen[:, 0])
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
        # slide the query window: the new right-edge code is
        # q[i + WP - w - 1] (4 past the query)
        qi = i + WP - w - 1
        qnew = q[:, qi:qi + 1] if 0 <= qi < QMAX else four
        qwin = torch.cat([qwin[:, 1:], qnew], dim=1)
    out = torch.stack([best, qle, tle, gscore, gtle, max_off, rows], dim=1)
    return dict(_fields(out.to(torch.int32)), rows=out[:, 6].to(torch.int32))
