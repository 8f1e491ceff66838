"""SMEM seeding's FM walks as CUDA kernels (mode "smem" of
ops/seeding.smem_seed_batch): the wrappers and their plain versions.

  S1 seed_forward         csrc/seed_forward.cu   round-1 forward walk of
                          each read, and round 3's in the same launch
  S2 seed_backward        csrc/seed_backward.cu  each candidate lane
                          extended to the left (rounds 1 and 2)
  S3 seed_reseed_forward  csrc/seed_forward.cu   round-2 re-seed walks
  S4 sa_lookup            csrc/sa_lookup.cu      each SMEM's occurrences
                          and their text positions (two kernels a call)

They replace the XLA loops of bwamem_tpu/ops/seeding.py smem_seed_batch
(_forward_pass2, _forward_pass, _seed_strategy_pass, _backward_pass,
_reseed_forward, and _expand_occurrences' row arithmetic) and
bwamem_tpu/ops/fm.py sa_lookup_batch; no Pallas kernel stands behind
them. The plain versions are the port's torch
functions in ops/seeding.py and ops/fm.py. Each source is compiled with
nvcc for sm_90a into the package's `_build/` directory on first use
(ops/kernels/build.py) and called through a plain C entry point with
ctypes; the four share csrc/fm_index.cuh.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other. The
kernels equal the plain versions on every entry the seeding reads: S4 in
every field of every occurrence, in order; S1 and S3 on their emit
(filled) masks and the values of every emitted entry (the rest of those
planes is left unwritten); S2 on every
lane that ops/seeding._containment_filter keeps, so on the final seeds
(its early kill runs within a warp only, so the raw (qb, k, s) of a lane
that either version killed may differ).

S1 walks each read, and S3 each re-seed lane, on a group of lanes
(csrc/fm_index.cuh's lane-group form): two lanes a row query, each end of
the interval on a lane pair.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import fm as fmops
from . import build as _kbuild
from .build import check as _check

# library -> its source; seed_forward.cu holds S1 and S3
SOURCES = {"seed_forward": _kbuild.CSRC / "seed_forward.cu",
           "seed_backward": _kbuild.CSRC / "seed_backward.cu",
           "sa_lookup": _kbuild.CSRC / "sa_lookup.cu"}

# kernel launches since import (or the last reset by the caller); each
# wrapper adds one per launch of its kernel and nowhere else
LAUNCHES = dict(seed_forward=0, seed_backward=0, seed_reseed_forward=0,
                sa_lookup=0)
BUILD_LOG: dict = {}

_lock = threading.Lock()
_libs: dict = {}

_FM_FIELDS = ("occ", "occ2", "L2", "primary", "start2", "pat", "sa1",
              "n_occ", "ssa_vals", "ssa_hi")


class _FMPtrs(ctypes.Structure):
    """csrc/fm_index.cuh FMPtrs: device pointers of the index's tensors."""
    _fields_ = [(n, ctypes.c_void_p) for n in _FM_FIELDS]


def _lib_path(name: str):
    return _kbuild.BUILD_DIR / f"lib{name}.so"


def build(name: str) -> float:
    """Compile library `name` (a key of SOURCES) if it is missing or
    older than its source or a header. Returns the seconds spent
    compiling (0 when up to date); the compiler's output (register and
    spill report) is kept in BUILD_LOG[name]."""
    secs, log = _kbuild.build(SOURCES[name], _lib_path(name))
    if log is not None:
        BUILD_LOG[name] = log
    return secs


def _load(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_lib_path(name)))
            vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fmp = ctypes.POINTER(_FMPtrs)
            if name == "seed_forward":
                lib.bm_seed_forward.argtypes = (
                    [fmp, vp, vp] + [ci] * 8 + [cll] + [vp] * 9)
                lib.bm_seed_forward.restype = ci
                lib.bm_seed_reseed_forward.argtypes = (
                    [fmp, vp, vp, ci, ci, vp, vp, vp] + [ci] * 4
                    + [vp] * 5)
                lib.bm_seed_reseed_forward.restype = ci
                err = lib.bm_seed_error_string
            elif name == "seed_backward":
                lib.bm_seed_backward.argtypes = (
                    [fmp, vp, ci, ci] + [vp] * 6 + [ci, ci] + [vp] * 4)
                lib.bm_seed_backward.restype = ci
                err = lib.bm_seed_backward_error_string
            else:
                lib.bm_sa_tiles.argtypes = [cll]
                lib.bm_sa_tiles.restype = cll
                lib.bm_sa_count.argtypes = [vp, vp, cll, ci, cll, vp, vp, vp]
                lib.bm_sa_count.restype = ci
                lib.bm_sa_lookup.argtypes = (
                    [fmp] + [vp] * 5 + [cll, ci, ci, cll, vp, vp, cll]
                    + [vp] * 6)
                lib.bm_sa_lookup.restype = ci
                err = lib.bm_sa_lookup_error_string
            err.argtypes = [ci]
            err.restype = ctypes.c_char_p
            lib.error_string = err
            _libs[name] = lib
    return lib


def _on_card(x, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _same_device(dev, *xs):
    for x in xs:
        if x is not None and x.device != dev:
            raise ValueError("all inputs and the index must be on one "
                             "device")


def _fm_ptrs(fm, dev) -> _FMPtrs:
    """The index's device pointers, each field checked (dtype, shape,
    contiguity, device; the table rows 16-byte aligned for vector
    loads)."""
    n_ssa = fm.ssa_vals.shape[0]
    fields = (
        ("occ", fm.occ_blocks, torch.int32, (fm.occ_blocks.shape[0], 8)),
        ("occ2", fm.occ2_blocks, torch.int32, (fm.occ2_blocks.shape[0], 32)),
        ("L2", fm.L2, torch.int64, (5,)),
        ("primary", fm.primary, torch.int64, ()),
        ("start2", fm.occ2_start, torch.int64, (16,)),
        ("pat", fm.occ2_pat, torch.int64, (3, 16)),
        ("sa1", fm.sa1_scalars, torch.int32, (2,)),
        ("n_occ", fm.n_occ_blocks, torch.int32, ()),
        ("ssa_vals", fm.ssa_vals, torch.int32, (n_ssa,)),
        ("ssa_hi", fm.ssa_vals_hi, torch.uint8, (n_ssa,)))
    ptrs = {}
    for name, x, dtype, shape in fields:
        _check(x, f"fm.{name}", dtype, shape)
        _same_device(dev, x)
        if name in ("occ", "occ2") and x.data_ptr() % 16:
            raise ValueError(f"fm.{name}: rows must be 16-byte aligned")
        ptrs[name] = x.data_ptr()
    if fm.has_occ2 and fm.occ2_blocks.shape[0] == 0:
        raise ValueError("fm.has_occ2 without an occ2 table")
    return _FMPtrs(**ptrs)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.error_string(rc).decode())


def seed_forward(fm, reads, lens, min_seed_len: int, strategy=None):
    """Round-1 forward walks of (B, L) reads (codes, 4 = N or pad) with
    (B,) lengths. strategy: None, or (min_len, max_intv) of the round-3
    automaton, run in the same walk. Returns ((seg, k, s, emit), r3):
    the (B, NP) planes of ops/seeding._forward_pass2 (NP = 2 * ((L + 2)
    // 2)) on an occ2 index, of _forward_pass (NP = L + 1) without one;
    r3 the (x, k, s, emit) planes (B, L) of the round-3 automaton
    (_seed_strategy_pass), None without a strategy. From the kernel, seg,
    k and s (x, k, s) hold values only where emit is set."""
    if not _on_card(reads, "seed_forward"):
        return seed_forward_plain(fm, reads, lens, min_seed_len, strategy)
    dev = reads.device
    reads = reads.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    _same_device(dev, lens)
    B, L = reads.shape
    _check(lens, "lens", torch.int32, (B,))
    dt = fmops.idx_dt(fm)
    pairs = bool(fm.has_occ2)
    NP = 2 * ((L + 2) // 2) if pairs else L + 1

    def planes(n):
        return (torch.empty((B, n), dtype=torch.int32, device=dev),
                torch.empty((B, n), dtype=dt, device=dev),
                torch.empty((B, n), dtype=dt, device=dev),
                torch.empty((B, n), dtype=torch.bool, device=dev))

    out = planes(NP)
    r3 = planes(L) if strategy is not None else None
    if B == 0:
        return out, r3
    ptrs = _fm_ptrs(fm, dev)
    min_len3, max_intv3 = strategy if strategy is not None else (0, 0)
    lib = _load("seed_forward")
    rc = lib.bm_seed_forward(
        ctypes.byref(ptrs), reads.data_ptr(), lens.data_ptr(), B, L, NP,
        int(fm.wide), int(pairs), int(min_seed_len),
        int(strategy is not None), int(min_len3), int(max_intv3),
        *(x.data_ptr() for x in out),
        *((x.data_ptr() for x in r3) if r3 is not None else (0,) * 4),
        _stream(dev))
    _raise(lib, rc, "seed_forward")
    _count("seed_forward")
    return out, r3


def seed_forward_plain(fm, reads, lens, min_seed_len: int, strategy=None):
    """seed_forward's plain version: ops/seeding._forward_pass2 (its
    strategy trips included) on an occ2 index, else _forward_pass and
    then, with a strategy, _seed_strategy_pass."""
    from .. import seeding

    reads = reads.to(torch.int32)
    lens = lens.to(torch.int32)
    if fm.has_occ2:
        out = seeding._forward_pass2(fm, reads, lens, min_seed_len,
                                     strategy=strategy)
        return tuple(out[:4]), (out[4] if strategy is not None else None)
    out = seeding._forward_pass(fm, reads, lens, min_seed_len)
    r3 = (seeding._seed_strategy_pass(fm, reads, lens, *strategy)
          if strategy is not None else None)
    return out, r3


def seed_backward(fm, reads, rid, qbeg, k, s, floor=None, group=None):
    """Each (P,) lane (read rid, segment start qbeg, k-side interval (k,
    s)) extended maximally to the left: ops/seeding._backward_pass in mode
    "smem" (floor: the lanes' minimum interval size, 1 by default; group:
    the early kill's segment key, rid by default; lanes in (group, end)
    order). Returns (qb, k, s). The kernel's early kill compares a lane
    only with the next lane of its warp, so the raw (qb, k, s) of a lane
    that either version killed may differ; every lane that
    _containment_filter keeps is the same, and so is the keep mask."""
    if not _on_card(reads, "seed_backward"):
        from .. import seeding

        return seeding._backward_pass(fm, reads, rid, qbeg, k, s,
                                      floor=floor, group=group)
    dev = reads.device
    dt = fmops.idx_dt(fm)
    reads = reads.to(torch.int32).contiguous()
    B, L = reads.shape
    P = qbeg.shape[0]
    ins = dict(rid=rid.to(torch.int32), qbeg=qbeg.to(torch.int32),
               k=k.to(dt), s=s.to(dt),
               floor=None if floor is None else floor.to(dt),
               group=None if group is None else group.to(torch.int32))
    for name, x in ins.items():
        if x is not None:
            x = ins[name] = x.contiguous()
            _check(x, name, x.dtype, (P,))
            _same_device(dev, x)
    qb_out = torch.empty(P, dtype=torch.int32, device=dev)
    k_out = torch.empty(P, dtype=dt, device=dev)
    s_out = torch.empty(P, dtype=dt, device=dev)
    if P == 0:
        return qb_out, k_out, s_out
    ptrs = _fm_ptrs(fm, dev)
    lib = _load("seed_backward")
    rc = lib.bm_seed_backward(
        ctypes.byref(ptrs), reads.data_ptr(), B, L,
        *(0 if x is None else x.data_ptr() for x in ins.values()), P,
        int(fm.wide), qb_out.data_ptr(), k_out.data_ptr(), s_out.data_ptr(),
        _stream(dev))
    _raise(lib, rc, "seed_backward")
    _count("seed_backward")
    return qb_out, k_out, s_out


def seed_reseed_forward(fm, reads, lens, lrid, lx, lfloor,
                        min_seed_len: int):
    """Round-2 split re-seed forward walks of (R,) lanes (read lrid, start
    lx, floor lfloor): ops/seeding._reseed_forward. Returns the (R, L + 2)
    planes (kb, sb, eb, filled); from the kernel, kb, sb and eb hold
    values only where filled is set."""
    if not _on_card(reads, "seed_reseed_forward"):
        from .. import seeding

        return seeding._reseed_forward(fm, reads, lens, lrid, lx, lfloor,
                                       min_seed_len)
    dev = reads.device
    dt = fmops.idx_dt(fm)
    reads = reads.to(torch.int32).contiguous()
    B, L = reads.shape
    R = lrid.shape[0]
    lens = lens.to(torch.int32).contiguous()
    _check(lens, "lens", torch.int32, (B,))
    ins = [x.contiguous() for x in (lrid.to(torch.int32),
                                    lx.to(torch.int32), lfloor.to(dt))]
    for name, x in zip(("lrid", "lx", "lfloor"), ins):
        _check(x, name, x.dtype, (R,))
    _same_device(dev, lens, *ins)
    W = L + 2
    kb = torch.empty((R, W), dtype=dt, device=dev)
    sb = torch.empty((R, W), dtype=dt, device=dev)
    eb = torch.empty((R, W), dtype=torch.int32, device=dev)
    fill = torch.empty((R, W), dtype=torch.bool, device=dev)
    if R == 0:
        return kb, sb, eb, fill
    ptrs = _fm_ptrs(fm, dev)
    lib = _load("seed_forward")
    rc = lib.bm_seed_reseed_forward(
        ctypes.byref(ptrs), reads.data_ptr(), lens.data_ptr(), B, L,
        *(x.data_ptr() for x in ins), R, int(fm.wide), int(fm.has_occ2),
        int(min_seed_len), kb.data_ptr(), sb.data_ptr(), eb.data_ptr(),
        fill.data_ptr(), _stream(dev))
    _raise(lib, rc, "seed_reseed_forward")
    _count("seed_reseed_forward")
    return kb, sb, eb, fill


def sa_lookup(fm, rid, qbeg, qend, k, s, keep, max_occ: int):
    """The occurrences of (N,) SMEMs (read rid, query span [qbeg, qend),
    k-side interval (k, s), keep mask) under max_occ:
    ops/seeding._expand_occurrences. Returns its dict of (total,) fields
    read_id, qbeg, qend (int32), rbeg and n_occ (the index's position
    dtype), in (SMEM, SA rank) order. Two kernels a call; between them
    the host reads the tiles' counts, whose sum sizes the output."""
    if not _on_card(k, "sa_lookup"):
        from .. import seeding

        return seeding._expand_occurrences(fm, rid, qbeg, qend, k, s, keep,
                                           max_occ)
    if max_occ < 1:
        raise ValueError(f"sa_lookup: max_occ {max_occ} is below 1")
    dev = k.device
    dt = fmops.idx_dt(fm)
    N = k.shape[0]
    i32 = torch.int32
    ins = dict(rid=rid.to(i32), qbeg=qbeg.to(i32), qend=qend.to(i32),
               k=k.to(dt), s=s.to(dt), keep=keep.to(torch.bool))
    for name, x in ins.items():
        x = ins[name] = x.contiguous()
        _check(x, name, x.dtype, (N,))
        _same_device(dev, x)
    if N == 0:
        return dict(read_id=ins["rid"], qbeg=ins["qbeg"], qend=ins["qend"],
                    rbeg=ins["k"], n_occ=ins["s"])
    lib = _load("sa_lookup")
    loc = torch.empty(N, dtype=torch.int64, device=dev)
    tot = torch.empty(lib.bm_sa_tiles(N), dtype=torch.int64, device=dev)
    rc = lib.bm_sa_count(ins["s"].data_ptr(), ins["keep"].data_ptr(), N,
                         int(fm.wide), int(max_occ), loc.data_ptr(),
                         tot.data_ptr(), _stream(dev))
    _raise(lib, rc, "sa_lookup")
    total = int(tot.cpu().sum())
    out = dict(read_id=torch.empty(total, dtype=i32, device=dev),
               qbeg=torch.empty(total, dtype=i32, device=dev),
               qend=torch.empty(total, dtype=i32, device=dev),
               rbeg=torch.empty(total, dtype=dt, device=dev),
               n_occ=torch.empty(total, dtype=dt, device=dev))
    ptrs = _fm_ptrs(fm, dev)
    rc = lib.bm_sa_lookup(
        ctypes.byref(ptrs), *(ins[n].data_ptr() for n in (
            "rid", "qbeg", "qend", "k", "s")), N, int(fm.wide),
        int(fm.sa_intv), int(max_occ), loc.data_ptr(), tot.data_ptr(),
        total, *(x.data_ptr() for x in out.values()), _stream(dev))
    _raise(lib, rc, "sa_lookup")
    _count("sa_lookup")
    return out
