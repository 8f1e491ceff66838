"""The finalize with its CIGAR solve on the card: plan, solve, render.

At `-t 1` the native finalize (`native/loader.py` finalize_se_native /
finalize_pe_native) spends most of its time in one part: the banded
global alignment with traceback (gen_cigar) of every record it emits,
scalar, on the main thread. `DeviceFinalize` splits that call in three
(`csrc/finalize_split.cpp`, a host library built with g++ under the
native loader's flags):

  plan    mark primaries, pair, choose the records and list their
          gen_cigar calls as jobs with the retry loop's bands (native);
  solve   every job in one launch of K5 (`ops/kernels/cigar_kernel.py`;
          more where long jobs' tracebacks pass its scratch tile) on a
          CUDA stream of its own, with one host sync: the reads'
          codes and the jobs' descriptors go up, score and CIGAR rows come
          back (the plain version on the CPU);
  render  NM/MD and the SAM text (native), the host's gen_cigar for the
          jobs K5 did not take.

The SAM is the native finalize's byte for byte. `route` engages it where
the aligner runs on a card and the finalize runs inline (`-t 1`); the
forked pool's workers (`-t > 1`) cannot reach the card and `--device cpu`
keeps the native finalize, which is faster there than the plain solve.

Trace (utils/timing): the span `cigar_device` (upload to copy-back) inside
`finalize`, and counters `cigar_jobs` (jobs K5 solved) and
`cigar_host_jobs` (jobs the host solved), totalled in `DeviceFinalize.stats`.
"""
from __future__ import annotations

import contextlib
import ctypes
import sysconfig
import threading
from pathlib import Path

import numpy as np
import torch

from ..native import loader
from ..native.samfmt_opts import pack_opts
from ..ops.kernels import build as _kbuild
from ..ops.kernels import cigar_kernel
from ..utils import timing
from ..utils.timing import Timings

_PKG = Path(__file__).resolve().parents[1]
_NATIVE = _PKG.parent / "native"
_SOURCES = [_PKG / "csrc" / "finalize_split.cpp", _NATIVE / "ksw.cpp"]
_LIB_PATH = _kbuild.BUILD_DIR / "libfinalize_split.so"
# native/loader.py's flags, so the host's gen_cigar here is compiled as the
# native finalize's is
_GXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        f"-I{sysconfig.get_paths()['include']}", f"-I{_NATIVE}"]

_lock = threading.Lock()
_lib = None
_pylib = None   # the same library, called holding the GIL

_vp = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_PLAN_HEAD = [_vp, _I64, _vp, _vp, _I32, _vp, _vp, _vp, _vp,  # index
              _vp, _vp]                                        # options
_PLAN_READS = [_I64, _I64, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
               _vp, _I32] + [_vp] * 13                         # reads, regs


def load():
    """The split finalize's host library (built on first use)."""
    global _lib, _pylib
    with _lock:
        if _lib is None:
            # finalize_split.cpp includes samemit.cpp
            _kbuild.build(_SOURCES, _LIB_PATH, _GXX,
                          deps=[_NATIVE / "samemit.cpp"])
            pylib = ctypes.PyDLL(str(_LIB_PATH))
            pylib.bmt_flatten_regs.argtypes = [ctypes.py_object, _I64] + (
                [_vp] * 13)
            pylib.bmt_flatten_regs.restype = ctypes.c_int
            _pylib = pylib
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.bmt_plan_se.argtypes = _PLAN_HEAD + _PLAN_READS
            lib.bmt_plan_se.restype = _vp
            lib.bmt_plan_pe.argtypes = _PLAN_HEAD + [_vp, _vp] + _PLAN_READS
            lib.bmt_plan_pe.restype = _vp
            lib.bmt_plan_n_jobs.argtypes = [_vp]
            lib.bmt_plan_n_jobs.restype = _I64
            lib.bmt_plan_jobs.argtypes = [_vp] * 4
            lib.bmt_plan_jobs.restype = None
            lib.bmt_render.argtypes = [_vp, _vp, _I32, _vp, _I64, _vp]
            lib.bmt_render.restype = ctypes.c_int
            lib.bmt_plan_free.argtypes = [_vp]
            lib.bmt_plan_free.restype = None
            _lib = lib
    return _lib


def _reg_arrays(per_read_regs):
    """native/loader.py _reg_arrays: the regions as flat columns, those of
    AlnReg lists read in one native pass."""
    from .regarrays import COLS, RegArrays

    if isinstance(per_read_regs, RegArrays):
        return per_read_regs.flat()
    B = len(per_read_regs)
    reg_off = np.zeros(B + 1, np.int64)
    np.cumsum(np.fromiter(map(len, per_read_regs), np.int64, B),
              out=reg_off[1:])
    cols = [np.empty(int(reg_off[-1]), dt) for _, dt in COLS]
    if _pylib.bmt_flatten_regs(per_read_regs, int(reg_off[-1]),
                               *[c.ctypes.data for c in cols]) != 0:
        raise RuntimeError("bmt_flatten_regs failed")
    return (reg_off, *cols)


def route(aligner, pool, timings: Timings | None = None):
    """A DeviceFinalize where the aligner runs on a card and `pool`
    finalizes inline (one worker, `-t 1`) with the native core; None
    otherwise (the pool's own emitters stay)."""
    dev = getattr(aligner, "device", None)
    if (dev is None or dev.type != "cuda" or pool.n > 1
            or loader.try_load() is None):
        return None
    return DeviceFinalize(pool.opt, pool.idx, dev, aligner.fm.pac_words,
                          timings)


class DeviceFinalize:
    """HostPool.emit_se / emit_pe at `-t 1` with the CIGAR solve on
    `device` (K5 on a card, its plain version on the CPU). `pac_words`:
    the packed genome on that device (int32 words); None reads the host
    index's."""

    def __init__(self, opt, idx, device, pac_words=None,
                 timings: Timings | None = None):
        self.opt = opt
        self.idx = idx
        self.device = torch.device(device)
        self.timings = timings or Timings()
        self.lib = load()
        self.mat8 = np.ascontiguousarray(opt.mat, dtype=np.int8)
        self.pac = (pac_words if pac_words is not None else
                    torch.from_numpy(idx.pac_words.view(np.int32))
                    .to(self.device))
        self.mat = torch.from_numpy(
            np.ascontiguousarray(opt.mat, np.int32).reshape(25)).to(
                self.device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        # jobs solved: by K5 (or its plain version), by the host
        self.stats = {"cigar_jobs": 0, "cigar_host_jobs": 0}

    def _head(self):
        idx, opt = self.idx, self.opt
        ann_off, rnames_b, rname_off, annos_b, anno_off = (
            loader._idx_streams(idx))
        opt_d, opt_i = pack_opts(opt)
        keep = (ann_off, rname_off, anno_off, opt_d, opt_i)
        return keep, [
            idx.pac_words.ctypes.data, int(idx.l_pac), self.mat8.ctypes.data,
            ann_off.ctypes.data, len(idx.ann.names), rnames_b,
            rname_off.ctypes.data, annos_b, anno_off.ctypes.data,
            opt_d.ctypes.data, opt_i.ctypes.data]

    @staticmethod
    def _reads(n, id0, per_read_regs, streams, rg):
        (qstream, q_off, qlens, names_b, name_off, quals_b, qual_off, cm_b,
         com_off) = streams
        regs = _reg_arrays(per_read_regs)
        rg_b = (rg or "").encode()
        keep = (regs, streams)
        return keep, [
            n, int(id0), regs[0].ctypes.data, qstream.ctypes.data,
            q_off.ctypes.data, qlens.ctypes.data, names_b,
            name_off.ctypes.data, quals_b, qual_off.ctypes.data, cm_b,
            com_off.ctypes.data, rg_b or None, len(rg_b),
            *[a.ctypes.data for a in regs[1:]]]

    def emit_se(self, names, seqs, quals, per_read_regs, n_processed: int,
                comments=None) -> list[str]:
        opt = self.opt
        cms = comments if (comments and opt.copy_comment) else None
        streams = loader._read_streams(seqs, names, quals, cms)
        keep_h, head = self._head()
        keep_r, reads = self._reads(len(seqs), n_processed, per_read_regs,
                                    streams, getattr(opt, "rg_id", None))
        plan = self.lib.bmt_plan_se(*head, *reads)
        return self._finish(plan, streams[0], keep_h, keep_r)

    def emit_pe(self, names, seqs, quals, pair_regs, pes, n_processed: int,
                comments=None) -> list[str]:
        opt = self.opt
        cms = comments if (comments and opt.copy_comment) else None
        per_read = [r for pr in pair_regs for r in (pr[0], pr[1])]
        streams = loader._read_streams(seqs, names, quals, cms)
        pes_i = np.zeros(12, np.int32)
        pes_d = np.zeros(8, np.float64)
        for d in range(4):
            p = pes[d]
            pes_i[d * 3:d * 3 + 3] = (1 if p.failed else 0, p.low, p.high)
            pes_d[d * 2:d * 2 + 2] = (p.avg, p.std)
        keep_h, head = self._head()
        keep_r, reads = self._reads(len(pair_regs), n_processed >> 1,
                                    per_read, streams,
                                    getattr(opt, "rg_id", None))
        plan = self.lib.bmt_plan_pe(*head, pes_i.ctypes.data,
                                    pes_d.ctypes.data, *reads)
        return self._finish(plan, streams[0], keep_h, keep_r)

    def _finish(self, plan, qstream, *_keep) -> list[str]:
        """Solve the plan's jobs, render; the arrays in `_keep` back the
        plan's pointers until it is freed."""
        try:
            res = self._solve(plan, qstream)
            cap = int(qstream.size * 3 + len(res) * 196 + 4096)
            while True:
                out = np.empty(cap, np.uint8)
                out_len = np.zeros(1, np.int64)
                if self.lib.bmt_render(plan, res.ctypes.data, res.shape[1],
                                       out.ctypes.data, cap,
                                       out_len.ctypes.data) == 0:
                    break
                cap *= 2
        finally:
            self.lib.bmt_plan_free(plan)
        return out[: int(out_len[0])].tobytes().decode().splitlines()

    def _solve(self, plan, qstream) -> np.ndarray:
        lib = self.lib
        n = int(lib.bmt_plan_n_jobs(plan))
        qoff = np.empty(n, np.int64)
        rb = np.empty(n, np.int64)
        desc = np.empty((n, cigar_kernel.DESC), np.int32)
        lib.bmt_plan_jobs(plan, qoff.ctypes.data, rb.ctypes.data,
                          desc.ctypes.data)
        launch = cigar_kernel.launch_plan(desc)
        res = np.zeros((n, 2 + launch.cap), np.int32)
        res[:, 1] = -1
        if launch.smem:   # 0: K5 takes no job
            dev = self.device
            with self.timings.span("cigar_device"), (
                    torch.cuda.stream(self.stream) if self.stream is not None
                    else contextlib.nullcontext()):
                out = cigar_kernel.solve(
                    torch.from_numpy(qstream).to(dev),
                    torch.from_numpy(qoff).to(dev),
                    torch.from_numpy(rb).to(dev),
                    torch.from_numpy(desc).to(dev), self.pac,
                    int(self.idx.l_pac), self.mat, self.opt.o_del,
                    self.opt.e_del, self.opt.o_ins, self.opt.e_ins, launch)
                res = out.cpu().numpy()
            timing.count("host_syncs", 1)
        n_host = int((res[:, 1] < 0).sum())
        self.stats["cigar_jobs"] += n - n_host
        self.stats["cigar_host_jobs"] += n_host
        timing.count("cigar_jobs", n - n_host)
        timing.count("cigar_host_jobs", n_host)
        return np.ascontiguousarray(res)
