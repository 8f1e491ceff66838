"""The 16-bit probe: six int16 op classes on (R, C) int16 tensors — the CUDA
kernel's wrapper and its plain PyTorch versions.

The kernel (csrc/int16_probe.cu) replaces the Pallas TPU kernel of
tools/mosaic_probe.py (run_case): it runs each case on packed int16x2
words with the SIMD-in-word and DPX instructions that a 16-bit extension
DP on Hopper would use. It is compiled with nvcc for sm_90a into the
package's `_build/` directory on first use (ops/kernels/build.py) and
called through a plain C entry point with ctypes.

`run_case` launches the kernel for CUDA tensors and runs the case's plain
version for CPU tensors. It never falls back from one to the other. The
plain versions repeat the kernel's arithmetic on the same 32-bit words
(column 2j in the low half of word j, 2j + 1 in the high half).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build as _kbuild

C_LIMIT = 2048
# (name, what the case computes), in the kernel's case order
CASES = (
    ("compare", "int16 compare+select"),
    ("reduce", "int16 lane reduction (max)"),
    ("iota", "int16 iota"),
    ("shift", "int16 lane shift"),
    ("roll", "int16 roll by one lane"),
    ("convert", "int16<->int32 convert"),
)
NAMES = tuple(n for n, _ in CASES)

SOURCE = _kbuild.CSRC / "int16_probe.cu"
_LIB_PATH = _kbuild.BUILD_DIR / "libint16_probe.so"

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
            lib.bm_int16_probe.argtypes = [vp, vp, ci, ci, ci, vp]
            lib.bm_int16_probe.restype = ci
            lib.bm_int16_error_string.argtypes = [ci]
            lib.bm_int16_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(x) -> None:
    if x.dtype != torch.int16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"want a contiguous 2-D int16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    C = x.shape[1]
    if C % 2 or not 2 <= C <= C_LIMIT:
        raise ValueError(f"the column count {C} must be even and in "
                         f"2..{C_LIMIT}")
    if x.data_ptr() % 4:
        raise ValueError("the tensor's data must be 4-byte aligned")


def run_case(name: str, x):
    """Case `name` (one of NAMES) on int16 x (R, C): C even, at most
    C_LIMIT, contiguous, 4-byte aligned. Returns a new int16 (R, C)
    tensor."""
    global LAUNCHES
    which = NAMES.index(name)  # ValueError for an unknown case
    _check(x)
    if x.device.type == "cpu":
        return PLAIN[name](x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    R, C = x.shape
    out = torch.empty_like(x)
    if R == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.bm_int16_probe(x.data_ptr(), out.data_ptr(), R, C, which,
                            stream)
    if rc != 0:
        raise RuntimeError(f"int16 probe kernel ({name}) launch failed: "
                           + lib.bm_int16_error_string(rc).decode())
    with _lock:
        LAUNCHES += 1
    return out


# ---- plain versions, on the kernel's 32-bit words ----

def _halves(x):
    """Sign-extended (low, high) halves of the words of x, as int32
    (R, C/2): columns 2j and 2j + 1."""
    w = x.view(torch.int32)
    return (w << 16) >> 16, w >> 16


def _pack(lo, hi):
    """int16 (R, 2W) from the low 16 bits of each half."""
    w = (lo.to(torch.int64) & 0xFFFF) | ((hi.to(torch.int64) & 0xFFFF) << 16)
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.int16)


def compare_plain(x):
    lo, hi = _halves(x)
    return _pack(torch.where(lo > 3, lo, 0), torch.where(hi > 3, hi, 0))


def reduce_plain(x):
    lo, hi = _halves(x)
    m = torch.maximum(lo.amax(dim=1, keepdim=True),
                      hi.amax(dim=1, keepdim=True)).expand_as(lo)
    return _pack(m, m)


def iota_plain(x):
    lo, hi = _halves(x)
    col = 2 * torch.arange(lo.shape[1], dtype=torch.int32, device=x.device)
    return _pack(lo + col, hi + col + 1)


def _carry(hi, first):
    """Each word's carry: the previous word's high half, and `first` for
    word 0."""
    return torch.cat([first, hi[:, :-1]], dim=1)


def shift_plain(x):
    lo, hi = _halves(x)
    return _pack(_carry(hi, torch.zeros_like(hi[:, :1])), lo)


def roll_plain(x):
    lo, hi = _halves(x)
    return _pack(_carry(hi, hi[:, -1:]), lo)


def convert_plain(x):
    lo, hi = _halves(x)
    return _pack(lo, hi)


PLAIN = dict(compare=compare_plain, reduce=reduce_plain, iota=iota_plain,
             shift=shift_plain, roll=roll_plain, convert=convert_plain)
