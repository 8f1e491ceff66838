"""The build of the port's own libraries (nvcc for its CUDA kernels, g++
for its host library), and the argument check the kernels' wrappers
share.

Each kernel source in `csrc/` is compiled for sm_90a into its own shared
library with a plain C interface, in the package's `_build/` directory,
on first use (and again when the source, or a header beside it, is newer
than the library). The
wrappers load the library with ctypes.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def build(sources, lib: Path, cmd: list[str] | None = None,
          deps=()) -> tuple[float, str | None]:
    """Compile `sources` (a path or a list of them) into `lib` with `cmd`
    (the compiler and its flags; None: nvcc with NVCC_FLAGS) if the
    library is missing or older than a source, a header beside one
    (`*.cuh`, `*.h`; the kernels share job_bins.cuh) or a file of `deps`
    (sources that a source includes). Returns (seconds spent compiling,
    the compiler's output, with nvcc's register and spill report);
    (0.0, None) when up to date."""
    sources = [sources] if isinstance(sources, Path) else list(sources)
    dirs = {s.parent for s in sources}
    newest = max(p.stat().st_mtime for p in [
        *sources, *deps, *(h for d in dirs for pat in ("*.cuh", "*.h")
                           for h in d.glob(pat))])
    if lib.exists() and lib.stat().st_mtime >= newest:
        return 0.0, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = cmd or [nvcc(), *NVCC_FLAGS]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    res = subprocess.run([*cmd, "-o", str(tmp), *map(str, sources)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed on "
                           f"{', '.join(s.name for s in sources)} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a
    #                       half-written library
    return time.perf_counter() - t0, res.stdout + res.stderr


def check(x, name: str, dtype, shape: tuple) -> None:
    """Raise ValueError unless tensor `x` is contiguous with this dtype and
    shape: the kernels read raw pointers."""
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
