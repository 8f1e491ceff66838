"""A configuration's world: its genome FASTA, made from the configuration's
fixed genome seed with the frozen generator, and the port's index of it,
built with the port's own `index` subcommand. Both live in
`portbench/cache/<config>/` and are made by the first run of a cell in a
checkout; later runs load them.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import simgenome

CACHE = Path(__file__).resolve().parents[1] / "cache"
_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
    _LUT[_c + 32] = _i


@dataclass
class Genome:
    names: list[str]
    starts: np.ndarray   # offset of each contig in `codes`
    lens: np.ndarray
    codes: np.ndarray    # uint8 over 0..4 (4 = N), contigs back to back


def world_dir(cfg: dict, cache: Path = CACHE) -> Path:
    return cache / cfg["name"]


def child_env(root: Path) -> dict:
    """The environment of every process that runs the program: the
    checkout on the path, its build caches inside the checkout, and no
    JAX back end pulled in by a library."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"
    return env


def ensure(cfg: dict, root: Path, cache: Path = CACHE, log=sys.stderr) -> Path:
    """Make the genome and the index of `cfg` unless they are there;
    returns the index prefix. One process at a time (a file lock)."""
    d = world_dir(cfg, cache)
    d.mkdir(parents=True, exist_ok=True)
    prefix = d / "idx"
    done = d / "READY"
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if done.exists():
            return prefix
        t0 = time.perf_counter()
        g = cfg["genome"]
        rng = np.random.default_rng(int(g["seed"]))
        spec = simgenome.RepeatSpec(**g.get("repeat_spec", {}))
        contigs, _ = simgenome.make_repeat_genome(
            rng, int(g["length_bp"]), spec=spec, n_contigs=int(g["contigs"]))
        tmp = d / "genome.fa.tmp"
        simgenome.write_fasta(tmp, contigs)
        os.replace(tmp, d / "genome.fa")
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "bwamem_tpu_torch", "index",
             *cfg.get("index_flags", []), str(d / "genome.fa"), "-p",
             str(prefix)], cwd=d, env=child_env(root), capture_output=True,
            text=True)
        if res.returncode != 0:
            raise RuntimeError(f"index build failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        done.write_text(f"genome {t1 - t0:.1f} s, index "
                        f"{time.perf_counter() - t1:.1f} s\n")
        print(f"[portbench] world {cfg['name']}: {done.read_text().strip()}",
              file=log, flush=True)
    return prefix


def load_genome(cfg: dict, cache: Path = CACHE) -> Genome:
    """The genome FASTA of `cfg` as codes (N kept as 4)."""
    raw = np.fromfile(world_dir(cfg, cache) / "genome.fa", np.uint8)
    nl = np.flatnonzero(raw == ord("\n"))
    line_start = np.concatenate([[0], nl[:-1] + 1])
    hdr = raw[line_start] == ord(">")
    names, parts = [], []
    hdr_idx = np.flatnonzero(hdr)
    for k, h in enumerate(hdr_idx):
        a, b = line_start[h], nl[h]
        names.append(raw[a + 1:b].tobytes().decode().split()[0])
        end = line_start[hdr_idx[k + 1]] if k + 1 < len(hdr_idx) else len(raw)
        body = raw[b + 1:end]
        parts.append(_LUT[body[body != ord("\n")]])
    lens = np.array([len(p) for p in parts], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return Genome(names, starts, lens, np.concatenate(parts))
