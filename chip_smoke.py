"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the four kernels from csrc/ with nvcc, in parallel: K1 (dense
     extension), K2 (local SW), K3 (banded extension) and K4 (the 16-bit
     probe);
  2. each kernel against its plain PyTorch version on the card at the main
     paths' shapes, exact equality, median of 5 timed runs, with the bound
     (the larger of bytes over HBM bandwidth and the DP's integer
     instructions over the card's issue rate, for the live cells these
     inputs run; a job that the kernel's own 16-bit predicate admits,
     K1's, K2's or K3's fits_i16, counts half the instructions a cell):
     K1 at QMAX 192, TMAX 384, 32768 jobs + edge lanes, all four
     (opt_ext, zdrop) variants, and at QMAX 1024, TMAX 2048 (1 kb reads),
     4096 jobs, all four variants; K1 at the -x pacbio object path's
     three buckets (QMAX 64, 192 and 1024 against TMAX 1024, 768 and
     2048, 4096 jobs each) with its scoring (-B 1, -O 1, -E 1, no
     clipping bonus); K1 in one launch spanning every width class and
     its wide route with its edge lanes (make_mixed_jobs), all four
     variants; K1's wide route alone at QMAX 4096, TMAX 4352, 512 jobs
     (timed; no main path reaches it); K2 at QMAX 192, TMAX 768, 4096
     jobs + edge lanes,
     rev_skip 0/19 x minsc 0/19 (the plain version timed on the
     main-path variant, rev_skip 19 and minsc 19, only), and at the seed
     filter's 200 x 200 windows with rev_skip 0 and minsc 0, 65536 jobs
     at the default scoring and 20480 at -x pacbio's; K3 at QMAX 256,
     TMAX 384, w=100, 32768 jobs + edge lanes, zdrop 0 and 100, and at
     QMAX 1024, TMAX 1536, w=300, 4096 jobs; K4's six cases at the Pallas
     probe's (8, 128) on its arange % 100 input and at (16384, 1024) on
     full-range random int16, each also against its one-call PyTorch
     library version (timed as library_ms), and at (16384, 1024) the
     kernel's and the library call's device time from torch.profiler;
  3. build the world: a 4.6 Mbp repeat-rich simulated genome (fixed seed),
     indexed with `python -m bwamem_tpu_torch index -r 4`; 32768 SE reads
     and 16384 FR pairs (insert max(260, N(350, 50)), 1% of the pairs with
     an unseedable read 2), all 150 bp with 1% substitutions;
  4. align the SE reads (two chunks of 16384) through the CLI entry point
     with --device cuda, counting K1 launches; then the first 1024 reads
     with --device cpu, whose SAM must be byte-identical to the GPU run's
     (apart from @PG); then K1 on the inputs of the second (warm) chunk's
     launch, captured by wrapping extend_kernel.extend_batch: exact
     against the plain version, timed, with its qlen quartiles, live-cell
     share and bound (so too after phase 6, on its launch, and after
     phase 8, on -x pacbio's 1024 bucket);
  5. align the pairs from two files (two chunks of 8192 pairs) through the
     CLI entry point with --device cuda, counting K1 and K2 launches; then
     the first 1024 pairs on the GPU and with --device cpu, whose SAM must
     be byte-identical (apart from @PG); then K2 on the inputs of the
     second chunk's rescue launch, captured as K1's are (capture_calls):
     exact, timed, with its qlen quartiles, live-cell and 16-bit shares
     and bound (so too after phase 8, on the seed filter's launches of
     phase 6 and -x pacbio, and K3 on phase 7's launch);
  6. 4096 SE reads of 1 kb (utils/simgenome.simulate_reads: 1%
     substitutions, 0.2% insertions, 0.2% deletions) at the default
     flags in one chunk: the per-seed SW filter on K2, the extension on
     K1 at QMAX 1024;
  7. 16384 SE reads of 250 bp (1% substitutions) under --vanilla: the
     extension on K3;
  8. -F on the first 16384 reads of phase 4, then -x pacbio on 1024 reads
     of 1 kb with 4% substitutions, 3% insertions and 3% deletions (the
     per-seed-object path: K2 for the SW filter, K1 for the extension).
     Phases 6-8 count every kernel's launches around the device run, print
     reads/s and the spans, and hold the device SAM of the first 128,
     1024, 1024 and 64 reads byte-identical to --device cpu;
  9. the seeding variants: -u 2, -u 3 and -g on the first 16384 reads of
     phase 4, -u 4 on the first 4096, as phases 6-8 (K1 must launch; the
     device SAM of the first 1024 reads, 256 for -u 4, equals the CPU's);
 10. `fastmap` of the same 16384 reads on the card, whose text for the
     first 512 reads must equal --device cpu's;
 11. the probe, `python -m bwamem_tpu_torch.tools.int16_probe` (its main,
     in this process, with K4's launch count reset around it): six PASS
     lines, its verdict, exit 0.
Then one JSON line for the kernels, the card line, and the device JSON as
the last line.
Needs one CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager

GENOME_LEN = 4_600_000
N_READS = 32_768
CHUNK_READS = 16_384
READ_LEN = 150
N_COMPARE = 1024
KERNEL_SHAPES = dict(N=32_768, QMAX=192, TMAX=384)
VARIANTS = [(False, 0), (False, 100), (True, 0), (True, 100)]
WIDE_SHAPES = dict(N=4096, QMAX=1024, TMAX=2048)  # K1 at 1 kb reads' rows
# K1's wide route (rows past 1024 columns; on no main path): QMAX 4096
K1_WIDE_ROUTE_SHAPES = dict(N=512, QMAX=4096, TMAX=4352, tail=256)
K3_SHAPES = dict(N=32_768, QMAX=256, TMAX=384)  # --vanilla, 250 bp reads
K3_VARIANTS = [(100, 0), (100, 100)]  # (w, zdrop); --vanilla keeps -d 0
K3_WIDE_SHAPES = dict(N=4096, QMAX=1024, TMAX=1536)
# the card's rates for the bound: HBM3 bandwidth, and the integer
# instructions 132 SMs issue at 1.98 GHz (H100 SXM): four warp schedulers
# of 32 lanes an SM, one instruction each a clock, whichever pipe takes it
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 128 * 1.98e9
# a DP cell's 32-bit instructions in the shortest recurrence on Hopper's
# DPX forms: the score 1, M 1, E 2 (a subtract, then VIADDMNMX.RELU), F 2,
# H 1 (VIMNMX3.RELU), the row max 1
OPS_PER_CELL = 8
N_PAIRS = 16_384
CHUNK_PAIRS = 8192
VICTIM_EVERY = 100  # 1% of the pairs: read 2 unseedable, only rescue
#                     can place it
SW_SHAPES = dict(N=4096, QMAX=192, TMAX=768)
SW_VARIANTS = [(0, 0), (0, 19), (19, 0), (19, 19)]  # (rev_skip, minsc)
SW_MAIN = (19, 19)  # the rescue path: rev_skip = minsc = min_seed_len
# the per-seed SW filter: windows of at most MEM_SHORT_LEN = 200 bases,
# rev_skip 0, minsc 0; about phase 6's job count (16 a 1 kb read), and
# phase 8's for -x pacbio (20 a read)
FILTER_SHAPES = dict(N=65_536, QMAX=200, TMAX=200)
FILTER_PB_SHAPES = dict(N=20_480, QMAX=200, TMAX=200)
# -x pacbio: match 1, mismatch 1, gap open 1 and extension 1 both ways,
# clipping penalty 0 (the extension's end bonus), no band, no z-drop
PACBIO = dict(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1, end_bonus=0)
# the object path's buckets at 1 kb (QMAX <= 64, <= 192, the rest) with
# targets up to the whole TMAX
PB_SHAPES = [dict(N=4096, QMAX=64, TMAX=1024, tail=1024),
             dict(N=4096, QMAX=192, TMAX=768, tail=768),
             dict(N=4096, QMAX=1024, TMAX=2048, tail=2048)]
# K4: the Pallas probe's own block, then 16384 rows of 1024 int16 (32 MiB)
PROBE_SHAPES = [(8, 128), (16_384, 1024)]
PROBE_INNER = 20  # back-to-back calls per timed sample (microsecond calls)
# phase 9: reads of phase 4 per seeding variant (-u 4's plane is 58
# candidates a start, so it takes fewer) and the CPU heads
VARIANT_READS = (16_384, 4096)
VARIANT_HEADS = (1024, 256)
FASTMAP_HEAD = 512


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_info() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def make_jobs(rng, N, QMAX, TMAX, tail=160):
    """Extension jobs shaped like the main path's: the target is the query
    followed by random bases (up to `tail` more than the query), with 2%
    substitutions and 1% N bases; h0 is a seed score; edge lanes: tlen 0,
    qlen 1, large h0, full-width lanes."""
    import numpy as np

    q = rng.integers(0, 4, (N, QMAX)).astype(np.int8)
    t = np.concatenate(
        [q, rng.integers(0, 4, (N, TMAX - QMAX)).astype(np.int8)], axis=1)
    mut = rng.random((N, TMAX)) < 0.02
    t[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((N, QMAX)) < 0.01] = 4
    ql = rng.integers(1, QMAX + 1, N).astype(np.int32)
    tl = np.minimum(ql + rng.integers(0, tail, N), TMAX).astype(np.int32)
    h0 = rng.integers(19, 80, N).astype(np.int32)
    ql[0], tl[1], h0[2] = 1, 0, 100_000
    ql[3], tl[3] = QMAX, TMAX
    return q, t, ql, tl, h0


def _median_ms(fn, reps=5, inner=1):
    """Median over `reps` samples of the time of one call of fn; a sample
    times `inner` calls back to back and divides."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _device_ms(fn, inner=PROBE_INNER):
    """The device time of one call of fn: the summed time of the device
    work torch.profiler records over `inner` calls (no host time in it),
    or None when it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 / inner if us > 0 else None


def _bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM bandwidth
    and the integer instructions over the card's issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _live_cells(args, rows, opt_ext: bool, w: int):
    """(N,) live cells of each job: the rows it ran (`rows`, from the
    plain version) times its live columns (qlen + 1, or the band's 2w + 2
    when that is narrower)."""
    q, ql = args[0], args[2]
    cols = ql.long().clamp(0, q.shape[1]) + 1
    if opt_ext:
        cols = cols.clamp(max=2 * w + 2)
    return rows.long() * cols


def _ext_bound(args, rows, params, kernel: str = "K1") -> dict:
    """K1/K3 bound on these inputs: every live cell (_live_cells) costs
    OPS_PER_CELL 32-bit instructions, half as many when the job passes
    the kernel's own 16-bit predicate (extend_kernel.fits_i16 for K1,
    extend_banded.fits_i16 for K3), since two such cells share one
    int16x2 instruction. Also returns the jobs' 16-bit share
    (i16_share)."""
    import torch

    from bwamem_tpu_torch.ops.kernels import extend_banded, extend_kernel

    fits_i16 = (extend_banded if kernel == "K3" else extend_kernel).fits_i16
    q, t, ql, tl, h0, mat = args
    cells = _live_cells(args, rows, params.opt_ext, params.w)
    ok = fits_i16(tl, h0, mat, params, q.shape[1], t.shape[1])
    ops = int(torch.where(ok, cells * (OPS_PER_CELL // 2),
                          cells * OPS_PER_CELL).sum())
    nbytes = q.numel() + t.numel() + 3 * 4 * len(ql) + 100 + 6 * 4 * len(ql)
    return dict(_bound(nbytes, ops), i16_share=float(ok.float().mean()))


def _sw_bound(q, t, ql, tl, mat, want, gaps, rev_skip: int) -> dict:
    """K2 bound on these inputs: the forward sweep's cells (every row of
    the target times the query's columns) and the reverse sweep's (the
    rows from te back to tb, or to row 0 when no start was found, times
    qe + 1, for the jobs that run it), OPS_PER_CELL 32-bit instructions
    each, half as many for a job swalign_kernel.fits_i16 admits. Also
    returns the 16-bit share (i16_share) and the live cells (live)."""
    import torch

    from bwamem_tpu_torch.ops.kernels import swalign_kernel

    QMAX, TMAX = q.shape[1], t.shape[1]
    ql = ql.long().cpu().clamp(0, QMAX)
    tl = tl.long().cpu().clamp(0, TMAX)
    best, _, qe, tb, te, _ = want.long().cpu()
    fwd = tl * ql
    rows = torch.where(tb >= 0, te - tb + 1, te + 1).clamp(min=0)
    rev = torch.where(best >= max(rev_skip, 1),
                      rows * (qe + 1).clamp(min=0), 0)
    ok = swalign_kernel.fits_i16(ql, tl, mat.cpu(), *gaps, QMAX, TMAX)
    cells = fwd + rev
    ops = int(torch.where(ok, cells * (OPS_PER_CELL // 2),
                          cells * OPS_PER_CELL).sum())
    nbytes = q.numel() + t.numel() + 3 * 4 * len(ql) + 100 + 6 * 4 * len(ql)
    return dict(_bound(nbytes, ops), i16_share=float(ok.float().mean()),
                live=int(cells.sum()))


def kernel_phase(device: str = "cuda", shapes=None, timed: bool = True,
                 kernel: str = "K1", variants=None, product=None,
                 scoring=None):
    """Extension kernel vs its plain version on `device`, exact, for each
    (opt_ext, zdrop) variant (K3: each (w, zdrop)), at the default scoring
    or at `scoring` (PACBIO). Returns the product variant's record (times
    in ms, None when not timed; its bound)."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.ops.extend import ExtendParams, make_score_matrix
    from bwamem_tpu_torch.ops.kernels import extend_banded, extend_kernel

    shapes = shapes or KERNEL_SHAPES
    gaps = dict(scoring or {})
    a, b = gaps.pop("a", 1), gaps.pop("b", 4)
    if kernel == "K3":
        run_k, run_p = (extend_banded.extend_batch_banded,
                        extend_banded.extend_batch_banded_plain)
        variants = variants or [(100, 0)]
        params = [ExtendParams(w=w, zdrop=z, opt_ext=True, **gaps)
                  for w, z in variants]
        name = "K3 extend_banded"
    else:
        run_k, run_p = (extend_kernel.extend_batch,
                        extend_kernel.extend_batch_plain)
        variants = variants or VARIANTS
        params = [ExtendParams(w=100 if o else 300, zdrop=z, opt_ext=o,
                               **gaps) for o, z in variants]
        name = "K1 extend_dense" + (" pacbio" if scoring else "")
    product = product or variants[0]
    rng = np.random.default_rng(2024)
    arrays = make_jobs(rng, shapes["N"], shapes["QMAX"], shapes["TMAX"],
                       shapes.get("tail", 160))
    args = [torch.from_numpy(x).to(device)
            for x in (*arrays, make_score_matrix(a, b))]
    rec = None
    for var, p in zip(variants, params):
        want = run_p(*args, p)
        got = run_k(*args, p)
        if device == "cuda":
            torch.cuda.synchronize()
        err = max(int((got[k].long() - want[k].long()).abs().max())
                  for k in got)
        if err != 0:
            raise SystemExit(f"{name} != plain for {var}: max abs err {err}")
        ms = plain_ms = None
        if timed:
            ms = _median_ms(lambda: run_k(*args, p))
            plain_ms = _median_ms(lambda: run_p(*args, p))
        bound = _ext_bound(args, want["rows"], p, kernel)
        print(f"{name} {var} QMAX {shapes['QMAX']} TMAX {shapes['TMAX']}: "
              f"exact on {shapes['N']} jobs; kernel {ms} ms, plain "
              f"{plain_ms} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}; 16-bit jobs "
              f"{bound.pop('i16_share'):.4f})", flush=True)
        if var == product:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)
    return rec


def make_mixed_jobs(rng, N, QMAX, TMAX):
    """One K1 launch that spans every width class: make_jobs' jobs with
    qlen 0..min(QMAX, 1023) in even steps over the first 100 lanes and
    short ones after, one job of qlen QMAX among them (at QMAX > 1024 the
    wide route's only job), tlen 0, qlen 1, a negative qlen, the
    h0 = 100000 lane outside the 16-bit predicate and h0 past 2^20 (the
    int32 route's 64-bit row-max key)."""
    import numpy as np

    q, t, ql, tl, h0 = make_jobs(rng, N, QMAX, TMAX)
    ql = rng.integers(0, 200, N).astype(np.int32)
    ql[:100] = np.arange(100) * (min(QMAX, 1023) // 100)
    ql[100], ql[101], ql[102] = QMAX, 1, -3
    tl[103] = 0
    h0[104] = 100_000
    h0[105:108] = 3_000_000
    return q, t, ql, tl, h0


def mixed_kernel_phase(device: str = "cuda", N: int = 4096,
                       QMAX: int = 1100, TMAX: int = 1300) -> None:
    """K1 on make_mixed_jobs in all four (opt_ext, zdrop) variants: one
    launch each, exact against the plain version."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.ops.extend import ExtendParams, make_score_matrix
    from bwamem_tpu_torch.ops.kernels import extend_kernel as k1

    args = [torch.from_numpy(x).to(device) for x in (
        *make_mixed_jobs(np.random.default_rng(31), N, QMAX, TMAX),
        make_score_matrix(1, 4))]
    for o, z in VARIANTS:
        p = ExtendParams(w=40, zdrop=z, opt_ext=o)
        want = k1.extend_batch_plain(*args, p)
        got = k1.extend_batch(*args, p)
        if device == "cuda":
            torch.cuda.synchronize()
        bad = [k for k in got if not torch.equal(got[k], want[k])]
        if bad:
            raise SystemExit(f"K1 != plain on the mixed-width launch "
                             f"({o}, {z}): {bad}")
        print(f"K1 extend_dense mixed widths ({o}, {z}) QMAX {QMAX} TMAX "
              f"{TMAX}: exact on {N} jobs (qlen 0..{QMAX}, tlen 0, "
              f"h0 100000 and 3000000 lanes)", flush=True)


# each DP kernel's wrapper module and the function the main path calls
# through that module's attribute (so that a capture can wrap it)
CAPTURED = {"K1": ("extend_kernel", "extend_batch"),
            "K2": ("swalign_kernel", "sw_align_batch"),
            "K3": ("extend_banded", "extend_batch_banded")}


def _kmod(kernel: str):
    import importlib

    return importlib.import_module("bwamem_tpu_torch.ops.kernels."
                                   + CAPTURED[kernel][0])


@contextmanager
def capture_calls(kernel: str):
    """Record the inputs of every call of `kernel` (K1, K2 or K3) made
    inside the block: wraps the wrapper function that ops/extend.py,
    ops/swalign.py and pipeline/seedflt.py call through the module
    attribute (CAPTURED), and clones each call's tensors. Yields the list
    of calls, each the call's positional arguments (K1, K3: query,
    target, qlen, tlen, h0, mat, params; K2: query, target, qlen, tlen,
    minsc, mat, o_del, e_del, o_ins, e_ins, a, rev_skip)."""
    import torch

    mod, attr = _kmod(kernel), CAPTURED[kernel][1]
    orig = getattr(mod, attr)
    calls = []

    def wrapped(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return orig(*args)

    setattr(mod, attr, wrapped)
    try:
        yield calls
    finally:
        setattr(mod, attr, orig)


def _check_captured(kernel, label, run, run_plain, N, timed):
    """A captured launch's kernel call against its plain version: exact
    (max abs err over every output), and both timed when `timed`.
    Returns (plain output, err, ms, plain_ms)."""
    import torch

    want = run_plain()
    got = run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if isinstance(got, dict):
        err = max(int((got[k].long() - want[k].long()).abs().max())
                  for k in got) if N else 0
    else:
        err = int((got.long() - want.long()).abs().max()) if N else 0
    if err != 0:
        raise SystemExit(f"{kernel} != plain on the captured {label} "
                         f"launch: max abs err {err}")
    ms = plain_ms = None
    if timed:
        ms = _median_ms(run)
        plain_ms = _median_ms(run_plain)
    return want, err, ms, plain_ms


def captured_ext(kernel: str, label: str, call, timed: bool = True) -> dict:
    """K1 or K3 on the inputs of one captured main-path launch: exact
    against its plain version, timed (median of 5; `timed` False skips
    it), with the job count, the qlen quartiles, the live-cell share (live
    cells over the rows each job ran times QMAX + 1), the 16-bit share and
    the bound. Returns the record."""
    import numpy as np

    mod = _kmod(kernel)
    run_k = getattr(mod, CAPTURED[kernel][1])
    run_p = getattr(mod, CAPTURED[kernel][1] + "_plain")
    *args, p = call
    N, QMAX = args[0].shape
    TMAX = args[1].shape[1]
    want, err, ms, plain_ms = _check_captured(
        kernel, label, lambda: run_k(*args, p), lambda: run_p(*args, p), N,
        timed)
    bound = _ext_bound(args, want["rows"], p, kernel)
    live = int(_live_cells(args, want["rows"], p.opt_ext, p.w).sum())
    full = int((want["rows"].long() * (QMAX + 1)).sum())
    qs = np.percentile(args[2].cpu().numpy(), [25, 50, 75]) if N else [0] * 3
    print(f"{kernel} on the captured {label} launch: {N} jobs, QMAX {QMAX}, "
          f"TMAX {TMAX}, qlen quartiles {qs[0]:g} / {qs[1]:g} / {qs[2]:g}, "
          f"live cells {live} = {live / max(full, 1):.4f} of rows x "
          f"(QMAX+1); exact; kernel {ms} ms, plain {plain_ms} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; 16-bit jobs "
          f"{bound.pop('i16_share'):.4f})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


def captured_k2(label: str, call, timed: bool = True) -> dict:
    """K2 on the inputs of one captured main-path launch: exact against
    its plain version, timed (median of 5; `timed` False skips it), with
    the job count, the qlen quartiles, the live-cell share (the cells the
    forward and reverse sweeps need, _sw_bound, over the rows they run
    times QMAX), the 16-bit share and the bound. Returns the record."""
    import numpy as np

    from bwamem_tpu_torch.ops.kernels import swalign_kernel as k2

    args = call[:6]
    gaps = call[6:11]
    rev_skip = call[11] if len(call) > 11 else 0
    N, QMAX = args[0].shape
    TMAX = args[1].shape[1]
    want, err, ms, plain_ms = _check_captured(
        "K2", label, lambda: k2.sw_align_batch(*args, *gaps, rev_skip),
        lambda: k2.sw_align_batch_plain(*args, *gaps, rev_skip), N, timed)
    bound = _sw_bound(args[0], args[1], args[2], args[3], args[5], want,
                      gaps[:4], rev_skip)
    live = bound.pop("live")
    best, _, qe, tb, te, _ = want.long().cpu()
    rev_rows = (te + 1).clamp(min=0).where(best >= max(rev_skip, 1), 0)
    full = int(((args[3].long().cpu().clamp(0, TMAX) + rev_rows)
                * QMAX).sum())
    qs = np.percentile(args[2].cpu().numpy(), [25, 50, 75]) if N else [0] * 3
    print(f"K2 on the captured {label} launch: {N} jobs, QMAX {QMAX}, TMAX "
          f"{TMAX}, rev_skip {rev_skip}, qlen quartiles {qs[0]:g} / "
          f"{qs[1]:g} / {qs[2]:g}, live cells {live} = "
          f"{live / max(full, 1):.4f} of rows x QMAX; exact; kernel {ms} ms, "
          f"plain {plain_ms} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; 16-bit jobs "
          f"{bound.pop('i16_share'):.4f})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


def make_sw_jobs(rng, N, QMAX, TMAX):
    """Rescue-shaped local-SW jobs: a mate of 150 bases (or fewer) against
    a window of about 626 bases; half the mates are a mutated slice of
    their window (a hit), the rest random (a miss); 1% N bases. Edge
    lanes: qlen 0, tlen 0, qlen 1, an all-N mate, a full-width job."""
    import numpy as np

    t = rng.integers(0, 4, (N, TMAX)).astype(np.int8)
    t[rng.random((N, TMAX)) < 0.01] = 4
    ql = np.minimum(rng.integers(100, 151, N), QMAX).astype(np.int32)
    tl = rng.integers(ql, min(TMAX, 640) + 1).astype(np.int32)
    q = rng.integers(0, 4, (N, QMAX)).astype(np.int8)
    for i in np.flatnonzero(rng.random(N) < 0.5):
        off = int(rng.integers(0, tl[i] - ql[i] + 1))
        q[i, :ql[i]] = t[i, off:off + ql[i]]
    mut = rng.random((N, QMAX)) < 0.03
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((N, QMAX)) < 0.01] = 4
    ql[0], tl[1], ql[2] = 0, 0, 1
    q[3] = 4
    ql[4], tl[4] = QMAX, TMAX
    return q, t, ql, tl


def make_filter_jobs(rng, N, QMAX, TMAX):
    """Seed-filter-shaped local-SW jobs: the windows 50 bases either side
    of a seed, a query window of 100 to QMAX - 1 bases against a
    reference window within 3 bases of its length; four in five are the
    reference with 5% substitutions (a seed that stays), the rest random
    (one that goes); 1% N bases. Edge lanes as in make_sw_jobs."""
    import numpy as np

    t = rng.integers(0, 4, (N, TMAX)).astype(np.int8)
    ql = rng.integers(100, QMAX, N).astype(np.int32)
    tl = np.clip(ql + rng.integers(-3, 4, N), 1, TMAX - 1).astype(np.int32)
    q = rng.integers(0, 4, (N, QMAX)).astype(np.int8)
    hit = rng.random(N) < 0.8
    q[hit] = t[hit, :QMAX]
    mut = rng.random((N, QMAX)) < 0.05
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((N, QMAX)) < 0.01] = 4
    ql[0], tl[1], ql[2] = 0, 0, 1
    q[3] = 4
    ql[4], tl[4] = QMAX, TMAX
    return q, t, ql, tl


def sw_kernel_phase(device: str = "cuda", shapes=None, timed: bool = True,
                    variants=None, product=SW_MAIN, jobs=None,
                    scoring=None, label: str = "rescue"):
    """K2 vs its plain version on `device` for each (rev_skip, minsc)
    variant (by default the rescue path's rev_skip 0/19 x minsc 0/19), at
    the default scoring or at `scoring` (PACBIO). Returns the `product`
    variant's record (times in ms; None when not timed). Only that
    variant times the plain version."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.ops.extend import make_score_matrix
    from bwamem_tpu_torch.ops.kernels import swalign_kernel

    shapes = shapes or SW_SHAPES
    sc = {**dict(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1),
          **(scoring or {})}
    rng = np.random.default_rng(2025)
    q, t, ql, tl = (jobs or make_sw_jobs)(rng, shapes["N"], shapes["QMAX"],
                                          shapes["TMAX"])
    mat = make_score_matrix(sc["a"], sc["b"])
    main_rec = None
    for rev_skip, minsc in variants or SW_VARIANTS:
        ms_arr = np.full(len(ql), minsc, np.int32)
        args = [torch.from_numpy(a).to(device)
                for a in (q, t, ql, tl, ms_arr, mat)]
        gaps = (sc["o_del"], sc["e_del"], sc["o_ins"], sc["e_ins"], sc["a"],
                rev_skip)

        def run():
            return swalign_kernel.sw_align_batch(*args, *gaps)

        def run_plain():
            return swalign_kernel.sw_align_batch_plain(*args, *gaps)

        want = run_plain()
        got = run()
        if device == "cuda":
            torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise SystemExit(f"K2 != plain for rev_skip={rev_skip} "
                             f"minsc={minsc}: max abs err {err}")
        ms = plain_ms = None
        if timed:
            ms = _median_ms(run)
            if (rev_skip, minsc) == product:
                plain_ms = _median_ms(run_plain)
        hits = int((want[0] >= 19).sum())
        bound = _sw_bound(args[0], args[1], args[2], args[3], args[5], want,
                          gaps[:4], rev_skip)
        bound.pop("live")
        print(f"K2 swalign_local {label} QMAX {shapes['QMAX']} TMAX "
              f"{shapes['TMAX']} rev_skip={rev_skip} minsc={minsc}: exact "
              f"on {shapes['N']} jobs ({hits} with score >= 19); kernel "
              f"{ms} ms, plain {plain_ms} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; 16-bit "
              f"jobs {bound.pop('i16_share'):.4f})", flush=True)
        if (rev_skip, minsc) == product:
            main_rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            **bound)
    return main_rec


def probe_input(shape, seed: int = 2026):
    """K4's input: the Pallas probe's arange % 100 at its own (8, 128),
    else full-range random int16 with both extremes."""
    import numpy as np

    if tuple(shape) == (8, 128):
        return (np.arange(1024, dtype=np.int16) % 100).reshape(shape)
    x = np.random.default_rng(seed).integers(-32768, 32768, shape,
                                             dtype=np.int16)
    x[0, 0], x[-1, -1] = -32768, 32767
    return x


def probe_library_calls(x) -> dict:
    """For each K4 case, the PyTorch call that computes the same int16
    output (timed as library_ms; the port never calls these)."""
    import torch
    import torch.nn.functional as F

    col = torch.arange(x.shape[1], dtype=torch.int16, device=x.device)
    return dict(
        compare=lambda: torch.where(x > 3, x, 0),
        reduce=lambda: x.amax(dim=1, keepdim=True).expand_as(x).contiguous(),
        iota=lambda: x + col,
        shift=lambda: F.pad(x[:, :-1], (1, 0)),
        roll=lambda: torch.roll(x, 1, 1),
        convert=lambda: x.int().short())


def probe_kernel_phase(device: str = "cuda", shapes=None,
                       timed: bool = True) -> dict:
    """K4 vs its plain version and its library call on `device`: every
    case at every shape, exact. Bound per case: 2·R·C bytes read and as
    many written (one packed operation a 32-bit word is far below the
    bytes' time). The CUDA-event times of these microsecond calls
    include the host's launch work wherever it outlasts the device's, so
    the last shape also prints the kernel's and the library call's device
    time from torch.profiler. Returns the last shape's record, each time
    and the bound summed over the six cases."""
    import torch

    from bwamem_tpu_torch.ops.kernels import int16_probe as k4

    rec = None
    shapes = shapes or PROBE_SHAPES
    for shape in shapes:
        R, C = shape
        x = torch.from_numpy(probe_input(shape)).to(device)
        lib = probe_library_calls(x)
        t0 = 0.0 if timed else None
        rec = dict(max_abs_err=0, ms=t0, plain_ms=t0, library_ms=t0,
                   bound_ms=0.0)
        for name in k4.NAMES:
            want = k4.PLAIN[name](x)
            got = k4.run_case(name, x)
            ref = lib[name]()
            if device == "cuda":
                torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            if err != 0 or not torch.equal(ref, want):
                raise SystemExit(f"K4 {name} {shape}: kernel or library "
                                 f"call != plain (max abs err {err})")
            bound = _bound(4 * R * C, R * C // 2)
            ms = plain_ms = lib_ms = None
            if timed:
                ms = _median_ms(lambda: k4.run_case(name, x),
                                inner=PROBE_INNER)
                plain_ms = _median_ms(lambda: k4.PLAIN[name](x),
                                      inner=PROBE_INNER)
                lib_ms = _median_ms(lib[name], inner=PROBE_INNER)
                for key, t in (("ms", ms), ("plain_ms", plain_ms),
                               ("library_ms", lib_ms)):
                    rec[key] += t
            rec["bound_ms"] += bound["bound_ms"]
            rec["bound_by"] = bound["bound_by"]
            dev_ms = ""
            if timed and shape == shapes[-1]:
                dev_ms = (f"; device time (torch.profiler) kernel "
                          f"{_device_ms(lambda: k4.run_case(name, x))} ms, "
                          f"library {_device_ms(lib[name])} ms")
            print(f"K4 int16_probe {name} {R}x{C}: exact; kernel {ms} ms, "
                  f"plain {plain_ms} ms, library {lib_ms} ms, bound "
                  f"{bound['bound_ms']:.6f} ms ({bound['bound_by']})"
                  f"{dev_ms}", flush=True)
    return rec


def make_world(d: str, genome_len: int = GENOME_LEN, n_reads: int = N_READS,
               seed: int = 12345, n_pairs: int = N_PAIRS):
    """Repeat-rich genome -> ref.fa; SE reads -> reads.fq (names carry the
    simulated origin) and head.fq (the first N_COMPARE reads); pairs ->
    r1.fq/r2.fq and head1.fq/head2.fq (make_pairs). Returns the genome's
    contigs."""
    import numpy as np

    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  write_fasta)

    rng = np.random.default_rng(seed)
    contigs, _ = make_repeat_genome(rng, genome_len, n_contigs=1)
    write_fasta(os.path.join(d, "ref.fa"), contigs)
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    r2 = np.random.default_rng(seed + 1)
    pos = r2.integers(0, len(g) - READ_LEN, n_reads)
    recs = []
    for i, p in enumerate(pos):
        r = g[p:p + READ_LEN].copy()
        err = (r2.random(READ_LEN) < 0.01) & (r < 4)
        r[err] = (r[err] + 1) % 4
        if i % 2:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        seq = "".join("ACGTN"[c] for c in r)
        recs.append(f"@r{i}_{p}_{i % 2}\n{seq}\n+\n{'I' * READ_LEN}\n")
    with open(os.path.join(d, "reads.fq"), "w") as f:
        f.writelines(recs)
    with open(os.path.join(d, "head.fq"), "w") as f:
        f.writelines(recs[:N_COMPARE])
    make_pairs(d, g, n_pairs, seed + 2)
    return contigs


def make_pairs(d: str, g, n_pairs: int, seed: int,
               victim_every: int = VICTIM_EVERY):
    """The JAX package's PE bench traffic (bench.py main_pe): FR pairs of
    150 bp, insert max(260, N(350, 50)), 1% substitutions. Every
    victim_every-th pair's read 2 gets one substitution every 12 bp, so it
    has no 19-bp seed (a victim). Names carry both origins and the victim
    flag: p{i}_{pos1}_{pos2}_{victim}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L = READ_LEN
    recs = ([], [])
    for i in range(n_pairs):
        isize = max(260, int(rng.normal(350, 50)))
        p = int(rng.integers(0, len(g) - isize - 1))
        frag = g[p:p + isize]
        a = frag[:L].copy()
        b = np.where(frag[-L:] < 4, 3 - frag[-L:], 4)[::-1].copy()
        for r in (a, b):
            err = (rng.random(L) < 0.01) & (r < 4)
            r[err] = (r[err] + 1) % 4
        victim = int(i % victim_every == victim_every - 1)
        if victim:
            b[::12] = (b[::12] + 1) % 4
        name = f"p{i}_{p}_{p + isize - L}_{victim}"
        for out, r in zip(recs, (a, b)):
            seq = "".join("ACGTN"[c] for c in r)
            out.append(f"@{name}\n{seq}\n+\n{'I' * L}\n")
    for k, out in enumerate(recs, 1):
        with open(os.path.join(d, f"r{k}.fq"), "w") as f:
            f.writelines(out)
        with open(os.path.join(d, f"head{k}.fq"), "w") as f:
            f.writelines(out[:N_COMPARE])


def _records(path):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("@PG")]


def align_phase(d: str, device: str = "cuda",
                chunk_reads: int = CHUNK_READS):
    """The main path: `align` through the CLI entry point on `device`,
    with the kernel's launch count reset just before and read just after
    and its calls captured (capture_calls). Then the first N_COMPARE reads on
    the CPU. Returns the launch count, reads/s and the captured calls."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import extend_kernel

    idx = os.path.join(d, "idx")
    out = os.path.join(d, f"{device}.sam")
    tsv = os.path.join(d, f"{device}.tsv")
    argv = ["align", "--device", device, "-t", "1", "-K",
            str(chunk_reads * READ_LEN), "-f", tsv, idx,
            os.path.join(d, "reads.fq"), "-o", out]
    extend_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    with capture_calls("K1") as calls:
        if main(argv) != 0:
            raise SystemExit("align failed")
    wall = time.perf_counter() - t0
    launches = extend_kernel.LAUNCHES
    recs = _records(out)
    body = [ln.split("\t") for ln in recs if not ln.startswith("@")]
    prim = [f for f in body if not int(f[1]) & 0x900]
    n = len(prim)
    mapped = sum(not int(f[1]) & 4 for f in prim)
    placed = sum(
        not int(f[1]) & 4
        and abs(int(f[3]) - 1 - int(f[0].split("_")[1])) <= 5
        and bool(int(f[1]) & 16) == (f[0].split("_")[2] == "1")
        for f in prim)
    row = _timing_row(tsv)
    n_chunks = -(-n // chunk_reads)
    print(f"align --device {device}: {n} reads in {wall:.2f} s wall "
          f"(index load + setup included) = {n / wall:.1f} reads/s; "
          f"mapped {mapped / n:.4f}; at simulated origin {placed / n:.4f}; "
          f"spans collect {row.get('collect')} s, ext_device "
          f"{row.get('ext_device')} s over {n_chunks} chunks; "
          f"K1 launches {launches}", flush=True)
    if launches < 1 and device == "cuda":
        raise SystemExit("the main path launched no extension kernel")
    if mapped < 0.9 * n:
        raise SystemExit(f"only {mapped}/{n} reads mapped")

    cpu_out = os.path.join(d, "cpu_head.sam")
    t0 = time.perf_counter()
    if main(["align", "--device", "cpu", "-t", "1", idx,
             os.path.join(d, "head.fq"), "-o", cpu_out]) != 0:
        raise SystemExit("CPU align failed")
    names = {ln.split("\t")[0] for ln in _records(cpu_out)
             if not ln.startswith("@")}
    want = _records(cpu_out)
    got = [ln for ln in recs
           if ln.startswith("@") or ln.split("\t")[0] in names]
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise SystemExit(f"GPU and CPU SAM differ at record {bad}:\n"
                         f"{got[bad]}\n{want[bad]}")
    print(f"first {len(names)} reads: GPU SAM == CPU SAM "
          f"({len(want)} lines, CPU run {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return launches, n / wall, calls


def _lead_clip(cigar: str) -> int:
    m = re.match(r"(\d+)[SH]", cigar)
    return int(m.group(1)) if m else 0


def _timing_row(path):
    """The last row of the CLI's -f timing TSV as a dict."""
    with open(path) as f:
        lines = f.read().splitlines()
    return dict(zip(lines[-2].split("\t"), lines[-1].split("\t")))


def pe_align_phase(d: str, device: str = "cuda",
                   chunk_pairs: int = CHUNK_PAIRS):
    """The PE main path: `align` of r1.fq + r2.fq through the CLI entry
    point on `device`, with K1's and K2's launch counts reset just before
    and read just after and K2's calls captured (capture_calls). Then the
    head pairs on `device` and on the CPU, with the same flags and -K,
    must give the same SAM. Returns (K1 launches, K2 launches, pairs/s, the
    captured K2 calls)."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import extend_kernel, swalign_kernel

    idx = os.path.join(d, "idx")

    def align(dev, r1, r2, tag):
        out = os.path.join(d, f"pe_{tag}.sam")
        tsv = os.path.join(d, f"pe_{tag}.tsv")
        if os.path.exists(tsv):  # the CLI appends
            os.remove(tsv)
        argv = ["align", "--device", dev, "-t", "1", "-K",
                str(chunk_pairs * 2 * READ_LEN), "-f", tsv, idx,
                os.path.join(d, r1), os.path.join(d, r2), "-o", out]
        if main(argv) != 0:
            raise SystemExit(f"PE align {tag} failed")
        return out, tsv

    extend_kernel.LAUNCHES = 0
    swalign_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    with capture_calls("K2") as sw_calls:
        out, tsv = align(device, "r1.fq", "r2.fq", "main")
    wall = time.perf_counter() - t0
    k1, k2 = extend_kernel.LAUNCHES, swalign_kernel.LAUNCHES
    body = [ln.split("\t") for ln in _records(out) if not ln.startswith("@")]
    prim = [f for f in body if not int(f[1]) & 0x900]
    n = len(prim)
    n_pairs = n // 2
    mapped = sum(not int(f[1]) & 4 for f in prim)
    proper = sum(bool(int(f[1]) & 2) for f in prim)
    victims = [f for f in prim
               if int(f[1]) & 0x80 and f[0].split("_")[3] == "1"]
    # the unclipped start: a rescued mate often clips its first bases
    placed = sum(not int(f[1]) & 4
                 and abs(int(f[3]) - 1 - _lead_clip(f[5])
                         - int(f[0].split("_")[2])) <= 5
                 for f in victims)
    row = _timing_row(tsv)
    n_chunks = -(-n_pairs // chunk_pairs)
    print(f"PE align --device {device}: {n_pairs} pairs in {wall:.2f} s "
          f"wall (index load + setup included) = {n_pairs / wall:.1f} "
          f"pairs/s; mapped {mapped / n:.4f}; proper pair {proper / n:.4f};"
          f" victims placed {placed}/{len(victims)}; rescue SW jobs "
          f"{row.get('rescue_jobs')} ({row.get('rescue_applied')} applied) "
          f"in {n_chunks} chunks; spans collect {row.get('collect')} s, "
          f"pe_rescue {row.get('pe_rescue')} s, pe_rescue_sw "
          f"{row.get('pe_rescue_sw')} s, ext_device {row.get('ext_device')} "
          f"s, finalize {row.get('finalize')} s; "
          f"K1 launches {k1}, K2 launches {k2}", flush=True)
    if device == "cuda" and (k1 < 1 or k2 < 1):
        raise SystemExit("the PE main path launched no K1 or no K2")
    if mapped < 0.9 * n:
        raise SystemExit(f"only {mapped}/{n} PE records mapped")
    if not victims or placed < 0.9 * len(victims):
        raise SystemExit(f"only {placed}/{len(victims)} victims placed")

    t0 = time.perf_counter()
    got = _records(align(device, "head1.fq", "head2.fq", "head")[0])
    t1 = time.perf_counter()
    want = _records(align("cpu", "head1.fq", "head2.fq", "head_cpu")[0])
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise SystemExit(f"GPU and CPU PE SAM differ at line {bad}:\n"
                         f"{got[bad:bad + 1]}\n{want[bad:bad + 1]}")
    print(f"first {N_COMPARE} pairs: {device} SAM == CPU SAM "
          f"({len(want)} lines; {device} run {t1 - t0:.1f} s, CPU run "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)
    return k1, k2, n_pairs / wall, sw_calls


def _head(src: str, dst: str, n: int) -> None:
    """The first n FASTQ records of src into dst."""
    with open(src) as f:
        lines = [ln for _, ln in zip(range(4 * n), f)]
    with open(dst, "w") as f:
        f.writelines(lines)


def flag_phase(d: str, tag: str, reads: str, n_head: int, flags: list,
               need: tuple, device: str = "cuda",
               capture: bool = False) -> dict:
    """A further main path: SE `align` of `reads` with `flags` through the
    CLI entry point on `device`, every kernel's launch count reset just
    before and read just after; kernels in `need` must have launched. Then
    the first n_head reads with --device cpu, whose SAM must be
    byte-identical to the device run's records of those reads. Returns
    the launch counts (K1, K1's wide route, K2, K3), reads/s
    and, with `capture`, the device run's K1, K2 and K3 calls
    (capture_calls) as k1_calls, k2_calls and k3_calls."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import (extend_banded, extend_kernel,
                                              swalign_kernel)

    idx = os.path.join(d, "idx")
    mods = {"K1": extend_kernel, "K2": swalign_kernel, "K3": extend_banded}

    def align(dev, path, label):
        out = os.path.join(d, f"{tag}_{label}.sam")
        tsv = os.path.join(d, f"{tag}_{label}.tsv")
        if os.path.exists(tsv):  # the CLI appends
            os.remove(tsv)
        if main(["align", "--device", dev, "-t", "1", "-f", tsv, *flags,
                 idx, path, "-o", out]) != 0:
            raise SystemExit(f"{tag}: align on {dev} failed")
        return _records(out), _timing_row(tsv)

    for m in mods.values():
        m.LAUNCHES = 0
    extend_kernel.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    with ExitStack() as stack:
        calls = {f"{k.lower()}_calls": stack.enter_context(
            capture_calls(k)) for k in CAPTURED} if capture else {}
        recs, row = align(device, os.path.join(d, reads), "main")
    wall = time.perf_counter() - t0
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    counts["K1_wide"] = extend_kernel.WIDE_LAUNCHES
    body = [ln.split("\t") for ln in recs if not ln.startswith("@")]
    prim = [f for f in body if not int(f[1]) & 0x900]
    n = len(prim)
    mapped = sum(not int(f[1]) & 4 for f in prim)
    spans = ", ".join(f"{k} {row[k]} s" for k in (
        "collect", "seed_device", "seed_filter", "chain_native",
        "ext_device", "finalize") if row.get(k))
    print(f"{tag} ({' '.join(flags) or 'default flags'}) --device {device}: "
          f"{n} reads in {wall:.2f} s wall (index load + setup included) = "
          f"{n / wall:.1f} reads/s; mapped {mapped / n:.4f}; spans {spans}; "
          f"launches K1 {counts['K1']} (wide route {counts['K1_wide']}), "
          f"K2 {counts['K2']}, K3 {counts['K3']}", flush=True)
    if device == "cuda":
        missing = [k for k in need if counts[k] < 1]
        if missing:
            raise SystemExit(f"{tag}: the path launched no {missing}")
    if mapped < 0.9 * n:
        raise SystemExit(f"{tag}: only {mapped}/{n} reads mapped")

    head = os.path.join(d, f"{tag}_head.fq")
    _head(os.path.join(d, reads), head, n_head)
    t0 = time.perf_counter()
    want, _ = align("cpu", head, "cpu")
    names = {ln.split("\t")[0] for ln in want if not ln.startswith("@")}
    got = [ln for ln in recs
           if ln.startswith("@") or ln.split("\t")[0] in names]
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise SystemExit(f"{tag}: {device} and CPU SAM differ at line "
                         f"{bad}:\n{got[bad:bad + 1]}\n{want[bad:bad + 1]}")
    print(f"{tag}: first {len(names)} reads: {device} SAM == CPU SAM "
          f"({len(want)} lines, CPU run {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return dict(counts, reads_per_s=n / wall, **calls)


def long_read_phases(d: str, contigs, device: str = "cuda",
                     sizes=(4096, 16384, 16384, 1024),
                     heads=(128, 1024, 1024, 64)) -> dict:
    """Phases 6-8 on the world of phase 3 (its contigs): 1 kb reads at
    the default flags, 250 bp reads under --vanilla, -F on the first 150
    bp reads of reads.fq, and -x pacbio on noisy 1 kb reads. Returns each
    phase's launch counts and reads/s."""
    import numpy as np

    from bwamem_tpu_torch.utils.simgenome import simulate_reads, write_fastq

    n_long, n_250, n_shd, n_pb = sizes
    rng = np.random.default_rng(7)
    for name, n, length, sub, ins, dele in (
            ("long", n_long, 1000, 0.01, 0.002, 0.002),
            ("r250", n_250, 250, 0.01, 0.0, 0.0),
            ("pb", n_pb, 1000, 0.04, 0.03, 0.03)):
        write_fastq(os.path.join(d, f"{name}.fq"), simulate_reads(
            rng, contigs, n, read_len=length, sub=sub, ins=ins, dele=dele,
            prefix=name))
    _head(os.path.join(d, "reads.fq"), os.path.join(d, "shd.fq"), n_shd)
    out = {}
    phase("6 long reads (1 kb, default flags)")
    out["long"] = flag_phase(d, "long", "long.fq", heads[0], [],
                             ("K1", "K2"), device, capture=True)
    phase("7 --vanilla (250 bp)")
    out["vanilla"] = flag_phase(d, "vanilla", "r250.fq", heads[1],
                                ["--vanilla"], ("K3",), device, capture=True)
    phase("8 filters: -F (150 bp), -x pacbio (1 kb)")
    out["shd"] = flag_phase(d, "shd", "shd.fq", heads[2], ["-F"], ("K1",),
                            device)
    out["pacbio"] = flag_phase(d, "pacbio", "pb.fq", heads[3],
                               ["-x", "pacbio"], ("K1", "K2"), device,
                               capture=True)
    return out


def variant_phases(d: str, device: str = "cuda", sizes=VARIANT_READS,
                   heads=VARIANT_HEADS) -> dict:
    """Phase 9 on the world of phase 3: -u 2, -u 3 and -g on the first
    sizes[0] reads of reads.fq, -u 4 on the first sizes[1], each through
    flag_phase (K1 must launch; device SAM == CPU SAM on the head).
    Returns each variant's launch counts and reads/s."""
    n, n4 = sizes
    _head(os.path.join(d, "reads.fq"), os.path.join(d, "var.fq"), n)
    _head(os.path.join(d, "reads.fq"), os.path.join(d, "var4.fq"), n4)
    return {tag: flag_phase(d, tag, reads, head, flags, ("K1",), device)
            for tag, reads, head, flags in (
                ("u2", "var.fq", heads[0], ["-u", "2"]),
                ("u3", "var.fq", heads[0], ["-u", "3"]),
                ("g", "var.fq", heads[0], ["-g"]),
                ("u4", "var4.fq", heads[1], ["-u", "4"]))}


def fastmap_phase(d: str, device: str = "cuda",
                  n_head: int = FASTMAP_HEAD) -> float:
    """Phase 10: `fastmap` of var.fq (phase 9's reads) through the CLI
    entry point on `device`, then of its first n_head reads with
    --device cpu, whose text must equal the device run's for those reads.
    Returns reads/s."""
    from contextlib import redirect_stdout

    from bwamem_tpu_torch.cli import main

    def fastmap(dev, reads, tag):
        out = os.path.join(d, f"fastmap_{tag}.txt")
        with open(out, "w") as f, redirect_stdout(f):
            rc = main(["fastmap", "--device", dev, os.path.join(d, "idx"),
                       reads])
        if rc != 0:
            raise SystemExit(f"fastmap on {dev} failed")
        with open(out) as f:
            return f.read().split("//\n")[:-1]  # one block per read

    t0 = time.perf_counter()
    got = fastmap(device, os.path.join(d, "var.fq"), "main")
    wall = time.perf_counter() - t0
    n_em = sum(b.count("\nEM\t") for b in got)
    print(f"fastmap --device {device}: {len(got)} reads in {wall:.2f} s "
          f"wall (index load + setup included) = {len(got) / wall:.1f} "
          f"reads/s; {n_em} EM lines", flush=True)
    if n_em < len(got):
        raise SystemExit(f"fastmap: only {n_em} SMEMs for {len(got)} reads")
    head = os.path.join(d, "fastmap_head.fq")
    _head(os.path.join(d, "var.fq"), head, n_head)
    t0 = time.perf_counter()
    want = fastmap("cpu", head, "cpu")
    if got[:n_head] != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise SystemExit(f"fastmap: {device} and CPU differ at read {bad}:"
                         f"\n{got[bad:bad + 1]}\n{want[bad:bad + 1]}")
    print(f"fastmap: first {len(want)} reads: {device} text == CPU text "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    return len(got) / wall


def probe_phase(device: str = "cuda") -> int:
    """Phase 11: the probe's entry point (`python -m
    bwamem_tpu_torch.tools.int16_probe`, its main in this process) with
    K4's launch count reset just before and read just after. It must
    print six PASS lines and its verdict and return 0. Returns the
    launches."""
    import io
    from contextlib import redirect_stdout

    from bwamem_tpu_torch.ops.kernels import int16_probe
    from bwamem_tpu_torch.tools.int16_probe import main as probe_main

    buf = io.StringIO()
    int16_probe.LAUNCHES = 0
    with redirect_stdout(buf):
        rc = probe_main(["--device", device])
    launches = int16_probe.LAUNCHES
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print("  " + ln, flush=True)
    n_pass = sum(ln.startswith("PASS ") for ln in lines)
    print(f"probe --device {device}: exit {rc}, {n_pass} PASS, K4 launches "
          f"{launches}", flush=True)
    if rc != 0 or n_pass != 6 or not lines[-1].startswith("VERDICT: "):
        raise SystemExit("the probe did not pass")
    if device == "cuda" and launches != len(int16_probe.NAMES):
        raise SystemExit(f"the probe launched K4 {launches} times, not 6")
    return launches


def build_kernels():
    """Build K1, K2, K3 and K4 at once (one nvcc each) and print each
    build's register and spill report."""
    from concurrent.futures import ThreadPoolExecutor

    from bwamem_tpu_torch.ops.kernels import (extend_banded, extend_kernel,
                                              int16_probe, swalign_kernel)

    mods = {"K1": extend_kernel, "K2": swalign_kernel, "K3": extend_banded,
            "K4": int16_probe}
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {k: ex.submit(m.build) for k, m in mods.items()}
        secs = {k: f.result() for k, f in futs.items()}
    for k, m in mods.items():
        print(f"{k} built in {secs[k]:.1f} s", flush=True)
        for ln in m.BUILD_LOG.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  " + ln.strip(), flush=True)


def _widest(calls):
    """The captured K1 call with the widest rows (largest QMAX)."""
    return max(calls, key=lambda c: c[0].shape[1])


def _largest(calls):
    """The captured call with the most jobs."""
    return max(calls, key=lambda c: c[0].shape[0])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import bwamem_tpu_torch  # noqa: F401  (fails outside the repo)

    phase("0 card")
    card = card_info()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("1 build")
    build_kernels()

    phase("2 kernel vs plain")
    k1 = kernel_phase("cuda")
    k2 = sw_kernel_phase("cuda")
    k1_1kb = kernel_phase("cuda", WIDE_SHAPES)
    k2_flt = sw_kernel_phase("cuda", FILTER_SHAPES, variants=[(0, 0)],
                             product=(0, 0), jobs=make_filter_jobs,
                             label="seed filter")
    k2_flt_pb = sw_kernel_phase("cuda", FILTER_PB_SHAPES, variants=[(0, 0)],
                                product=(0, 0), jobs=make_filter_jobs,
                                scoring=PACBIO, label="seed filter -x pacbio")
    k1_pb = [kernel_phase("cuda", sh, variants=[(False, 0)], scoring=PACBIO)
             for sh in PB_SHAPES]
    mixed_kernel_phase("cuda")
    k1_wide = kernel_phase("cuda", K1_WIDE_ROUTE_SHAPES,
                           variants=[(False, 0)])
    k3 = kernel_phase("cuda", K3_SHAPES, kernel="K3", variants=K3_VARIANTS)
    kernel_phase("cuda", K3_WIDE_SHAPES, kernel="K3", variants=[(300, 0)])
    k4 = probe_kernel_phase("cuda")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        phase("3 world")
        t0 = time.perf_counter()
        contigs = make_world(d)
        print(f"genome + reads simulated in {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index",
                        "-r", "4", os.path.join(d, "ref.fa"), "-p",
                        os.path.join(d, "idx")], check=True, timeout=900)
        print(f"index of {GENOME_LEN} bp built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        phase("4 align")
        launches, _, calls = align_phase(d)
        # the second, warm chunk's launch
        captured_ext("K1", "phase4", calls[min(1, len(calls) - 1)])

        phase("5 paired-end align")
        _, sw_launches, _, sw_calls = pe_align_phase(d)
        # the second, warm chunk's rescue launch
        cap = dict(rescue=captured_k2(
            "phase5 rescue", sw_calls[min(1, len(sw_calls) - 1)]))

        runs = long_read_phases(d, contigs)
        captured_ext("K1", "phase6", _widest(runs["long"]["k1_calls"]))
        captured_ext("K1", "pacbio1024", _widest(runs["pacbio"]["k1_calls"]))
        cap["filter"] = captured_k2("phase6 seed filter",
                                    _largest(runs["long"]["k2_calls"]))
        cap["filter_pb"] = captured_k2("pacbio seed filter",
                                       _largest(runs["pacbio"]["k2_calls"]))
        cap["banded"] = captured_ext("K3", "phase7",
                                     _largest(runs["vanilla"]["k3_calls"]))

        phase("9 seeding variants (-u 2, -u 3, -g, -u 4)")
        variant_phases(d)

        phase("10 fastmap")
        fastmap_phase(d)

    phase("11 the 16-bit probe")
    probe_launches = probe_phase()

    print(json.dumps({"kernels": [
        dict(name="extend_dense", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=launches, **k1),
        dict(name="swalign_local", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=sw_launches, **k2),
        dict(name="extend_dense_1kb", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=runs["long"]["K1"], **k1_1kb),
        dict(name="extend_dense_pacbio", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=runs["pacbio"]["K1"], **k1_pb[0]),
        dict(name="swalign_local_seedflt", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=runs["long"]["K2"], **k2_flt),
        dict(name="swalign_local_seedflt_pacbio", route="cuda",
             library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=runs["pacbio"]["K2"], **k2_flt_pb),
        dict(name="extend_banded", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_banded.cu",
             replaces="bwamem_tpu/ops/pallas/extend_banded.py:241",
             launches=runs["vanilla"]["K3"], **k3),
        dict(name="extend_dense_wide_route", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=runs["long"]["K1_wide"], **k1_wide),
        dict(name="swalign_local_captured_rescue", route="cuda",
             library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=sw_launches, **cap["rescue"]),
        dict(name="swalign_local_captured_seedflt", route="cuda",
             library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=runs["long"]["K2"], **cap["filter"]),
        dict(name="swalign_local_captured_seedflt_pacbio", route="cuda",
             library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=runs["pacbio"]["K2"], **cap["filter_pb"]),
        dict(name="extend_banded_captured", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_banded.cu",
             replaces="bwamem_tpu/ops/pallas/extend_banded.py:241",
             launches=runs["vanilla"]["K3"], **cap["banded"]),
        dict(name="int16_probe", route="cuda",
             source="bwamem_tpu_torch/csrc/int16_probe.cu",
             replaces="tools/mosaic_probe.py:29",
             launches=probe_launches, **k4)]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
