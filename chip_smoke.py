"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from csrc/ with nvcc, one nvcc a library, all in
     parallel: K1 (dense extension), K2 (local SW), K3 (banded
     extension), K4 (the 16-bit probe), K5 (the finalize's CIGAR solve)
     and the seeding kernels' three libraries (S1 seed_forward and S3
     seed_reseed_forward, S2 seed_backward, S4 sa_lookup);
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
     with --device cuda, counting K1 and K5 launches (the finalize at
     -t 1 on a card solves its CIGARs on K5, pipeline/finalize.py); then the first 1024 reads
     with --device cpu, whose SAM must be byte-identical to the GPU run's
     (apart from @PG); then K1 on the inputs of the second (warm) chunk's
     launch, captured by wrapping extend_kernel.extend_batch: exact
     against the plain version, timed, with its qlen quartiles, live-cell
     share and bound (so too after phase 6, on its launch, and after
     phase 8, on -x pacbio's 1024 bucket);
  5. align the pairs from two files (two chunks of 8192 pairs) through the
     CLI entry point with --device cuda, counting K1, K2 and K5 launches; then
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
 10. `fastmap` of the same 16384 reads on the card (512 reads a call),
     whose text for the first 512 reads must equal --device cpu's;
 11. the probe, `python -m bwamem_tpu_torch.tools.int16_probe` (its main,
     in this process, with K4's launch count reset around it): six PASS
     lines, its verdict, exit 0;
 12. the fused step (models/mem.device_align_step) on phase 4's first
     16384 reads (150 bp: K1 must launch, K3 must not) and on phase 6's
     4096 reads of 1 kb (the band window narrower than the row: K3 must
     launch), with the counts set to 0 just before each first run: warm
     reads/s (median of 3), has_seed share and share at the simulated
     origin; each run's outputs on its first 1024 reads, and a batch of
     the first 128 reads, equal to --device cpu's;
 13. a mesh of every visible card (parallel/sharded.make_mesh; one card
     here): sharded_align_step == device_align_step on phase 12's 150 bp
     batch; MemAligner(mesh=...) on phase 4's first 4096 reads and phase
     5's first 2048 pairs gives the SAM of MemAligner() without a mesh;
     then the route without the native core (loader.try_load patched to
     None) on 256 reads and 128 pairs, and the index forced wide on 1024
     reads, each with the SAM of the native, narrow route;
 14. two hosts: two CLI processes started together (`align --n-hosts 2
     --host-id r --coordinator 127.0.0.1:<free port>`) on phase 4's first
     1024 reads, and beside them two on phase 5's first 512 pairs with
     -I 350,50, on the card and then with --device cpu: the merged SAM
     (apart from @PG) the same on both, no shard file left; how many
     records differ from one host's is printed (each host restarts the
     read counter that breaks score ties), with each host's launches.
     Every main path of phases 4-14 also counts the seeding kernels'
     launches (reset just before its run, read just after): all four
     must launch in phases 4 and 5, S1, S2 and S4 in phases 6-8, 10, 12
     and 13 (mode "smem"; fastmap and the fused step run no re-seed
     round, so no S3); in phase 9 S1 and S4 on -g (its backward walk
     stays on torch ops) and S4 alone on -u 2/3/4 (SEED_VARIANT);
 15. the seeding kernels against their plain versions (the port's torch
     functions, on the card): on the captured calls of phase 4's warm
     chunk, of phase 6's 1 kb chunk and of the fused step's 150 bp batch,
     of phase 4's warm chunk again on the index without occ2 and forced
     wide, of -g's last chunk (phase 9) and of a 512-read fastmap call
     (phase 10): smem_seed_batch's final seeds equal the plain route's,
     and each call's kernel equals its plain version (S1 and S3 on their
     emit masks and emitted entries, S2 on the lanes the containment
     filter keeps, S4 in every field of every occurrence, in order),
     timed (median of 5; plain median of 3) with its bound
     (_seed_bound); then phase 4's warm chunk through the aligner
     (collect) on the kernels and on the plain route under
     torch.profiler, in a process of its own: wall, seed_device, CUDA
     kernels, device busy share; the kernel route's profile must hold
     S1-S4's kernels (SEED_KERNEL_NAMES);
 16. the finalize (finalize_phase): SE 150 and PE 150 (phases 4 and 5's
     reads and chunks), 8192 pairs of 2 x 250, phase 6's 1 kb reads,
     -x pacbio's, and -a (4096 reads) and -a -M (4096 pairs) of 150 bp,
     each through the CLI with the split finalize (K5) and again with
     the native finalize it replaces: the whole SAMs byte-identical, each
     run's finalize span, the jobs K5 and the host solved, K5's launches;
     then K5 on the largest captured call of SE 150, PE 250, 1 kb and
     -x pacbio against its plain version on a sample of the call's jobs, exact,
     timed, with its bound over the live band cells of the passes K5
     runs.
Phases 12-16 print their seconds. Then one JSON line for the kernels
(the seeding kernels with phase 4's launches, launches by phase, and
phase 4's warm-chunk records), the card line, and the device JSON as
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
import threading
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


# the seeding kernels: name -> (the JAX function it replaces, its source)
SEED_KERNELS = {
    "seed_forward": ("bwamem_tpu/ops/seeding.py:176 _forward_pass2 (:111 "
                     "_forward_pass, :796 _seed_strategy_pass)",
                     "bwamem_tpu_torch/csrc/seed_forward.cu"),
    "seed_backward": ("bwamem_tpu/ops/seeding.py:366 _backward_pass",
                      "bwamem_tpu_torch/csrc/seed_backward.cu"),
    "seed_reseed_forward": ("bwamem_tpu/ops/seeding.py:842 _reseed_forward",
                            "bwamem_tpu_torch/csrc/seed_forward.cu"),
    "sa_lookup": ("bwamem_tpu/ops/fm.py:666 sa_lookup_batch (:965 "
                  "_expand_occurrences of bwamem_tpu/ops/seeding.py)",
                  "bwamem_tpu_torch/csrc/sa_lookup.cu")}
# the seeding kernels' bound: the integer instructions a table word costs
# a query (xor, not, shift, and, popcount, add: one code's match count)
OPS_PER_WORD = 6


def make_seed_reads(g, rng, B: int, L: int):
    """B reads (int8 codes, (B, L), 4 = N or pad, and (B,) int32 lengths)
    of up to L bases from genome codes g: 1.5% substitutions, a 2-base
    deletion in every fifth, every other one reverse-complemented, an N
    base in every fourth, and every seventh of length 0, 1, 2, 19 or L in
    turn (the seeding kernels' edge cases)."""
    import numpy as np

    reads = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = (int(rng.integers(min(90, L // 2), L - 1)) if b % 7
             else [0, 1, 2, 19, L][b // 7 % 5])
        p = int(rng.integers(0, len(g) - n - 4))
        r = g[p:p + n + 4].copy()
        if b % 5 == 2 and n > 45:
            c = int(rng.integers(20, n - 20))
            r = np.delete(r, [c, c + 1])
        r = r[:n]
        e = rng.random(n) < 0.015
        r[e] = (r[e] + 1) % 4
        if b % 2:
            r = (3 - r)[::-1].copy()
        if b % 4 == 1 and n:
            r[int(rng.integers(0, n))] = 4
        reads[b, :n] = r
        lens[b] = n
    return reads, lens


def _seed_counts() -> dict:
    from bwamem_tpu_torch.ops.kernels import seed_kernels

    return dict(seed_kernels.LAUNCHES)


def _reset_seed_counts() -> None:
    from bwamem_tpu_torch.ops.kernels import seed_kernels

    for k in seed_kernels.LAUNCHES:
        seed_kernels.LAUNCHES[k] = 0


SEED_ALL = tuple(SEED_KERNELS)
SEED_R1 = ("seed_forward", "seed_backward", "sa_lookup")
# phase -> the seeding kernels' launches in its main-path run
SEED_LAUNCHES: dict = {}


def _seed_phase(tag: str, device: str, need=(), absent=()) -> dict:
    """After a phase's main-path run: its seeding kernel launches, printed
    and kept in SEED_LAUNCHES[tag]; on the card, every kernel in `need`
    must have launched and none in `absent`. Returns the counts."""
    counts = _seed_counts()
    SEED_LAUNCHES[tag] = counts
    print(f"{tag}: seeding kernel launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    bad = [k for k in need if counts[k] < 1] + [k for k in absent
                                                 if counts[k] > 0]
    if device == "cuda" and bad:
        raise SystemExit(f"{tag}: seeding kernel launches {counts}; "
                         f"wrong for {bad}")
    return counts


def _clone(x):
    import torch

    return x.clone() if isinstance(x, torch.Tensor) else x


@contextmanager
def _seed_wrappers(fns: dict):
    """Inside the block, seed_kernels' wrapper functions named in `fns`
    are the given functions (ops/seeding.py calls them through the
    module)."""
    from bwamem_tpu_torch.ops.kernels import seed_kernels

    orig = {name: getattr(seed_kernels, name) for name in fns}
    for name, fn in fns.items():
        setattr(seed_kernels, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(seed_kernels, name, fn)


@contextmanager
def capture_seed_calls():
    """Record every call of the four seeding wrappers made inside the
    block, each as (name, args, kwargs, thread) with its tensors cloned;
    the index (the first argument) is kept as it is, and `thread` is the
    calling thread's ident (the pipeline's collector threads seed chunks
    side by side). Yields the list."""
    from bwamem_tpu_torch.ops.kernels import seed_kernels

    calls = []

    def wrap(name):
        orig = getattr(seed_kernels, name)

        def wrapped(fm, *args, **kw):
            calls.append((name, (fm,) + tuple(map(_clone, args)),
                          {k: _clone(v) for k, v in kw.items()},
                          threading.get_ident()))
            return orig(fm, *args, **kw)
        return wrapped

    with _seed_wrappers({name: wrap(name) for name in SEED_KERNELS}):
        yield calls


@contextmanager
def plain_seeding():
    """Inside the block, the four seeding wrappers run their plain
    versions on whatever device the tensors are on (the route before the
    kernels)."""
    with _seed_wrappers(_seed_plain()):
        yield


def _seed_plain() -> dict:
    from bwamem_tpu_torch.ops import seeding
    from bwamem_tpu_torch.ops.kernels import seed_kernels

    return {"seed_forward": seed_kernels.seed_forward_plain,
            "seed_backward": seeding._backward_pass,
            "seed_reseed_forward": seeding._reseed_forward,
            "sa_lookup": seeding._expand_occurrences}


def _emitted_err(got, want, mask_at: int) -> int:
    """Max abs difference of planes `got` and `want` (tuples) on the
    entries their mask plane (index mask_at) sets; -1 when the masks
    differ."""
    import torch

    mg, mw = got[mask_at], want[mask_at]
    if not torch.equal(mg, mw):
        return -1
    err = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if i != mask_at and mw.any():
            err = max(err, int((a[mw].long() - b[mw].long()).abs().max()))
    return err


def _kept_err(got, want, group) -> int:
    """seed_backward's rule: the lanes the containment filter keeps (its
    containment clause, qb below every later qb of the lane's group; its
    length clause reads the same qb) must agree, and their (qb, k, s);
    -1 when the kept masks differ."""
    import torch

    from bwamem_tpu_torch.ops.seeding import _segmented_suffix_min

    def kept(qb):
        return qb.long() < _segmented_suffix_min(qb, group)

    kg, kw = kept(got[0]), kept(want[0])
    if not torch.equal(kg, kw):
        return -1
    err = 0
    for a, b in zip(got, want):
        if kw.any():
            err = max(err, int((a[kw].long() - b[kw].long()).abs().max()))
    return err


def _seed_compare(name, got, want, args, kw) -> int:
    """A seeding kernel's output against its plain version's, by the
    kernel's rule (seed_kernels' docstring). Returns the max abs err on
    the entries compared, -1 for a mask that differs."""
    import torch

    if name == "seed_forward":
        errs = [_emitted_err(got[0], want[0], 3)]
        if want[1] is not None:
            errs.append(_emitted_err(got[1], want[1], 3))
        return -1 if min(errs) < 0 else max(errs)
    if name == "seed_reseed_forward":
        return _emitted_err(got, want, 3)
    if name == "seed_backward":
        group = kw.get("group")
        return _kept_err(got, want, args[2] if group is None else group)
    # sa_lookup: every field of every occurrence, in order
    if any(got[f].shape != want[f].shape for f in SEED_KEYS):
        return -1
    return max(int((got[f].long() - want[f].long()).abs().max())
               if len(want[f]) else 0 for f in SEED_KEYS)


def _table_bytes(touched: int, *tables) -> int:
    """The bytes of the index's `tables` one seeding call must read from
    HBM: the table rows its walks touch (`touched` bytes, repeats
    counted), but no byte twice, so at most the tables' size (a repeated
    row comes from L2)."""
    return min(touched, sum(t.numel() * t.element_size() for t in tables))


def _seed_bound(name, args, kw, want) -> dict:
    """The least time of one seeding kernel call on these inputs (_bound).
    Bytes: its inputs once, the emit planes and the emitted entries once,
    and each byte of the index tables its walks read once (_table_bytes).
    Operations: OPS_PER_WORD instructions for each table word a walk
    queries, every query counted (a row at each end of the interval a
    step). The steps are this run's: a forward walk's trips to its read's
    end, a backward lane's bases prepended (plus the failed one), a
    re-seed lane's trips to its last emission, an occurrence's LF steps
    (its position mod sa_intv, the index sampling by text position; S4
    reads every SMEM's keep byte and the fields of the SMEMs that own an
    occurrence, and gives occurrences out)."""
    import torch

    fm = args[0]
    dsz = 8 if fm.wide else 4
    occ = fm.occ_blocks[:int(fm.n_occ_blocks)]
    row_bytes = 128 if fm.has_occ2 else 32
    walk_table = fm.occ2_blocks if fm.has_occ2 else occ
    if name == "seed_forward":
        reads, lens = args[1], args[2]
        B, L = reads.shape
        ln = lens.long()
        trips = int(((ln + 2) // 2).sum() if fm.has_occ2 else (ln + 1).sum())
        walks = 1 + (want[1] is not None)
        rows = 2 * trips * walks
        outs = [p for p in (want[0], want[1]) if p is not None]
        nbytes = (reads.numel() * 4 + B * 4
                  + sum(p[3].numel() + int(p[3].sum()) * (4 + 2 * dsz)
                        for p in outs)
                  + _table_bytes(rows * row_bytes, walk_table))
    elif name == "seed_backward":
        qbeg = args[3]
        P = qbeg.shape[0]
        steps = int((qbeg.long() - want[0].long() + 1).sum())
        rows, row_bytes = 2 * steps, 32
        nbytes = (P * (4 + 4 + 2 * dsz + 4 + 2 * dsz) + steps * 4
                  + _table_bytes(rows * row_bytes, occ))
        if kw.get("floor") is not None:
            nbytes += P * dsz
    elif name == "seed_reseed_forward":
        fill = want[3]
        R, W = fill.shape
        col = torch.arange(W, device=fill.device)
        last = torch.where(fill, col, 0).max(dim=1).values if R else col[:0]
        trips = int(((last + 1) // 2).sum() if fm.has_occ2 else last.sum())
        rows = 2 * trips
        nbytes = (R * (4 + 4 + dsz) + fill.numel()
                  + int(fill.sum()) * (2 * dsz + 4)
                  + _table_bytes(rows * row_bytes, *(
                      (walk_table, occ) if fm.has_occ2 else (occ,))))
    else:
        s, keep = args[5], args[6]
        n = want["rbeg"].shape[0]
        steps = int((want["rbeg"].long() % fm.sa_intv).sum())
        rows, row_bytes = n + 2 * steps, 32
        # the SMEMs in: every keep byte, and (rid, qbeg, qend, k, s) only
        # of those with an occurrence (a kept s above 0); the occurrences
        # out (read_id, qbeg, qend, rbeg, n_occ); the sampled value each
        # row ends on, and the occ and SSA-bitmap rows of its steps
        owners = int(((s.long() > 0) & keep.bool()).sum())
        vals = (fm.ssa_vals, fm.ssa_vals_hi) if fm.wide else (fm.ssa_vals,)
        nbytes = (keep.numel() + (owners + n) * (3 * 4 + 2 * dsz)
                  + _table_bytes(n * (4 + fm.wide), *vals)
                  + _table_bytes(rows * row_bytes, fm.occ_blocks))
    return _bound(nbytes, rows * (row_bytes // 4) * OPS_PER_WORD)


def check_seed_call(label: str, call, timed: bool = True) -> dict:
    """One captured seeding kernel call (capture_seed_calls) replayed:
    the kernel against its plain version on the same inputs, by the
    kernel's rule (_seed_compare), both timed (median of 5 for the kernel,
    of 3 for the plain version, CUDA events around a wrapper call, so the
    wrapper's host work included; `timed` False skips it), with the bound
    (_seed_bound). Prints one line; exits on a mismatch. Returns the
    record."""
    import torch

    from bwamem_tpu_torch.ops.kernels import seed_kernels

    name, args, kw = call[:3]
    kern = getattr(seed_kernels, name)
    plain = _seed_plain()[name]
    want = plain(*args, **kw)
    got = kern(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    err = _seed_compare(name, got, want, args, kw)
    if err != 0:
        raise SystemExit(f"{name} != plain on {label}: "
                         + ("a mask differs" if err < 0
                            else f"max abs err {err}"))
    ms = plain_ms = None
    if timed:
        ms = _median_ms(lambda: kern(*args, **kw))
        plain_ms = _median_ms(lambda: plain(*args, **kw), reps=3)
    bound = _seed_bound(name, args, kw, want)
    shape = "x".join(str(d) for d in args[1].shape)
    print(f"{name} on {label} ({shape}): equal; kernel {ms} ms, plain "
          f"{plain_ms} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


SEED_KEYS = ("read_id", "qbeg", "qend", "rbeg", "n_occ")


def seed_route_check(label: str, fm, reads, lens, cfg) -> list:
    """smem_seed_batch on (reads, lens) through the kernels, with its calls
    captured, against the plain route (plain_seeding) on the same device:
    the final seed arrays must be equal. Returns the captured calls."""
    import torch

    from bwamem_tpu_torch.ops.seeding import smem_seed_batch

    with plain_seeding():
        want = smem_seed_batch(fm, reads, lens, cfg)
    with capture_seed_calls() as calls:
        got = smem_seed_batch(fm, reads, lens, cfg)
    bad = [k for k in SEED_KEYS
           if not torch.equal(got[k].long(), want[k].long())]
    if bad:
        raise SystemExit(f"{label}: smem_seed_batch's seeds differ from "
                         f"the plain route's in {bad}")
    print(f"{label}: smem_seed_batch on the kernels == the plain route "
          f"({len(want['rbeg'])} seeds of {reads.shape[0]} reads)",
          flush=True)
    return calls


def seed_kernel_phase(contexts, timed: bool = True) -> dict:
    """Each seeding kernel against its plain version on main-path inputs.
    contexts: (label, fm, cfg, reads, lens, calls): smem_seed_batch of
    (reads, lens) with cfg on fm is held to the plain route
    (seed_route_check), then every call of `calls` (the main path's
    captured calls of that batch; None: those seed_route_check captured)
    is replayed (check_seed_call). Returns {(label, name, i): record}, i
    counting that kernel's calls in the batch."""
    out = {}
    for label, fm, cfg, reads, lens, calls in contexts:
        fresh = seed_route_check(label, fm, reads, lens, cfg)
        seen: dict = {}
        for call in calls if calls is not None else fresh:
            i = seen[call[0]] = seen.get(call[0], -1) + 1
            out[label, call[0], i] = check_seed_call(
                label + (f" (call {i + 1})" if i else ""), call, timed)
    return out


def warm_chunk(calls) -> list:
    """The calls of the last smem_seed_batch among captured calls: its
    seed_forward call and the later calls of the same thread."""
    last = max(i for i, c in enumerate(calls) if c[0] == "seed_forward")
    return [c for c in calls[last:] if c[3] == calls[last][3]]


# the device functions a warm chunk of phase 4 launches on S1-S4 (the
# occ2 pair walk, the backward walk, the re-seed walks, the SA lookup's
# count and scan, and its lookup)
SEED_KERNEL_NAMES = ("seed_pairs_kernel", "seed_backward_kernel",
                     "seed_reseed_kernel", "sa_count_kernel",
                     "sa_lookup_kernel")


def seed_profile(fm, idx, seqs, device: str = "cuda") -> dict:
    """One warm chunk of the SE aligner (MemAligner.collect_regs_batch on
    `seqs`, after one warm-up) on the seeding kernels and on the plain
    route, each under torch.profiler: wall, the seed_device span, CUDA
    kernels launched and the device's busy share (the summed kernel time
    over the wall). On the card the kernel route's profile must hold
    every kernel of SEED_KERNEL_NAMES. Returns {route: record}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions
    from bwamem_tpu_torch.utils.timing import Timings

    al = MemAligner(MemOptions(), idx, fm=fm, device=device)
    out = {}
    for route in ("kernels", "plain"):
        ctx = plain_seeding() if route == "plain" else ExitStack()
        with ctx:
            al.collect_regs_batch(seqs)  # warm-up
            al.timings = Timings()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                al.collect_regs_batch(seqs)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            al.timings, seed_s = None, al.timings.totals["seed_device"]
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in ops if not e.name.startswith(("Memcpy", "Memset"))]
        missing = [k for k in SEED_KERNEL_NAMES if device == "cuda"
                   and route == "kernels"
                   and not any(k in e.name for e in kern)]
        if missing:
            raise RuntimeError(f"seed_profile: the profile of the kernel "
                               f"route holds no {missing}")
        busy = sum(e.device_time_total for e in ops) / 1e6
        out[route] = dict(wall=wall, seed_device=seed_s, kernels=len(kern),
                          device_ops=len(ops), busy=busy / wall)
        print(f"warm chunk ({len(seqs)} reads), seeding on the {route}: "
              f"collect {wall:.4f} s, seed_device {seed_s:.4f} s, "
              f"{len(kern)} CUDA kernels ({len(ops)} device ops with the "
              f"copies and sets), device busy {out[route]['busy']:.4f}",
              flush=True)
    return out


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
               victim_every: int = VICTIM_EVERY, read_len: int = READ_LEN,
               insert=(350, 50, 260), tag: str = ""):
    """The JAX package's PE bench traffic (bench.py main_pe): FR pairs of
    150 bp, insert max(260, N(350, 50)), 1% substitutions (other pairs
    by read_len and insert = (mean, sd, least)) into {tag}r1.fq /
    {tag}r2.fq and their first N_COMPARE pairs into {tag}head1.fq /
    {tag}head2.fq. Every victim_every-th pair's read 2 gets one
    substitution every 12 bp, so it has no 19-bp seed (a victim). Names
    carry both origins and the victim flag: p{i}_{pos1}_{pos2}_{victim}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L = read_len
    recs = ([], [])
    for i in range(n_pairs):
        isize = max(insert[2], int(rng.normal(insert[0], insert[1])))
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
        with open(os.path.join(d, f"{tag}r{k}.fq"), "w") as f:
            f.writelines(out)
        with open(os.path.join(d, f"{tag}head{k}.fq"), "w") as f:
            f.writelines(out[:N_COMPARE])


def _records(path):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("@PG")]


def align_phase(d: str, device: str = "cuda",
                chunk_reads: int = CHUNK_READS, seed_calls=None):
    """The main path: `align` through the CLI entry point on `device`,
    with the kernels' launch counts reset just before and read just after
    (K1, and the seeding kernels: all four must launch on the card) and
    K1's calls captured (capture_calls; the seeding kernels' calls too,
    capture_seed_calls, into the list `seed_calls` when one is given).
    Then the first N_COMPARE reads on the CPU. K5's launches (the split
    finalize's CIGAR solve) are counted too and must be at least one on
    the card. Returns K1's launch count, reads/s and its captured
    calls."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import cigar_kernel, extend_kernel

    idx = os.path.join(d, "idx")
    out = os.path.join(d, f"{device}.sam")
    tsv = os.path.join(d, f"{device}.tsv")
    argv = ["align", "--device", device, "-t", "1", "-K",
            str(chunk_reads * READ_LEN), "-f", tsv, idx,
            os.path.join(d, "reads.fq"), "-o", out]
    extend_kernel.LAUNCHES = cigar_kernel.LAUNCHES = 0
    _reset_seed_counts()
    t0 = time.perf_counter()
    with capture_calls("K1") as calls, capture_seed_calls() as scalls:
        if main(argv) != 0:
            raise SystemExit("align failed")
    wall = time.perf_counter() - t0
    launches, k5 = extend_kernel.LAUNCHES, cigar_kernel.LAUNCHES
    _seed_phase("4", device, SEED_ALL)
    if seed_calls is not None:
        seed_calls.extend(scalls)
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
          f"{row.get('ext_device')} s, finalize {row.get('finalize')} s "
          f"(cigar_device {row.get('cigar_device')} s) over {n_chunks} "
          f"chunks; K1 launches {launches}, K5 launches {k5}", flush=True)
    if (launches < 1 or k5 < 1) and device == "cuda":
        raise SystemExit("the main path launched no extension kernel or "
                         "no K5")
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
    point on `device`, with K1's, K2's and the seeding kernels' launch
    counts reset just before and read just after (all four seeding
    kernels must launch on the card) and K2's calls captured
    (capture_calls). Then the
    head pairs on `device` and on the CPU, with the same flags and -K,
    must give the same SAM. K5's launches are counted too (at least one on
    the card). Returns (K1 launches, K2 launches, pairs/s, the captured K2
    calls)."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import (cigar_kernel, extend_kernel,
                                              swalign_kernel)

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
    swalign_kernel.LAUNCHES = cigar_kernel.LAUNCHES = 0
    _reset_seed_counts()
    t0 = time.perf_counter()
    with capture_calls("K2") as sw_calls:
        out, tsv = align(device, "r1.fq", "r2.fq", "main")
    wall = time.perf_counter() - t0
    k1, k2 = extend_kernel.LAUNCHES, swalign_kernel.LAUNCHES
    k5 = cigar_kernel.LAUNCHES
    _seed_phase("5", device, SEED_ALL)
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
          f"s, finalize {row.get('finalize')} s (cigar_device "
          f"{row.get('cigar_device')} s); "
          f"K1 launches {k1}, K2 launches {k2}, K5 launches {k5}",
          flush=True)
    if device == "cuda" and (k1 < 1 or k2 < 1 or k5 < 1):
        raise SystemExit("the PE main path launched no K1, K2 or K5")
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
               capture: bool = False, seed_need=SEED_R1,
               seed_absent=()) -> dict:
    """A further main path: SE `align` of `reads` with `flags` through the
    CLI entry point on `device`, every kernel's launch count reset just
    before and read just after; kernels in `need` must have launched. Then
    the first n_head reads with --device cpu, whose SAM must be
    byte-identical to the device run's records of those reads. The
    seeding kernels in `seed_need` must launch on the card and those in
    `seed_absent` must not. Returns the launch counts (K1, K1's wide
    route, K2, K3, the seeding kernels), reads/s and, with `capture`, the
    device run's K1, K2 and K3 calls (capture_calls) as k1_calls, k2_calls
    and k3_calls and its seeding calls (capture_seed_calls) as
    seed_calls. K5's launches (the finalize's CIGAR solve) are counted
    with the others."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import (cigar_kernel, extend_banded,
                                              extend_kernel, swalign_kernel)

    idx = os.path.join(d, "idx")
    mods = {"K1": extend_kernel, "K2": swalign_kernel, "K3": extend_banded,
            "K5": cigar_kernel}

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
    _reset_seed_counts()
    t0 = time.perf_counter()
    with ExitStack() as stack:
        calls = {f"{k.lower()}_calls": stack.enter_context(
            capture_calls(k)) for k in CAPTURED} if capture else {}
        if capture:
            calls["seed_calls"] = stack.enter_context(capture_seed_calls())
        recs, row = align(device, os.path.join(d, reads), "main")
    wall = time.perf_counter() - t0
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    counts["K1_wide"] = extend_kernel.WIDE_LAUNCHES
    counts.update(_seed_phase(tag, device, seed_need, seed_absent))
    body = [ln.split("\t") for ln in recs if not ln.startswith("@")]
    prim = [f for f in body if not int(f[1]) & 0x900]
    n = len(prim)
    mapped = sum(not int(f[1]) & 4 for f in prim)
    spans = ", ".join(f"{k} {row[k]} s" for k in (
        "collect", "seed_device", "seed_filter", "chain_native",
        "ext_device", "finalize", "cigar_device") if row.get(k))
    print(f"{tag} ({' '.join(flags) or 'default flags'}) --device {device}: "
          f"{n} reads in {wall:.2f} s wall (index load + setup included) = "
          f"{n / wall:.1f} reads/s; mapped {mapped / n:.4f}; spans {spans}; "
          f"launches K1 {counts['K1']} (wide route {counts['K1_wide']}), "
          f"K2 {counts['K2']}, K3 {counts['K3']}, K5 {counts['K5']}",
          flush=True)
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
        reads = simulate_reads(rng, contigs, n, read_len=length, sub=sub,
                               ins=ins, dele=dele, prefix=name)
        write_fastq(os.path.join(d, f"{name}.fq"), reads)
        # each read's simulated origin, for phase 12's at-origin share
        with open(os.path.join(d, f"{name}.truth"), "w") as f:
            f.writelines(f"{r.name}\t{r.pos}\t{r.strand}\n" for r in reads)
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


# phase 9's seeding kernels: -g seeds its forward walk on S1 and every
# variant looks up SA positions on S4; the rest stays on torch ops
SEED_VARIANT = {"g": ("seed_forward", "sa_lookup"), "u2": ("sa_lookup",),
                "u3": ("sa_lookup",), "u4": ("sa_lookup",)}


def variant_phases(d: str, device: str = "cuda", sizes=VARIANT_READS,
                   heads=VARIANT_HEADS) -> dict:
    """Phase 9 on the world of phase 3: -u 2, -u 3 and -g on the first
    sizes[0] reads of reads.fq, -u 4 on the first sizes[1], each through
    flag_phase (K1 must launch; the seeding kernels of SEED_VARIANT must
    launch on the card and no other; device SAM == CPU SAM on the head;
    -g's seeding calls captured). Returns each variant's launch counts
    and reads/s."""
    n, n4 = sizes
    _head(os.path.join(d, "reads.fq"), os.path.join(d, "var.fq"), n)
    _head(os.path.join(d, "reads.fq"), os.path.join(d, "var4.fq"), n4)
    return {tag: flag_phase(
        d, tag, reads, head, flags, ("K1",), device, capture=tag == "g",
        seed_need=SEED_VARIANT[tag],
        seed_absent=tuple(k for k in SEED_ALL if k not in SEED_VARIANT[tag]))
        for tag, reads, head, flags in (
            ("u2", "var.fq", heads[0], ["-u", "2"]),
            ("u3", "var.fq", heads[0], ["-u", "3"]),
            ("g", "var.fq", heads[0], ["-g"]),
            ("u4", "var4.fq", heads[1], ["-u", "4"]))}


def fastmap_phase(d: str, device: str = "cuda",
                  n_head: int = FASTMAP_HEAD) -> tuple:
    """Phase 10: `fastmap` of var.fq (phase 9's reads) through the CLI
    entry point on `device` (the round-1 seeding kernels must launch on
    the card; their calls captured), then of its first n_head reads with
    --device cpu, whose text must equal the device run's for those reads.
    Returns (reads/s, the captured seeding calls)."""
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

    _reset_seed_counts()
    t0 = time.perf_counter()
    with capture_seed_calls() as calls:
        got = fastmap(device, os.path.join(d, "var.fq"), "main")
    wall = time.perf_counter() - t0
    _seed_phase("10", device, SEED_R1)
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
    return len(got) / wall, calls


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


def _batch(path: str, n: int):
    """(names, code arrays) of the first n records of a FASTQ file."""
    from bwamem_tpu_torch.io.fastx import read_fastx

    recs = [r for _, r in zip(range(n), read_fastx(path))]
    return [r.name for r in recs], [r.seq for r in recs]


def _reads_tensors(seqs, device):
    """The (B, L) reads and (B,) lengths the fused step takes, L the
    aligner's seeding bucket of the longest read."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.utils.shapes import bucket_read_len

    L = bucket_read_len(max(len(s) for s in seqs))
    reads = np.full((len(seqs), L), 4, np.int8)
    lens = np.zeros(len(seqs), np.int32)
    for i, q in enumerate(seqs):
        reads[i, :len(q)] = q
        lens[i] = len(q)
    return (torch.from_numpy(reads).to(device),
            torch.from_numpy(lens).to(device))


STEP_KEYS = ("score", "qb", "qe", "rb", "re", "has_seed")


def _same_step(got: dict, want: dict, n: int, what: str,
               n_seeds: bool = False) -> None:
    """The step's per-read outputs of the first n reads (and n_seeds, on
    the same batch) equal, or exit."""
    import torch

    for k in STEP_KEYS + (("n_seeds",) if n_seeds else ()):
        a, b = got[k].cpu(), want[k].cpu()
        if k != "n_seeds":
            a, b = a[:n], b[:n]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:1].tolist()
            raise SystemExit(f"{what}: {k} differs (first at {bad})")


def _counts():
    from bwamem_tpu_torch.ops.kernels import (cigar_kernel, extend_banded,
                                              extend_kernel, swalign_kernel)

    return dict(K1=extend_kernel.LAUNCHES, K2=swalign_kernel.LAUNCHES,
                K3=extend_banded.LAUNCHES, K5=cigar_kernel.LAUNCHES,
                **_seed_counts())


def _reset_counts() -> None:
    from bwamem_tpu_torch.ops.kernels import (cigar_kernel, extend_banded,
                                              extend_kernel, swalign_kernel)

    extend_kernel.LAUNCHES = swalign_kernel.LAUNCHES = 0
    extend_banded.LAUNCHES = cigar_kernel.LAUNCHES = 0
    _reset_seed_counts()


def fused_step_phase(fms: dict, tag: str, names, seqs, truth: dict,
                     need: str, absent: str, heads=(1024, 128),
                     device: str = "cuda") -> dict:
    """The fused step (models/mem.device_align_step) on one batch on
    `device`: the kernels' counts set to 0 just before its first run and
    read just after (`need` must have launched, `absent` not, and the
    round-1 seeding kernels; its seeding calls are captured,
    capture_seed_calls); then the
    median of 3 warm runs, the `need` launch of the first run replayed
    alone (capture_calls; median of 5), the has_seed share and the share
    within 5 bp of the simulated origin (truth: name -> (pos, strand); no
    gate); then
    the first heads[0] reads' outputs against the CPU's on those reads,
    and a batch of the first heads[1] reads on `device` against the CPU's
    on it (n_seeds too). fms: device -> DeviceFMIndex. Returns the counts,
    reads/s and the seeding calls (seed_calls)."""
    import torch

    from bwamem_tpu_torch.models.mem import device_align_step

    reads, lens = _reads_tensors(seqs, device)

    def run(r, ln, dev):
        out = device_align_step(fms[dev], r, ln)
        if dev == "cuda":
            torch.cuda.synchronize()
        return out

    _reset_counts()
    t0 = time.perf_counter()
    with capture_calls(need) as calls, capture_seed_calls() as seed_calls:
        out = run(reads, lens, device)
    cold = time.perf_counter() - t0
    counts = _counts()
    _seed_phase(f"12 {tag}", device, SEED_R1)
    if device == "cuda" and (counts[need] < 1
                             or (absent and counts[absent] > 0)):
        raise SystemExit(f"{tag}: the fused step launched {counts}; {need} "
                         f"must launch" + (f" and {absent} must not"
                                           if absent else ""))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(reads, lens, device)
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)
    B = len(seqs)
    has = out["has_seed"].cpu()
    l2 = 2 * int(fms[device].l_pac)
    rb, re_, qb, qe = (out[k].cpu().tolist() for k in ("rb", "re", "qb",
                                                       "qe"))
    at_origin = 0
    for i, name in enumerate(names):
        if not has[i] or name not in truth:
            continue
        pos, strand = truth[name]
        start = (rb[i] - qb[i] if rb[i] < l2 // 2
                 else l2 - re_[i] - (len(seqs[i]) - qe[i]))
        at_origin += (rb[i] >= l2 // 2) == bool(strand) and abs(
            start - pos) <= 5
    if calls and device == "cuda":
        # the step's extension alone: its captured launch, replayed
        *args, p = calls[0]
        kern = getattr(_kmod(need), CAPTURED[need][1])
        ext_ms = _median_ms(lambda: kern(*args, p))
        print(f"{tag}: {need} on the step's captured launch: "
              f"{args[0].shape[0]} jobs, QMAX {args[0].shape[1]}, TMAX "
              f"{args[1].shape[1]}: {ext_ms:.3f} ms (median of 5) of the "
              f"step's warm {warm * 1e3:.1f} ms", flush=True)
    print(f"{tag}: fused step --device {device}: {B} reads of "
          f"{reads.shape[1]} columns; cold {cold:.3f} s, warm "
          f"{statistics.median(times):.4f} s (median of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)}) = {B / warm:.1f} "
          f"reads/s; has_seed {float(has.float().mean()):.4f}; at the "
          f"simulated origin {at_origin / B:.4f}; n_seeds "
          f"{int(out['n_seeds'])}; launches K1 {counts['K1']}, K3 "
          f"{counts['K3']}", flush=True)
    t0 = time.perf_counter()
    n, m = heads
    _same_step(out, run(reads[:n].cpu(), lens[:n].cpu(), "cpu"), n,
               f"{tag}: first {n} reads, {device} vs cpu")
    _same_step(run(reads[:m], lens[:m], device),
               run(reads[:m].cpu(), lens[:m].cpu(), "cpu"), m,
               f"{tag}: a batch of {m} reads, {device} vs cpu", True)
    print(f"{tag}: first {n} reads and a batch of {m}: {device} == cpu "
          f"(CPU runs {time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(counts, reads_per_s=B / warm, seed_calls=seed_calls)


def mesh_phase(d: str, fm, device: str = "cuda", n_chips: int = 0,
               sizes=(4096, 2048), step_reads: int = 16384,
               no_native=(256, 128), n_wide: int = 1024) -> dict:
    """Phase 13: a mesh of every visible card (make_mesh, one card
    today). sharded_align_step equals device_align_step on the first
    step_reads reads of reads.fq; MemAligner(mesh=...) gives the SAM of
    MemAligner() on the first sizes[0] reads and sizes[1] pairs; then,
    without a mesh, the route without the native core (loader.try_load
    patched to None) equals the native route on no_native reads and
    pairs, and the index forced wide equals the narrow one on n_wide
    reads. The kernels' counts are read around the mesh's runs. Returns
    them with the mesh's reads/s."""
    import dataclasses

    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.models.mem import device_align_step
    from bwamem_tpu_torch.native import loader
    from bwamem_tpu_torch.parallel import sharded
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions

    idx = FMIndex.load(os.path.join(d, "idx.bmt"))
    mesh = sharded.make_mesh(n_chips or None, device)
    names, seqs = _batch(os.path.join(d, "reads.fq"), max(sizes[0],
                                                          step_reads))
    reads, lens = _reads_tensors(seqs[:step_reads], device)
    step, total = sharded.sharded_align_step(mesh)(
        sharded.replicate_index(mesh, fm),
        *sharded.shard_reads(mesh, reads, lens)[:2])
    one = device_align_step(fm, reads, lens)
    _same_step(step, one, step_reads, "sharded_align_step vs the step")
    if total != int(one["n_seeds"]):
        raise SystemExit(f"mesh seeds {total} != {int(one['n_seeds'])}")
    print(f"mesh of {mesh.size} ({', '.join(map(str, mesh.devices))}): "
          f"sharded_align_step == device_align_step on {step_reads} reads, "
          f"{total} seeds", flush=True)

    pnames, pseqs = [], []
    for a, b in zip(zip(*_batch(os.path.join(d, "r1.fq"), sizes[1])),
                    zip(*_batch(os.path.join(d, "r2.fq"), sizes[1]))):
        pnames += [a[0], b[0]]
        pseqs += [a[1], b[1]]

    def sam(al, n_se, n_pe):
        return (al.align_batch(names[:n_se], seqs[:n_se]),
                al.align_pairs_batch(pnames[:2 * n_pe], pseqs[:2 * n_pe]))

    opt = MemOptions()
    want = sam(MemAligner(opt, idx, fm=fm, device=device), *sizes)
    _reset_counts()
    t0 = time.perf_counter()
    got = sam(MemAligner(opt, idx, fm=fm, device=device, mesh=mesh), *sizes)
    wall = time.perf_counter() - t0
    counts = _counts()
    _seed_phase("13", device, SEED_R1)
    if got != want:
        raise SystemExit("MemAligner(mesh=...) SAM differs from one device's")
    if device == "cuda" and (counts["K1"] < 1 or counts["K2"] < 1):
        raise SystemExit(f"the mesh's aligner launched {counts}")
    rate = (sizes[0] + 2 * sizes[1]) / wall
    print(f"MemAligner(mesh) SE {sizes[0]} reads + PE {sizes[1]} pairs: SAM "
          f"== one device's ({len(got[0]) + len(got[1])} lines) in "
          f"{wall:.2f} s = {rate:.1f} reads/s; launches K1 {counts['K1']}, "
          f"K2 {counts['K2']}, K3 {counts['K3']}", flush=True)

    t0 = time.perf_counter()
    want = sam(MemAligner(opt, idx, fm=fm, device=device), *no_native)
    real = loader.try_load
    loader.try_load = lambda: None
    try:
        got = sam(MemAligner(opt, idx, fm=fm, device=device), *no_native)
    finally:
        loader.try_load = real
    if got != want:
        raise SystemExit("the SAM without the native core differs")
    print(f"without the native core: SE {no_native[0]} reads + PE "
          f"{no_native[1]} pairs: SAM == the native route's "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    narrow = MemAligner(opt, idx, fm=fm, device=device)
    wide = MemAligner(opt, idx, fm=dataclasses.replace(fm, wide=True),
                      device=device)
    if (wide.align_batch(names[:n_wide], seqs[:n_wide])
            != narrow.align_batch(names[:n_wide], seqs[:n_wide])):
        raise SystemExit("the SAM on the index forced wide differs")
    print(f"index forced wide: {n_wide} reads: SAM == the narrow index's "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(counts, reads_per_s=rate)


def counted_cli(argv) -> int:
    """The CLI's main on argv, then this process's kernel launches on
    stderr (phase 14's hosts run it in their own processes)."""
    from bwamem_tpu_torch.cli import main

    rc = main(argv)
    print(f"launches {json.dumps(_counts())}", file=sys.stderr, flush=True)
    return rc


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _run_hosts(cmds: dict, cwd: str, env: dict, logdir: str,
               timeout: float) -> dict:
    """Start every command of cmds (key -> argv) at once and wait for all;
    stderr goes to a file each. Returns key -> (return code, seconds to
    its exit, stderr text); kills what is left on a timeout or error."""
    t0 = time.perf_counter()
    procs, ends, logs = {}, {}, {}
    try:
        for key, argv in cmds.items():
            logs[key] = open(os.path.join(logdir, f"host_{key}.err"), "w+")
            procs[key] = subprocess.Popen(argv, cwd=cwd, env=env,
                                          stdout=subprocess.DEVNULL,
                                          stderr=logs[key])
        while len(ends) < len(procs):
            if time.perf_counter() - t0 > timeout:
                raise SystemExit(f"hosts still running after {timeout} s")
            for key, p in procs.items():
                if key not in ends and p.poll() is not None:
                    ends[key] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for key, f in logs.items():
        f.seek(0)
        out[key] = (procs[key].returncode, ends[key], f.read())
        f.close()
    return out


def hosts_phase(d: str, device: str = "cuda", sizes=(1024, 512),
                timeout: float = 600) -> dict:
    """Phase 14: two hosts (`align --n-hosts 2 --host-id r --coordinator
    127.0.0.1:<port>`, two processes started together) on the first
    sizes[0] reads of reads.fq and, at the same time, two more on the
    first sizes[1] pairs with -I 350,50; on `device` and then with
    --device cpu. Each case's merged SAM (apart from @PG) must be the
    same on both, and the shard files gone. Prints how many records
    differ from a one-host run on the same reads (each host restarts the
    read counter that breaks score ties; no gate), and each host's kernel
    launches. Returns the hosts' reads/s on `device` for SE and PE (the
    reads over the seconds until the case's second host exited, the
    other case's hosts running beside them)."""
    from bwamem_tpu_torch.cli import main

    _head(os.path.join(d, "reads.fq"), os.path.join(d, "mh.fq"), sizes[0])
    _head(os.path.join(d, "r1.fq"), os.path.join(d, "mh1.fq"), sizes[1])
    _head(os.path.join(d, "r2.fq"), os.path.join(d, "mh2.fq"), sizes[1])
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    cases = {"se": (["mh.fq"], [], sizes[0]),
             "pe": (["mh1.fq", "mh2.fq"], ["-I", "350,50"], 2 * sizes[1])}
    rates, merged = {}, {}
    for dev in dict.fromkeys((device, "cpu")):
        cmds = {}
        for case, (files, flags, _) in cases.items():
            port = _free_port()
            for r in range(2):
                cmds[case, r] = [
                    sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                    "chip_smoke.counted_cli(sys.argv[1:]))", "align",
                    "--device", dev, "-t", "1", *flags,
                    os.path.join(d, "idx"),
                    *(os.path.join(d, f) for f in files), "-o",
                    os.path.join(d, f"hosts_{case}_{dev}.sam"), "--n-hosts",
                    "2", "--host-id", str(r), "--coordinator",
                    f"127.0.0.1:{port}"]
        # CPU hosts share the machine's cores rather than each spinning a
        # thread a core (GPU hosts leave the CPU to the one that runs)
        threads = max(1, (os.cpu_count() or len(cmds)) // len(cmds))
        res = _run_hosts(cmds, repo, dict(env, OMP_NUM_THREADS=str(threads))
                         if dev == "cpu" else env, d, timeout)
        for (case, r), (rc, _, err) in res.items():
            if rc != 0:
                raise SystemExit(f"host {r} ({case}, {dev}) exited {rc}:"
                                 f"\n{err[-2000:]}")
        for case, (_, _, n_reads) in cases.items():
            out = os.path.join(d, f"hosts_{case}_{dev}.sam")
            left = [f for f in os.listdir(d)
                    if f.startswith(os.path.basename(out) + ".shard")]
            if left:
                raise SystemExit(f"shard files left: {left}")
            merged[case, dev] = _records(out)
            n = sum(not ln.startswith("@") for ln in merged[case, dev])
            wall = max(res[case, r][1] for r in range(2))
            launches = [next((ln.split(" ", 1)[1]
                              for ln in res[case, r][2].splitlines()
                              if ln.startswith("launches ")), "?")
                        for r in range(2)]
            rates[case, dev] = n_reads / wall
            print(f"two hosts {case} --device {dev}: {n} records in "
                  f"{wall:.2f} s wall (two processes, start-up included, "
                  f"beside the other case's two) = {n_reads / wall:.1f} "
                  f"reads/s; launches per host {'; '.join(launches)}",
                  flush=True)
    for case, (files, flags, _) in cases.items():
        got, want = merged[case, device], merged[case, "cpu"]
        if got != want:
            bad = next((i for i, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            raise SystemExit(f"two hosts {case}: {device} and CPU SAM "
                             f"differ at line {bad}")
        one = os.path.join(d, f"one_{case}.sam")
        if main(["align", "--device", device, "-t", "1", *flags,
                 os.path.join(d, "idx"),
                 *(os.path.join(d, f) for f in files), "-o", one]) != 0:
            raise SystemExit(f"one-host {case} failed")
        a = [ln for ln in _records(one) if not ln.startswith("@")]
        b = [ln for ln in got if not ln.startswith("@")]
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(f"two hosts {case}: {device} SAM == CPU SAM; {diff} of "
              f"{len(a)} records differ from one host's (the read counter "
              f"restarts on each host)", flush=True)
    return {case: rates[case, device] for case in cases}


def seeding_phase(d: str, seed4, long_calls, step_calls, g_calls,
                  fastmap_calls, device: str = "cuda", timed: bool = True,
                  chunk_reads: int = CHUNK_READS) -> dict:
    """Phase 15, the seeding kernels against their plain versions: on the
    captured calls of phase 4's warm chunk (seed4: all its seeding calls),
    of phase 6's 1 kb chunk and of the fused step's 150 bp batch, then on
    phase 4's warm chunk again with the index without occ2 and with it
    forced wide, on -g's last chunk (phase 9: S1 without round 3, S4) and
    on a 512-read fastmap call (phase 10, its second)
    (seed_kernel_phase: the final seeds against the plain route, each call
    against its plain version); then phase 4's warm chunk of the aligner
    (reads chunk_reads .. 2 chunk_reads - 1 of reads.fq) on the kernels
    and on the plain route under torch.profiler, in a fresh process
    (fresh_seed_profile). Returns the records of seed_kernel_phase and
    the profile (key "profile")."""
    import dataclasses

    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.ops.seeding import SeedConfig

    def ctx(label, calls, cfg, fm=None, replay=True):
        fwd = calls[0][1]
        return (label, fm or fwd[0], cfg, fwd[1], fwd[2],
                calls if replay else None)

    warm = warm_chunk(seed4)
    fm4 = warm[0][1][0]
    idx = FMIndex.load(os.path.join(d, "idx.bmt"))
    full = SeedConfig(reseed=True)
    contexts = [
        ctx("phase 4 warm chunk", warm, full),
        ctx("phase 6 1 kb chunk", warm_chunk(long_calls), full),
        ctx("fused step 150 bp", warm_chunk(step_calls), SeedConfig()),
        ctx("phase 4 warm chunk, index without occ2", warm, full,
            DeviceFMIndex.from_host(idx, device, occ2=False), False),
        ctx("phase 4 warm chunk, index forced wide", warm, full,
            dataclasses.replace(fm4, wide=True), False),
        ctx("phase 9 -g chunk", warm_chunk(g_calls), SeedConfig(mode="mem")),
        # a fastmap call seeds with three calls (S1, S2, S4): its second
        ctx("phase 10 fastmap call", warm_chunk(fastmap_calls[:6]),
            SeedConfig())]
    out = seed_kernel_phase(contexts, timed)
    out["profile"] = fresh_seed_profile(d, chunk_reads, device)
    return out


def warm_chunk_profile(d: str, chunk_reads: int, device: str) -> dict:
    """seed_profile of phase 4's warm chunk (reads chunk_reads .. 2
    chunk_reads - 1 of reads.fq) on the index in d."""
    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.index.format import FMIndex

    idx = FMIndex.load(os.path.join(d, "idx.bmt"))
    _, seqs = _batch(os.path.join(d, "reads.fq"), 2 * chunk_reads)
    return seed_profile(DeviceFMIndex.from_host(idx, device), idx,
                        seqs[chunk_reads:], device)


def fresh_seed_profile(d: str, chunk_reads: int, device: str,
                       timeout: int = 600) -> dict:
    """warm_chunk_profile in a process of its own, its lines passed on:
    late in this script torch.profiler has recorded none of the seeding
    kernels (cause unknown), while a fresh process records them. The
    process runs as many intra-op threads as this one (a process beside
    busy ones must not start torch's full pool)."""
    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    threads = str(torch.get_num_threads())
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke; print("
         "'PROFILE ' + json.dumps(chip_smoke.warm_chunk_profile("
         "sys.argv[1], int(sys.argv[2]), sys.argv[3])))", d,
         str(chunk_reads), device], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS=threads,
                 MKL_NUM_THREADS=threads), capture_output=True,
        text=True, timeout=timeout)
    lines = res.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if res.returncode != 0 or not lines[-1:] or not lines[-1].startswith(
            "PROFILE "):
        raise RuntimeError(f"seed profile exited {res.returncode}:\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(lines[-1][len("PROFILE "):])


# phase 16: the finalize's cases on the world of phases 3-8, (tag, reads
# files, flags, -K bases or None for the default): SE 150 (phase 4's
# chunks), PE 150 (phase 5's), PE 2 x 250, phase 6's 1 kb reads,
# -x pacbio's noisy 1 kb reads, and -a / -a -M on heads of the 150 bp reads
FINALIZE_CASES = (
    ("se150", ("reads.fq",), (), CHUNK_READS * READ_LEN),
    ("pe150", ("r1.fq", "r2.fq"), (), CHUNK_PAIRS * 2 * READ_LEN),
    ("pe250", ("p250r1.fq", "p250r2.fq"), (), None),
    ("1kb", ("long.fq",), (), None),
    ("pacbio", ("pb.fq",), ("-x", "pacbio"), None),
    ("se150 -a", ("fin_a.fq",), ("-a",), None),
    ("pe150 -a -M", ("fin_a1.fq", "fin_a2.fq"), ("-a", "-M"), None))
# phase 16: pairs of 2 x 250 (insert N(550, 100), at least 300; no
# victims), and the heads -a and -a -M run on
FIN_SIZES = dict(pe250=8192, se_a=4096, pe_a=4096)
# the captured K5 calls replayed against the plain version (largest
# call of the case), and how many of its jobs the plain version solves
K5_REPLAY = {"se150": 2000, "pe250": 1000, "1kb": 150, "pacbio": 60}
K5_OPS_UNGAPPED = 2   # gen_cigar's ungapped call: a score and an add a base


@contextmanager
def capture_finalize(split: bool = True):
    """Inside the block, `align` finalizes through the split finalize
    (`split`: pipeline/finalize.route as it is, its DeviceFinalize objects
    recorded) or the native one (route patched to None: HostPool's
    emitters, the finalize before K5). K5's calls (cigar_kernel.solve,
    which the split finalize calls through the module attribute) are
    recorded as (args, kwargs). Yields (the DeviceFinalize objects, the
    K5 calls)."""
    from bwamem_tpu_torch.ops.kernels import cigar_kernel
    from bwamem_tpu_torch.pipeline import finalize

    route, solve = finalize.route, cigar_kernel.solve
    made, calls = [], []

    def routed(aligner, pool, timings=None):
        if not split:
            return None
        df = route(aligner, pool, timings)
        if df is not None:
            made.append(df)
        return df

    def solved(*args, **kw):
        calls.append((args, kw))
        return solve(*args, **kw)

    finalize.route, cigar_kernel.solve = routed, solved
    try:
        yield made, calls
    finally:
        finalize.route, cigar_kernel.solve = route, solve


def _k5_cells(desc, passes, glob):
    """Live band cells of the passes each job runs (`passes` (N, 3)
    bool): a DP pass at band b (widened to |rlen - lq|) fills, in each of
    its rlen rows, the columns max(0, i - w) .. min(lq, i + w + 1); an
    ungapped pass (b < 0) reads lq bases. The jobs in `glob` write each
    pass's traceback to global scratch, 16 bytes a row for every 32
    columns of the band. Returns (DP cells, ungapped bases, scratch
    bytes written)."""
    import numpy as np

    d = np.asarray(desc, np.int64)
    lq, rlen = d[:, 0], d[:, 1]
    dlen = np.abs(rlen - lq)
    dp = flat = scratch = 0
    for c in range(3):
        b = d[:, 4 + c]
        on = passes[:, c]
        flat += int(lq[on & (b < 0)].sum())
        g = on & glob & (b >= 0)
        ncol = np.minimum(lq[g], 2 * np.maximum(b[g], dlen[g]) + 1)
        scratch += int((rlen[g] * ((ncol + 31) // 32) * 16).sum())
        sel = np.flatnonzero(on & (b >= 0))
        for lo in range(0, len(sel), 4096):
            k = sel[lo:lo + 4096]
            w = np.maximum(b[k], dlen[k])[:, None]
            i = np.arange(int(rlen[k].max()) if len(k) else 0)[None]
            cols = (np.minimum(i + w + 1, lq[k][:, None])
                    - np.maximum(i - w, 0)).clip(min=0)
            dp += int(np.where(i < rlen[k][:, None], cols, 0).sum())
    return dp, flat, scratch


def _k5_passes(args, kw):
    """(N, 3) bool: the passes of the retry loop K5 runs for each job it
    takes, as its loop runs them (a band equal to the last ends the loop
    unrun; an equal score, the last band or a score at the threshold ends
    it after the pass). Each band's score comes from K5 on a copy of the
    jobs with that band as their only one (the same sizes, so the same
    launch plan)."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.ops.kernels import cigar_kernel

    desc = args[3]
    d = desc.cpu().numpy()
    N = len(d)
    nb, thr = d[:, 3].astype(np.int64), d[:, 2].astype(np.int64)
    scores = np.zeros((N, 3), np.int64)
    for c in range(3):
        one = d.copy()
        one[:, 3] = np.minimum(nb, 1)
        one[:, 4] = d[:, 4 + c]
        rows = cigar_kernel.solve(*args[:3], torch.from_numpy(one).to(
            desc.device), *args[4:], **kw)
        scores[:, c] = rows[:, 0].cpu().numpy()
    passes = np.zeros((N, 3), bool)
    done = ~cigar_kernel.takes(d)
    last = np.zeros(N, np.int64)
    for c in range(3):
        act = ~done & (nb > c)
        if c:
            rep = act & (d[:, 4 + c] == d[:, 3 + c])
            done |= rep
            act &= ~rep
        passes[:, c] = act
        sc = scores[:, c]
        stop = ((c > 0) & (sc == last)) | (nb - 1 == c) | (sc >= thr)
        done |= act & stop
        last = np.where(act, sc, last)
    return passes


def captured_k5(label: str, call, n_plain: int, timed: bool = True) -> dict:
    """K5 on the inputs of one captured main-path launch: every row of the
    launch against the plain version (solve_plain, on the CPU) on
    `n_plain` of its jobs (the widest bands and the most shared memory
    first, then an even spread), exact, then timed (median of 5, with the
    plain version's one run on those jobs; `timed` False skips it), with the
    jobs' share K5 takes and the bound: the live band cells of the passes
    it runs (_k5_passes, _k5_cells) at OPS_PER_CELL instructions a cell,
    against the query codes, the packed windows, the descriptors, the
    rows and the tracebacks written to global scratch once over HBM.
    Returns the record."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.ops.kernels import cigar_kernel as ck

    args, kw = call
    qs, qoff, rb, desc, pac, l_pac, mat, *gaps, plan = args
    d = desc.cpu().numpy()
    N = len(d)
    got = ck.solve(*args, **kw).cpu()
    width = np.maximum(d[:, 7], np.abs(d[:, 1] - d[:, 0]))
    first = np.lexsort((-ck.job_smem(d), -width))[:n_plain // 2]
    spread = np.linspace(0, N - 1, max(n_plain - len(first), 1)).astype(int)
    sel = torch.from_numpy(np.unique(np.concatenate([first, spread])))

    def plain():
        return ck.solve_plain(qs.cpu(), qoff.cpu()[sel], rb.cpu()[sel],
                              desc.cpu()[sel], pac.cpu(), l_pac, mat.cpu(),
                              *gaps, plan.cap)

    t0 = time.perf_counter()
    want = plain()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = (got[sel] != want).any(1).nonzero()[:, 0]
    if len(bad):
        k = int(sel[bad[0]])
        raise SystemExit(f"K5 != plain on the captured {label} launch: "
                         f"{len(bad)} of {len(sel)} rows differ, first job "
                         f"{k} desc {d[k].tolist()}: {got[k, :6].tolist()} "
                         f"vs {want[int(bad[0]), :6].tolist()}")
    ms = _median_ms(lambda: ck.solve(*args, **kw)) if timed else None
    plain_ms = plain_ms if timed else None
    take = plan.take
    glob = (np.zeros(N, bool) if plan.tboff is None else plan.tboff >= 0)
    dp, flat, scratch = _k5_cells(d, _k5_passes(args, kw), glob)
    ops = dp * OPS_PER_CELL + flat * K5_OPS_UNGAPPED
    nbytes = (qs.numel() + int(((d[take, 1] + 15) // 16 * 4).sum())
              + N * (ck.DESC * 4 + 16 + got.shape[1] * 4)
              + (0 if plan.tboff is None else 8 * N) + scratch)
    bound = _bound(nbytes, ops)
    solved = int((got[:, 1] >= 0).sum())
    print(f"K5 on the captured {label} launch: {N} jobs, qlen quartiles "
          + " / ".join(f"{x:g}" for x in np.percentile(d[:, 0], [25, 50, 75]))
          + f", taken {int(take.sum())} ({int(glob.sum())} with the "
          f"traceback in scratch, {len(plan.tiles)} launches), solved "
          f"{solved}; {len(sel)} rows == plain; live band cells {dp} (+ "
          f"{flat} ungapped), scratch written {scratch} B; kernel "
          f"{ms} ms, plain {plain_ms} ms on {len(sel)} jobs, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, jobs=N,
                plain_jobs=len(sel), solved=solved, scratch_jobs=int(
                    glob.sum()), **bound)


def finalize_phase(d: str, contigs, device: str = "cuda",
                   cases=FINALIZE_CASES, sizes=FIN_SIZES, replay=K5_REPLAY,
                   timed: bool = True) -> dict:
    """Phase 16 on the world of phases 3-8: each case (FINALIZE_CASES)
    through the CLI's `align -t 1` on `device` twice, with the split
    finalize (capture_finalize) and with the native finalize it replaces
    at `-t 1` on a card. The two SAMs must be byte-identical (apart from
    @PG), the split finalize must have been routed, and K5 must launch
    on the card where it took a job. Prints each run's finalize span (and
    cigar_device), the jobs K5 and the host solved and K5's launches; then
    K5 on the largest captured call of the cases in `replay` against the
    plain version (captured_k5). Returns {tag: the case's numbers} and
    {"k5 " + tag: the replay's record}."""
    import numpy as np

    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.ops.kernels import cigar_kernel

    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    make_pairs(d, g, sizes["pe250"], 2500, victim_every=1 << 30,
               read_len=250, insert=(550, 100, 300), tag="p250")
    _head(os.path.join(d, "reads.fq"), os.path.join(d, "fin_a.fq"),
          sizes["se_a"])
    for k in (1, 2):
        _head(os.path.join(d, f"r{k}.fq"), os.path.join(d, f"fin_a{k}.fq"),
              sizes["pe_a"])

    def align(tag, files, flags, kbases, split):
        label = f"fin_{tag.replace(' ', '')}_{'split' if split else 'native'}"
        out, tsv = (os.path.join(d, f"{label}.{x}") for x in ("sam", "tsv"))
        if os.path.exists(tsv):  # the CLI appends
            os.remove(tsv)
        argv = ["align", "--device", device, "-t", "1", "-f", tsv, *flags,
                *(["-K", str(kbases)] if kbases else []),
                os.path.join(d, "idx"), *(os.path.join(d, f) for f in files),
                "-o", out]
        cigar_kernel.LAUNCHES = 0
        with capture_finalize(split) as (made, calls):
            if main(argv) != 0:
                raise SystemExit(f"phase 16 {tag}: align failed")
        return (_records(out), _timing_row(tsv), made, calls,
                cigar_kernel.LAUNCHES)

    out, biggest = {}, {}
    for tag, files, flags, kbases in cases:
        recs, row, made, calls, k5 = align(tag, files, flags, kbases, True)
        want, nrow, _, ncalls, _ = align(tag, files, flags, kbases, False)
        if not made or ncalls:
            raise SystemExit(f"phase 16 {tag}: the split finalize was "
                             f"{'not ' if not made else ''}routed")
        if recs != want:
            bad = next((i for i, (a, b) in enumerate(zip(recs, want))
                        if a != b), min(len(recs), len(want)))
            raise SystemExit(f"phase 16 {tag}: split and native SAM differ "
                             f"at line {bad}:\n{recs[bad:bad + 1]}\n"
                             f"{want[bad:bad + 1]}")
        jobs = sum(m.stats["cigar_jobs"] for m in made)
        host = sum(m.stats["cigar_host_jobs"] for m in made)
        if device == "cuda" and jobs and k5 < 1:
            raise SystemExit(f"phase 16 {tag}: K5 took {jobs} jobs without "
                             f"a launch")
        n = sum(not ln.startswith("@") for ln in recs)
        out[tag] = dict(
            finalize_s=float(row["finalize"]),
            native_finalize_s=float(nrow["finalize"]),
            cigar_device_s=float(row.get("cigar_device", 0.0)),
            cigar_jobs=jobs, cigar_host_jobs=host, K5=k5, records=n)
        print(f"phase 16 {tag} ({' '.join(flags) or 'default flags'}): "
              f"split SAM == native SAM ({n} records); finalize "
              f"{row['finalize']} s (cigar_device "
              f"{row.get('cigar_device')} s) vs native {nrow['finalize']} "
              f"s; cigar_jobs {jobs}, cigar_host_jobs {host} "
              f"({jobs / max(jobs + host, 1):.4%} on K5); K5 launches {k5}",
              flush=True)
        if tag in replay and calls:
            biggest[tag] = max(calls, key=lambda c: c[0][3].shape[0])
    for tag, call in biggest.items():
        out["k5 " + tag] = captured_k5(tag, call, replay[tag], timed)
    return out


def build_kernels():
    """Build K1, K2, K3, K4, K5 and the seeding kernels' three libraries at
    once (one nvcc each) and print each build's register and spill
    report."""
    from concurrent.futures import ThreadPoolExecutor

    from bwamem_tpu_torch.ops.kernels import (cigar_kernel, extend_banded,
                                              extend_kernel, int16_probe,
                                              seed_kernels, swalign_kernel)

    mods = {"K1": extend_kernel, "K2": swalign_kernel, "K3": extend_banded,
            "K4": int16_probe, "K5": cigar_kernel}
    with ThreadPoolExecutor(len(mods) + len(seed_kernels.SOURCES)) as ex:
        futs = {k: ex.submit(m.build) for k, m in mods.items()}
        futs.update({k: ex.submit(seed_kernels.build, k)
                     for k in seed_kernels.SOURCES})
        secs = {k: f.result() for k, f in futs.items()}
    logs = {k: m.BUILD_LOG for k, m in mods.items()}
    logs.update(seed_kernels.BUILD_LOG)
    for k, log in logs.items():
        print(f"{k} built in {secs[k]:.1f} s", flush=True)
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  " + ln.strip(), flush=True)


def _widest(calls):
    """The captured K1 call with the widest rows (largest QMAX)."""
    return max(calls, key=lambda c: c[0].shape[1])


def _largest(calls):
    """The captured call with the most jobs."""
    return max(calls, key=lambda c: c[0].shape[0])


def new_path_phases(d: str, t12: float, device: str = "cuda",
                    sizes=(16384, 4096), heads=(1024, 128),
                    mesh_sizes=((4096, 2048), (256, 128), 1024),
                    host_sizes=(1024, 512), n_chips: int = 0) -> dict:
    """Phases 12-14 on the world of phases 3-6 (the phase 12 header is
    printed by the caller at t12): the fused step on the first sizes[0]
    reads of reads.fq (150 bp: K1) and sizes[1] of long.fq (1 kb: K3),
    the mesh (of n_chips devices, 0: every visible card), and two hosts.
    Prints each phase's seconds. Returns the
    fused step's, the mesh's and the hosts' counts and reads/s."""
    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.index.format import FMIndex

    idx = FMIndex.load(os.path.join(d, "idx.bmt"))
    fms = {device: DeviceFMIndex.from_host(idx, device)}
    fms["cpu"] = (fms[device] if device == "cpu"
                  else DeviceFMIndex.from_host(idx, "cpu"))
    print(f"device indexes built in {time.perf_counter() - t12:.1f} s",
          flush=True)
    names, seqs = _batch(os.path.join(d, "reads.fq"), sizes[0])
    truth = {n: (int(n.split("_")[1]), int(n.split("_")[2])) for n in names}
    out = {"step_150": fused_step_phase(fms, "150 bp", names, seqs, truth,
                                        "K1", "K3", heads, device)}
    names, seqs = _batch(os.path.join(d, "long.fq"), sizes[1])
    with open(os.path.join(d, "long.truth")) as f:
        truth = {n: (int(p), int(s)) for n, p, s in
                 (ln.split() for ln in f)}
    out["step_1kb"] = fused_step_phase(fms, "1 kb", names, seqs, truth,
                                       "K3", None, heads, device)
    print(f"phase 12 took {time.perf_counter() - t12:.1f} s", flush=True)

    phase("13 the mesh")
    t0 = time.perf_counter()
    out["mesh"] = mesh_phase(d, fms[device], device, n_chips,
                             sizes=mesh_sizes[0],
                             step_reads=sizes[0], no_native=mesh_sizes[1],
                             n_wide=mesh_sizes[2])
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("14 two hosts")
    t0 = time.perf_counter()
    out["hosts"] = hosts_phase(d, device, host_sizes)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
        seed4 = []
        launches, _, calls = align_phase(d, seed_calls=seed4)
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
        variants = variant_phases(d)

        phase("10 fastmap")
        _, fastmap_calls = fastmap_phase(d)

        phase("11 the 16-bit probe")
        probe_launches = probe_phase()

        phase("12 the fused step")
        paths = new_path_phases(d, time.perf_counter())

        phase("15 seeding kernels vs plain")
        t0 = time.perf_counter()
        seeding = seeding_phase(d, seed4, runs["long"]["seed_calls"],
                                paths["step_150"]["seed_calls"],
                                variants["g"]["seed_calls"], fastmap_calls)
        print(f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)

        phase("16 the finalize: split (K5) vs native")
        t0 = time.perf_counter()
        fin = finalize_phase(d, contigs)
        print(f"phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)

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
             launches=probe_launches, **k4)] + [
        dict(name=f"cigar_solve_{tag}", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/cigar_kernel.cu", replaces=None,
             launches=fin[tag]["K5"], **fin["k5 " + tag])
        for tag in K5_REPLAY if "k5 " + tag in fin] + [
        dict(name=name, route="cuda", library_ms=None,
             source=SEED_KERNELS[name][1], replaces=SEED_KERNELS[name][0],
             launches=SEED_LAUNCHES["4"][name],
             launches_by_phase={t: c[name] for t, c in SEED_LAUNCHES.items()},
             **seeding["phase 4 warm chunk", name, 0])
        for name in SEED_KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
