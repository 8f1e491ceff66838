"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the three kernels from csrc/ with nvcc, in parallel: K1 (dense
     extension), K2 (local SW) and K3 (banded extension);
  2. each kernel against its plain PyTorch version on the card at the main
     paths' shapes, exact equality, median of 5 timed runs, with the bound
     (the larger of bytes over HBM bandwidth and int32 operations over the
     int32 rate, for the rows these inputs run):
     K1 at QMAX 192, TMAX 384, 32768 jobs + edge lanes, all four
     (opt_ext, zdrop) variants, and on its wide route at QMAX 1024,
     TMAX 2048, 4096 jobs, all four variants; K1 at the -x pacbio object
     path's three buckets (QMAX 64, 192 and 1024 against TMAX 1024, 768
     and 2048, 4096 jobs each) with its scoring (-B 1, -O 1, -E 1, no
     clipping bonus); K2 at QMAX 192, TMAX 768, 4096 jobs + edge lanes,
     rev_skip 0/19 x minsc 0/19 (the plain version timed on the
     main-path variant, rev_skip 19 and minsc 19, only), and at the seed
     filter's 200 x 200 windows with rev_skip 0 and minsc 0, 65536 jobs
     at the default scoring and 20480 at -x pacbio's; K3 at QMAX 256,
     TMAX 384, w=100, 32768 jobs + edge lanes, zdrop 0 and 100, and at
     QMAX 1024, TMAX 1536, w=300, 4096 jobs;
  3. build the world: a 4.6 Mbp repeat-rich simulated genome (fixed seed),
     indexed with `python -m bwamem_tpu_torch index -r 4`; 32768 SE reads
     and 16384 FR pairs (insert max(260, N(350, 50)), 1% of the pairs with
     an unseedable read 2), all 150 bp with 1% substitutions;
  4. align the SE reads (two chunks of 16384) through the CLI entry point
     with --device cuda, counting K1 launches; then the first 1024 reads
     with --device cpu, whose SAM must be byte-identical to the GPU run's
     (apart from @PG);
  5. align the pairs from two files (two chunks of 8192 pairs) through the
     CLI entry point with --device cuda, counting K1 and K2 launches; then
     the first 1024 pairs on the GPU and with --device cpu, whose SAM must
     be byte-identical (apart from @PG);
  6. 4096 SE reads of 1 kb (utils/simgenome.simulate_reads: 1%
     substitutions, 0.2% insertions, 0.2% deletions) at the default
     flags in one chunk: the per-seed SW filter
     on K2, the extension on K1's wide route;
  7. 16384 SE reads of 250 bp (1% substitutions) under --vanilla: the
     extension on K3;
  8. -F on the first 16384 reads of phase 4, then -x pacbio on 1024 reads
     of 1 kb with 4% substitutions, 3% insertions and 3% deletions (the
     per-seed-object path: K2 for the SW filter, K1 for the extension).
     Phases 6-8 count every kernel's launches around the device run, print
     reads/s and the spans, and hold the device SAM of the first 128,
     1024, 1024 and 64 reads byte-identical to --device cpu.
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

GENOME_LEN = 4_600_000
N_READS = 32_768
CHUNK_READS = 16_384
READ_LEN = 150
N_COMPARE = 1024
KERNEL_SHAPES = dict(N=32_768, QMAX=192, TMAX=384)
VARIANTS = [(False, 0), (False, 100), (True, 0), (True, 100)]
WIDE_SHAPES = dict(N=4096, QMAX=1024, TMAX=2048)  # K1's wide route: 1 kb
K3_SHAPES = dict(N=32_768, QMAX=256, TMAX=384)  # --vanilla, 250 bp reads
K3_VARIANTS = [(100, 0), (100, 100)]  # (w, zdrop); --vanilla keeps -d 0
K3_WIDE_SHAPES = dict(N=4096, QMAX=1024, TMAX=1536)
# the card's rates for the bound: HBM3 bandwidth, and int32 issue of 132
# SMs x 64 INT32 lanes x 1.98 GHz (H100 SXM)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_CELL = 12  # int32 operations of one DP cell (M, E, F, H, row max)
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


def _median_ms(fn, reps=5):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM bandwidth
    and the int32 operations over the card's int32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _ext_bound(args, rows, opt_ext: bool, w: int) -> dict:
    """K1/K3 bound on these inputs: every row an alignment ran (`rows`,
    from the plain version) costs OPS_PER_CELL operations per live column
    (qlen + 1 columns, or the band's 2w + 2 when it is narrower)."""
    q, t, ql = args[0], args[1], args[2]
    cols = ql.long().clamp(max=q.shape[1]) + 1
    if opt_ext:
        cols = cols.clamp(max=2 * w + 2)
    cells = int((rows.long() * cols).sum())
    nbytes = q.numel() + t.numel() + 3 * 4 * len(ql) + 100 + 6 * 4 * len(ql)
    return _bound(nbytes, OPS_PER_CELL * cells)


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
        bound = _ext_bound(args, want["rows"], p.opt_ext, p.w)
        print(f"{name} {var} QMAX {shapes['QMAX']} TMAX {shapes['TMAX']}: "
              f"exact on {shapes['N']} jobs; kernel {ms} ms, plain "
              f"{plain_ms} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        if var == product:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)
    return rec


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
        # forward sweep over every row and query column, reverse sweep
        # over q[qe..0] x t[te..0] where it runs
        fwd = (torch.from_numpy(tl).clamp(max=t.shape[1]).long()
               * torch.from_numpy(ql).clamp(0, q.shape[1]).long()).sum()
        best, _, qe, _, te, _ = want.long().cpu()
        rev = torch.where(best >= max(rev_skip, 1),
                          (te + 1).clamp(min=0) * (qe + 1).clamp(min=0), 0)
        bound = _bound(q.size + t.size + 3 * 4 * len(ql) + 100
                       + 6 * 4 * len(ql),
                       OPS_PER_CELL * int(fwd + rev.sum()))
        print(f"K2 swalign_local {label} QMAX {shapes['QMAX']} TMAX "
              f"{shapes['TMAX']} rev_skip={rev_skip} minsc={minsc}: exact "
              f"on {shapes['N']} jobs ({hits} with score >= 19); kernel "
              f"{ms} ms, plain {plain_ms} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})",
              flush=True)
        if (rev_skip, minsc) == product:
            main_rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            **bound)
    return main_rec


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
    with the kernel's launch count reset just before and read just after.
    Then the first N_COMPARE reads on the CPU. Returns the launch count."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.ops.kernels import extend_kernel

    idx = os.path.join(d, "idx")
    out = os.path.join(d, f"{device}.sam")
    argv = ["align", "--device", device, "-t", "1", "-K",
            str(chunk_reads * READ_LEN), idx, os.path.join(d, "reads.fq"),
            "-o", out]
    extend_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
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
    print(f"align --device {device}: {n} reads in {wall:.2f} s wall "
          f"(index load + setup included) = {n / wall:.1f} reads/s; "
          f"mapped {mapped / n:.4f}; at simulated origin {placed / n:.4f}; "
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
    return launches, n / wall


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
    and read just after. Then the head pairs on `device` and on the CPU,
    with the same flags and -K, must give the same SAM. Returns
    (K1 launches, K2 launches, pairs/s)."""
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
          f"{row.get('pe_rescue_sw')} s, finalize {row.get('finalize')} s; "
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
    return k1, k2, n_pairs / wall


def _head(src: str, dst: str, n: int) -> None:
    """The first n FASTQ records of src into dst."""
    with open(src) as f:
        lines = [ln for _, ln in zip(range(4 * n), f)]
    with open(dst, "w") as f:
        f.writelines(lines)


def flag_phase(d: str, tag: str, reads: str, n_head: int, flags: list,
               need: tuple, device: str = "cuda") -> dict:
    """A further main path: SE `align` of `reads` with `flags` through the
    CLI entry point on `device`, every kernel's launch count reset just
    before and read just after; kernels in `need` must have launched. Then
    the first n_head reads with --device cpu, whose SAM must be
    byte-identical to the device run's records of those reads. Returns
    the launch counts (K1, K1 wide route, K2, K3) and reads/s."""
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
    return dict(counts, reads_per_s=n / wall)


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
                             ("K1", "K1_wide", "K2"), device)
    phase("7 --vanilla (250 bp)")
    out["vanilla"] = flag_phase(d, "vanilla", "r250.fq", heads[1],
                                ["--vanilla"], ("K3",), device)
    phase("8 filters: -F (150 bp), -x pacbio (1 kb)")
    out["shd"] = flag_phase(d, "shd", "shd.fq", heads[2], ["-F"], ("K1",),
                            device)
    out["pacbio"] = flag_phase(d, "pacbio", "pb.fq", heads[3],
                               ["-x", "pacbio"], ("K1", "K2"), device)
    return out


def build_kernels():
    """Build K1, K2 and K3 at once (one nvcc each) and print each build's
    register and spill report."""
    from concurrent.futures import ThreadPoolExecutor

    from bwamem_tpu_torch.ops.kernels import (extend_banded, extend_kernel,
                                              swalign_kernel)

    mods = {"K1": extend_kernel, "K2": swalign_kernel, "K3": extend_banded}
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {k: ex.submit(m.build) for k, m in mods.items()}
        secs = {k: f.result() for k, f in futs.items()}
    for k, m in mods.items():
        print(f"{k} built in {secs[k]:.1f} s", flush=True)
        for ln in m.BUILD_LOG.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  " + ln.strip(), flush=True)


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
    k1_wide = kernel_phase("cuda", WIDE_SHAPES)
    k2_flt = sw_kernel_phase("cuda", FILTER_SHAPES, variants=[(0, 0)],
                             product=(0, 0), jobs=make_filter_jobs,
                             label="seed filter")
    sw_kernel_phase("cuda", FILTER_PB_SHAPES, variants=[(0, 0)],
                    product=(0, 0), jobs=make_filter_jobs, scoring=PACBIO,
                    label="seed filter -x pacbio")
    k1_pb = [kernel_phase("cuda", sh, variants=[(False, 0)], scoring=PACBIO)
             for sh in PB_SHAPES]
    k3 = kernel_phase("cuda", K3_SHAPES, kernel="K3", variants=K3_VARIANTS)
    kernel_phase("cuda", K3_WIDE_SHAPES, kernel="K3", variants=[(300, 0)])

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
        launches, _ = align_phase(d)

        phase("5 paired-end align")
        _, sw_launches, _ = pe_align_phase(d)

        runs = long_read_phases(d, contigs)

    print(json.dumps({"kernels": [
        dict(name="extend_dense", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=launches, **k1),
        dict(name="swalign_local", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=sw_launches, **k2),
        dict(name="extend_dense_wide", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=runs["long"]["K1_wide"], **k1_wide),
        dict(name="extend_dense_pacbio", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
             launches=runs["pacbio"]["K1"], **k1_pb[0]),
        dict(name="swalign_local_seedflt", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/swalign_kernel.cu",
             replaces="bwamem_tpu/ops/pallas/swalign_kernel.py:173",
             launches=runs["long"]["K2"], **k2_flt),
        dict(name="extend_banded", route="cuda", library_ms=None,
             source="bwamem_tpu_torch/csrc/extend_banded.cu",
             replaces="bwamem_tpu/ops/pallas/extend_banded.py:241",
             launches=runs["vanilla"]["K3"], **k3)]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
