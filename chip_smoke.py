"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the extension kernel from csrc/ with nvcc;
  2. the kernel against its plain PyTorch version on the card at the main
     path's shapes (QMAX 192, TMAX 384, 32768 jobs + edge lanes), all four
     (opt_ext, zdrop) variants, exact equality; median of 5 timed runs;
  3. build the world: a 4.6 Mbp repeat-rich simulated genome (fixed seed),
     indexed with `python -m bwamem_tpu_torch index -r 4`;
  4. align 32768 simulated 150 bp SE reads (1% substitutions, two chunks of
     16384) through the CLI entry point with --device cuda, counting kernel
     launches; then the first 1024 reads with --device cpu, whose SAM must
     be byte-identical to the GPU run's (apart from @PG).
Then one JSON line per the kernels, and the device JSON as the last line.
Needs one CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import json
import os
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


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_info() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def make_jobs(rng, N, QMAX, TMAX):
    """Extension jobs shaped like the main path's: the target is the query
    followed by random bases, with 2% substitutions and 1% N bases; h0 is
    a seed score; edge lanes: tlen 0, qlen 1, large h0, full-width lanes."""
    import numpy as np

    q = rng.integers(0, 4, (N, QMAX)).astype(np.int8)
    t = np.concatenate(
        [q, rng.integers(0, 4, (N, TMAX - QMAX)).astype(np.int8)], axis=1)
    mut = rng.random((N, TMAX)) < 0.02
    t[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((N, QMAX)) < 0.01] = 4
    ql = rng.integers(1, QMAX + 1, N).astype(np.int32)
    tl = np.minimum(ql + rng.integers(0, 160, N), TMAX).astype(np.int32)
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


def kernel_phase(device: str = "cuda", shapes=None, timed: bool = True):
    """Kernel vs plain version on `device` for all four variants. Returns
    the product variant's record (times in ms; None when not timed)."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.ops.extend import ExtendParams, make_score_matrix
    from bwamem_tpu_torch.ops.kernels import extend_kernel

    shapes = shapes or KERNEL_SHAPES
    rng = np.random.default_rng(2024)
    arrays = make_jobs(rng, shapes["N"], shapes["QMAX"], shapes["TMAX"])
    args = [torch.from_numpy(a).to(device)
            for a in (*arrays, make_score_matrix(1, 4))]
    product = None
    for opt_ext, zdrop in VARIANTS:
        p = ExtendParams(w=100 if opt_ext else 300, zdrop=zdrop,
                         opt_ext=opt_ext)
        want = extend_kernel.extend_batch_plain(*args, p)
        got = extend_kernel.extend_batch(*args, p)
        if device == "cuda":
            torch.cuda.synchronize()
        err = max(int((got[k].long() - want[k].long()).abs().max())
                  for k in want)
        if err != 0:
            raise SystemExit(f"kernel != plain for opt_ext={opt_ext} "
                             f"zdrop={zdrop}: max abs err {err}")
        ms = plain_ms = None
        if timed:
            ms = _median_ms(lambda: extend_kernel.extend_batch(*args, p))
            plain_ms = _median_ms(
                lambda: extend_kernel.extend_batch_plain(*args, p))
        print(f"K1 extend_dense opt_ext={int(opt_ext)} zdrop={zdrop}: exact "
              f"on {shapes['N']} jobs; kernel {ms} ms, plain {plain_ms} ms",
              flush=True)
        if (opt_ext, zdrop) == (False, 0):  # the product defaults
            product = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return product


def make_world(d: str, genome_len: int = GENOME_LEN, n_reads: int = N_READS,
               seed: int = 12345):
    """Repeat-rich genome -> ref.fa; SE reads -> reads.fq (names carry the
    simulated origin) and head.fq (the first N_COMPARE reads)."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import bwamem_tpu_torch  # noqa: F401  (fails outside the repo)
    from bwamem_tpu_torch.ops.kernels import extend_kernel

    phase("0 card")
    card = card_info()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("1 build")
    secs = extend_kernel.build()
    print(f"K1 built in {secs:.1f} s", flush=True)
    for ln in extend_kernel.BUILD_LOG.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  " + ln.strip(), flush=True)

    phase("2 kernel vs plain")
    k1 = kernel_phase("cuda")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        phase("3 world")
        t0 = time.perf_counter()
        make_world(d)
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

    print(json.dumps({"kernels": [dict(
        name="extend_dense", route="cuda",
        source="bwamem_tpu_torch/csrc/extend_kernel.cu",
        replaces="bwamem_tpu/ops/pallas/extend_kernel.py:265",
        launches=launches, **k1)]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
