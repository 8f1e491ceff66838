"""The seeding kernels S1-S4 of this tree against another tree's, on one
card, on one world, in one run.

    python3 seed_bench.py [--against DIR ...] [--rounds 2] [--out FILE]

Builds chip_smoke.py's world once (its 4.6 Mbp repeat-rich genome, seed
12345, indexed with `index -r 4`; the second 16384 of its 150 bp reads,
phase 4's warm chunk, and phase 6's 4096 reads of 1 kb), then runs one
process per variant, the variants in turns (--rounds times, every other
round in reverse order): this tree, and each tree at DIR (a checkout of
another commit, or a copy with its kernels edited: its bwamem_tpu_torch/
and chip_smoke.py).
Each process imports bwamem_tpu_torch and chip_smoke from its variant's
tree and, on each context below, holds smem_seed_batch's final seeds to
the plain route (chip_smoke.seed_route_check) and every kernel call to
its plain version by the kernel's rule (chip_smoke.check_seed_call), then
times each call twice: CUDA events around a wrapper call
(chip_smoke._median_ms, median of 5; the host's work in the wrapper
included) and the device time torch.profiler records for a call
(chip_smoke._device_ms, over 20 calls).

Contexts: phase 4's warm chunk (16384 x 160, the re-seed rounds on: S1
with round 3, S2 twice, S3, S4); 1 kb (4096 x 1024, the same rounds);
the step (16384 x 160, round 1 alone: S1 without round 3); fastmap (its
first 512 reads, round 1 alone); and phase 4's warm chunk on the index
without occ2 and forced wide. In each context one more record,
"expand": the occurrence expansion as the tree's smem_seed_batch runs
it, on the SMEMs of that call (a tree whose S4 takes BWT rows runs
ops/seeding._expand_occurrences, its torch ops around S4; one whose S4
takes the SMEMs runs S4 alone), timed both ways, with the device ops
(kernels and copies) of one call.

Prints the card's name and power limit, one line a call and variant, and
writes every record as JSON to --out. Needs a CUDA card (--device cpu
rehearses the same steps on the plain versions, at the sizes given).
Exits 1 if a variant fails.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONTEXTS = ("phase 4 warm chunk", "1 kb", "step", "fastmap 512",
            "no occ2", "wide")


def make_world(d: Path, genome_len: int, n150: int, n1k: int) -> None:
    """chip_smoke's genome and reads (make_world; long_read_phases' 1 kb
    reads), the index built by this tree's CLI, the reads as (B, L) int8
    codes with their lengths in reads.npz."""
    import numpy as np

    import chip_smoke
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import simulate_reads

    contigs = chip_smoke.make_world(str(d), genome_len, 2 * n150,
                                    n_pairs=0)
    subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index", "-r",
                    "4", str(d / "ref.fa"), "-p", str(d / "idx")],
                   check=True, timeout=1800, cwd=ROOT)

    def pack(seqs):  # the aligner's seeding shape
        return (t.numpy() for t in chip_smoke._reads_tensors(seqs, "cpu"))

    _, seqs = chip_smoke._batch(str(d / "reads.fq"), 2 * n150)
    r150, l150 = pack(seqs[n150:])
    rng = np.random.default_rng(7)  # phase 6's reads (long_read_phases)
    long = simulate_reads(rng, contigs, n1k, read_len=1000, sub=0.01,
                          ins=0.002, dele=0.002, prefix="long")
    r1k, l1k = pack([_CODE_LUT[np.frombuffer(r.seq.encode(), np.uint8)]
                     for r in long])
    np.savez(d / "reads.npz", r150=r150, l150=l150, r1k=r1k, l1k=l1k)


def expansion(f, reads, lens, cfg):
    """The occurrence expansion of smem_seed_batch(f, reads, lens, cfg) as
    this process's tree runs it: (the function, its arguments from one
    call). A tree whose seed_kernels.sa_lookup takes BWT rows expands in
    ops/seeding._expand_occurrences; one whose S4 takes the SMEMs in
    seed_kernels.sa_lookup."""
    import inspect

    from bwamem_tpu_torch.ops import seeding
    from bwamem_tpu_torch.ops.kernels import seed_kernels

    rows = len(inspect.signature(seed_kernels.sa_lookup).parameters) == 2
    mod, name = ((seeding, "_expand_occurrences") if rows
                 else (seed_kernels, "sa_lookup"))
    fn, got = getattr(mod, name), []

    def spy(*a):
        got.append(a)
        return fn(*a)

    setattr(mod, name, spy)
    try:
        seeding.smem_seed_batch(f, reads, lens, cfg)
    finally:
        setattr(mod, name, fn)
    return fn, got[-1]


def _device_ops(fn, inner=20) -> float:
    """Device ops (kernels and copies) torch.profiler records a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / inner


def worker(world: Path, device: str, reps: int) -> list:
    """The records of this process's tree (the first entry of sys.path)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import chip_smoke
    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.ops.kernels import seed_kernels
    from bwamem_tpu_torch.ops.seeding import SeedConfig

    if device == "cuda":
        with ThreadPoolExecutor(len(seed_kernels.SOURCES)) as ex:
            secs = dict(zip(seed_kernels.SOURCES, ex.map(
                seed_kernels.build, seed_kernels.SOURCES)))
        for name, log in seed_kernels.BUILD_LOG.items():
            print(f"{name} built in {secs[name]:.1f} s", flush=True)
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln:
                    print("  " + ln.strip(), flush=True)
    idx = FMIndex.load(str(world / "idx.bmt"))
    fm = DeviceFMIndex.from_host(idx, device)
    z = np.load(world / "reads.npz")
    r150 = (torch.from_numpy(z["r150"]).to(device),
            torch.from_numpy(z["l150"]).to(device))
    r1k = (torch.from_numpy(z["r1k"]).to(device),
           torch.from_numpy(z["l1k"]).to(device))
    full = SeedConfig(reseed=True)
    contexts = dict(zip(CONTEXTS, (
        (fm, full, r150), (fm, full, r1k), (fm, SeedConfig(), r150),
        (fm, SeedConfig(), tuple(x[:512] for x in r150)),
        (DeviceFMIndex.from_host(idx, device, occ2=False), full, r150),
        (dataclasses.replace(fm, wide=True), full, r150))))
    timer = chip_smoke._median_ms if device == "cuda" else _host_ms
    out = []
    for label, (f, cfg, (reads, lens)) in contexts.items():
        calls = chip_smoke.seed_route_check(label, f, reads, lens, cfg)
        seen: dict = {}
        for call in calls:
            name, args, kw = call[:3]
            i = seen[name] = seen.get(name, -1) + 1
            rec = chip_smoke.check_seed_call(f"{label} ({i})", call,
                                             timed=False)
            kern = getattr(seed_kernels, name)
            ms = timer(lambda: kern(*args, **kw), reps=reps)
            dev = (chip_smoke._device_ms(lambda: kern(*args, **kw))
                   if device == "cuda" else None)
            out.append(dict(context=label, kernel=name, call=i,
                            shape=list(args[1].shape), ms=ms, device_ms=dev,
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"]))
            print(f"  {label} {name} ({i}): {ms:.4f} ms, device {dev} ms",
                  flush=True)
        fn, a = expansion(f, reads, lens, cfg)
        ms = timer(lambda: fn(*a), reps=reps)
        dev, ops = ((chip_smoke._device_ms(lambda: fn(*a)),
                     _device_ops(lambda: fn(*a)))
                    if device == "cuda" else (None, None))
        out.append(dict(context=label, kernel="expand", call=0,
                        shape=list(a[1].shape), ms=ms, device_ms=dev,
                        device_ops=ops, bound_ms=0.0, bound_by="-"))
        print(f"  {label} expand: {ms:.4f} ms, device {dev} ms, {ops} "
              f"device ops a call", flush=True)
    return out


def _host_ms(fn, reps=5):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_variant(tag: str, root: Path, world: Path, args, log: Path | None):
    """One worker process on tree `root`; returns its records or None. Its
    output goes to `log` (else to stdout), but the build report."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           str(root), "--world", str(world), "--device", args.device,
           "--reps", str(args.reps)]
    print(f"== {tag} ({root})", flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=args.timeout, cwd=root)
    lines = res.stdout.strip().splitlines()
    if log is not None:
        with open(log, "a") as f:
            f.write(f"== {tag}\n{res.stdout}\n{res.stderr}\n")
    for ln in lines:
        if log is None or " built in " in ln or "registers" in ln:
            print(ln, flush=True)
    if res.returncode != 0 or not lines[-1:] or not lines[-1].startswith(
            "RECORDS "):
        sys.stdout.write(res.stderr[-6000:])
        print(f"{tag}: failed ({res.returncode})", flush=True)
        return None
    print(f"{tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    return json.loads(lines[-1][len("RECORDS "):])


def table(records, tags, key: str) -> None:
    """One line a kernel call: its shape, each variant's median `key` (ms:
    CUDA events around a wrapper call; device_ms: the profiler's device
    time of a call) over the rounds, and the bound."""
    import statistics

    rows: dict = {}
    for r in records:
        row = rows.setdefault((r["context"], r["kernel"], r["call"]), dict(
            shape=r["shape"], bound=r["bound_ms"], by=r["bound_by"], ms={}))
        if r.get(key) is not None:
            row["ms"].setdefault(r["variant"], []).append(r[key])
    print(f"{key}: context | kernel (call) | shape | " + " | ".join(tags)
          + " | bound ms", flush=True)
    for (ctx, name, i), row in rows.items():
        cells = [f"{statistics.median(row['ms'][t]):.4f}"
                 if t in row["ms"] else "-" for t in tags]
        print(f"{ctx} | {name} ({i}) | {'x'.join(map(str, row['shape']))} | "
              + " | ".join(cells) + f" | {row['bound']:.4f} {row['by']}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another tree's root (repeatable)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--long-reads", type=int, default=4096)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        sys.path.insert(0, str(a.worker))
        recs = worker(a.world, a.device, a.reps)
        print("RECORDS " + json.dumps(recs), flush=True)
        return 0
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("seed_bench: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_info() if a.device == "cuda" else "cpu"
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="seed_bench_"))
    try:
        world = tmp / "world"
        world.mkdir()
        t0 = time.perf_counter()
        make_world(world, a.genome_len, a.reads, a.long_reads)
        print(f"world built in {time.perf_counter() - t0:.1f} s", flush=True)
        variants = [("this tree", ROOT)] + [
            (f"against {tree.name}", tree.resolve()) for tree in a.against]
        log = a.out.with_suffix(".log") if a.out else None
        if log is not None:
            log.parent.mkdir(parents=True, exist_ok=True)
            log.write_text("")
        out, ok = [], True
        for rnd in range(a.rounds):
            for tag, root in (variants if rnd % 2 == 0
                              else variants[::-1]):
                recs = run_variant(tag, root, world, a, log)
                ok = ok and recs is not None
                out += [dict(r, variant=tag, round=rnd) for r in recs or []]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key in ("ms", "device_ms"):
        table(out, [v[0] for v in variants], key)
    if a.out:
        a.out.write_text(json.dumps(dict(card=card, records=out), indent=1))
    print(card, flush=True)
    print(json.dumps({"ok": ok, "records": len(out)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
