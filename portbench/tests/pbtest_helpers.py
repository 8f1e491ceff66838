"""A tiny world for the benchmark's CPU tests: a 300 kbp genome, chunks of
200 reads, and every file the harness looks up, in a directory of its
own."""
import json
import shutil
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB))

TINY_LIMITS = {"records_wrong": 0, "order_wrong": 0, "tags_wrong": 0,
               "below_locus_best": 0, "below_truth": 0}


def make_base(root: Path, paired: bool) -> tuple[dict, Path]:
    """(benchmark dict, base dir) of one cell `tiny.t` on the CPU."""
    base = root / ("pe" if paired else "se")
    if base.exists():
        shutil.rmtree(base)
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir(parents=True)
    shutil.copytree(PB / "metrics", base / "metrics")
    cfg = json.loads((PB / "configs/ecoli.json").read_text())
    cfg.update(name="tiny", chunk_bases=30000,
               align_flags=["-t", "1", "-K", "30000"])
    cfg["genome"].update(length_bp=300000, contigs=2)
    (base / "configs/tiny.json").write_text(json.dumps(cfg))
    t = json.loads((PB / ("traffic/pe150.json" if paired
                          else "traffic/se150.json")).read_text())
    t.update(pool_reads=1000, check_units=60 if paired else 120)
    if paired:
        t.update(victim_every=10)
    (base / "traffic/t.json").write_text(json.dumps(t))
    lim = dict(TINY_LIMITS, **({"mate_fields_wrong": 0, "rescue_missed": 0}
                               if paired else {}))
    (base / "limits/tiny.t.json").write_text(json.dumps(lim))
    bench = json.loads((PB.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "tiny.t", "config": "tiny",
                           "traffic": "t", "chips": 1, "why": "test"}]
    # the tiny cell reports what the cell it stands for reports
    like = "ecoli.pe250" if paired else "chr21.se150"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.t"] if like in m["workloads"] else []
    return bench, base


def cpu_run(bench, base, cache, seed=5, seconds=2.0, trace=False,
            child=None, env=None):
    """run_cell on the CPU: the chip check skipped, --device cpu, the
    small-block child (or `child`)."""
    import os

    from pbcore import cell

    old = dict(os.environ)
    os.environ.update(env or {})
    os.environ["PORTBENCH_SMALL_BLOCK"] = "1"
    try:
        return cell.run_cell(
            bench, "tiny.t", seed, seconds, trace, base=base, cache=cache,
            device_check=False, cli_extra=("--device", "cpu"),
            child_script=child or PB / "tests/small_block_child.py",
            read_block=64 << 10)
    finally:
        os.environ.clear()
        os.environ.update(old)
