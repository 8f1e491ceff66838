"""One run of one cell, from its name to the result line: the world, the
traffic from the seed, the child run, the reference's judgement and the
metrics.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import reference, registry, stream, world
from .traffic import Traffic, chunk_records
from .window import Window

BASE = registry.BASE
ROOT = registry.ROOT


class RunFailed(RuntimeError):
    """The run cannot give a result: no device, a failed child, a
    forbidden module."""


@dataclass
class Outcome:
    result: dict
    sample: reference.Sample
    genome: world.Genome
    scoring: dict
    limits: dict


def rng(seed: int, stream_id: int) -> np.random.Generator:
    """An independent stream of the run's seed (any whole number)."""
    return np.random.default_rng([stream_id, abs(int(seed)), int(seed < 0)])


def check_devices(chips: int) -> str:
    """The card's name; RunFailed unless `chips` CUDA devices are there."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < chips:
        raise RunFailed(f"{n} CUDA devices; the cell needs {chips}")
    return torch.cuda.get_device_name(0)


def _sample(tr: Traffic, kept: dict, units: np.ndarray, r) -> reference.Sample:
    """One occurrence (cycle) a sampled unit, drawn from `r`, of those the
    window produced; the reads of pairs in mate order."""
    pool, lines_of = tr.pool, []
    picks = []
    cycles_of: dict = {}
    for c, i in sorted(kept):
        cycles_of.setdefault(i, []).append(c)
    for u in units:
        cycles = cycles_of.get(int(u))
        if cycles:
            picks.append((int(cycles[r.integers(len(cycles))]), int(u)))
    rows = []
    for c, u in picks:
        lines = kept[(c, u)]
        if tr.paired:
            rows += [2 * u, 2 * u + 1]
            lines_of.append([x for x in lines
                             if int(x.split(b"\t", 2)[1]) & 0x40])
            lines_of.append([x for x in lines
                             if not int(x.split(b"\t", 2)[1]) & 0x40])
        else:
            rows.append(u)
            lines_of.append(lines)
    rows = np.asarray(rows, np.int64)
    mate = (np.tile([1, 2], len(picks)) if tr.paired
            else np.zeros(len(rows), np.int64))
    return reference.Sample(pool.codes[rows], pool.contig[rows],
                            pool.src_lo[rows], pool.strand[rows], mate,
                            lines_of, tr.qual_char)


def _victims(tr: Traffic, kept: dict, victim_units: set):
    """Every unseedable mate the window produced (each occurrence), alone,
    with its SAM lines; None when the traffic has none."""
    pool = tr.pool
    rows, lines_of = [], []
    for (c, u), lines in sorted(kept.items()):
        if u not in victim_units:
            continue
        r = 2 * u + int(pool.victim[2 * u + 1])
        bit = 0x40 if r % 2 == 0 else 0x80
        rows.append(r)
        lines_of.append([x for x in lines
                         if int(x.split(b"\t", 2)[1]) & bit])
    if not rows:
        return None
    rows = np.asarray(rows, np.int64)
    return reference.Sample(pool.codes[rows], pool.contig[rows],
                            pool.src_lo[rows], pool.strand[rows],
                            1 + rows % 2, lines_of, tr.qual_char)


def timeline(res) -> dict:
    """When the run's steps happened (seconds from the child's start), the
    program's span totals (seconds, all threads) in set-up and in the
    window, the CPU time of the child and of the harness, and set-up's
    device memory peak: where a run's time went, for the reader of the
    result."""
    spans = res.report.get("spans", [])
    t = {k: round(v - res.spawn, 3) for k, v in (
        ("child_main", res.report.get("t_start", res.spawn)),
        ("window_start", res.window_start), ("first_chunk_sam",
                                              res.warm_record),
        ("feed_end", res.feed_end), ("last_record", res.last_record)) if v}
    first = min((s for s in spans if s[0] == "collect"), default=None,
                key=lambda s: s[2])
    if first:
        t["first_collect"] = [round(first[2] - res.spawn, 3),
                              round(first[3] - res.spawn, 3)]
    for name, lo, hi in (("setup_spans", res.spawn, res.window_start),
                         ("window_spans", res.window_start,
                          res.last_record)):
        tot: dict = {}
        for lab, _, a, b in spans:
            d = min(b, hi) - max(a, lo)
            if d > 0:
                tot[lab] = round(tot.get(lab, 0.0) + d, 3)
        t[name] = tot
    rep = res.report
    if "window_cpu0" in rep:
        # the child's CPU seconds from the warm-up's end to its exit
        t["child_cpu_s"] = round(rep["window_cpu1"][1]
                                 - rep["window_cpu0"][1], 3)
    if "setup_memory_peak_bytes" in rep:
        t["setup_mem_peak_mib"] = round(rep["setup_memory_peak_bytes"]
                                        / 2**20, 1)
    t["harness_cpu_s"] = res.harness_cpu_s
    return t


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             *, base: Path = BASE, root: Path = ROOT,
             cache: Path = world.CACHE, device_check: bool = True,
             cli_extra: tuple = (), child_script: Path | None = None,
             read_block: int = stream.READ_BLOCK,
             log=sys.stderr) -> Outcome:
    c = registry.cell(bench, name)
    cfg = registry.config(c["config"], base)
    t = registry.traffic(c["traffic"], base)
    lim = registry.limits(name, base)
    kind = check_devices(int(c["chips"])) if device_check else None
    prefix = world.ensure(cfg, root, cache, log)
    genome = world.load_genome(cfg, cache)
    tr = Traffic(t, genome, rng(seed, 1))
    # the warm-up chunk: the same reads in every run, so that set-up does
    # the same work whatever the seed
    c1 = chunk_records(int(cfg["chunk_bases"]), int(t["read_len"]),
                       bool(t["paired"]))
    warm = Traffic({**t, "pool_reads": c1}, genome, rng(0, 4))
    step = 2 if tr.paired else 1
    n_units = len(tr) // step
    units = rng(seed, 2).choice(n_units, min(int(t["check_units"]), n_units),
                                replace=False)
    victim_units = {int(r) // 2 for r in np.flatnonzero(tr.pool.victim)}
    argv = [sys.executable, str(child_script or BASE / "child.py"),
            "--report", "{report}", "--trace", str(int(trace)),
            "--min-devices", str(int(c["chips"]) if device_check else 0),
            "--", "align", *cfg["align_flags"],
            *(["-p"] if tr.paired else []), *cli_extra, str(prefix), "-"]
    res = stream.run(argv, world.child_env(root), warm, tr, seconds,
                     set(int(u) for u in units) | victim_units, read_block)
    rep = res.report
    if res.rc != 0 or not rep:
        raise RunFailed(f"the program exited {res.rc}:\n"
                        f"{res.stderr_tail[-6000:]}")
    from child import forbidden_modules

    bad = sorted(set(rep.get("forbidden_modules", []))
                 | set(forbidden_modules()))
    if bad:
        raise RunFailed("JAX or the JAX package was loaded: " + ", ".join(bad))

    sample = _sample(tr, res.sampled, units, rng(seed, 3))
    readings = reference.judge(genome, sample, cfg["scoring"])
    readings["order_wrong"] = res.order_wrong + max(
        0, res.window_records - res.window_primaries)
    vs = _victims(tr, res.sampled, victim_units)
    if vs is not None:
        missed, vr = reference.rescue_missed(genome, vs, cfg["scoring"])
        readings["rescue_missed"] = missed
        readings["rescue_judged"] = vr["checked"] - vr["skipped"]
        readings["rescue_examples"] = vr["examples"]
    checks = {k: {"value": readings[k], "limit": v} for k, v in lim.items()}
    correct = readings["checked"] > 0 and all(
        x["value"] <= x["limit"] for x in checks.values())

    win = Window(res.window_start, res.last_record, res.window_records,
                 rep.get("spans", []), threads=rep.get("threads"),
                 cpu=(rep["window_cpu0"], rep["window_cpu1"])
                 if "window_cpu0" in rep else None,
                 trace=rep.get("trace"), trace_start=rep.get("trace_start"),
                 trace_stop=rep.get("trace_stop"))
    metrics = {}
    if trace:
        for m in registry.per_layer_for(bench, name):
            mod = registry.metric(m["name"], base)
            if (mod.LAYER, mod.UNIT, mod.MOVES) != (m["layer"], m["unit"],
                                                   m["moves"]):
                raise RunFailed(f"metric {m['name']}: BENCHMARK.json and "
                                "its reader disagree on layer, unit or moves")
            v = mod.read(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        wall = res.last_record - res.window_start
        e2e = {"reads_per_s": res.window_records / wall if wall > 0 else None,
               "setup_s": res.setup_s,
               "device_mem_peak_mib": rep["memory_peak_bytes"] / 2**20
               if "memory_peak_bytes" in rep else None}
        for m in registry.end_to_end_for(bench, name):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if device_check else "cpu",
              "kind": rep.get("device_kind", kind),
              "count": int(c["chips"]) if device_check else 0,
              "memory_peak_bytes": rep.get("memory_peak_bytes", 0)}
    result = {"correct": bool(correct), "attempted": res.window_records,
              "failed": readings["order_wrong"], "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = win.busy_s()
        device["window_s"] = win.window_s()
        result["breakdown"] = {"device_ops": win.top_device_ops(),
                               "idle_gaps": win.idle_by_host_activity()}
        if win.traced:
            # launch threads paired with the child's threads by id, and
            # the device operations of launch threads paired with none
            result["trace_threads"] = {"paired": win.thread_map(),
                                       "unpaired_ops": win.unpaired_ops()}
    result["timeline"] = timeline(res)
    result["readings"] = {k: v for k, v in readings.items() if k not in lim}
    result["checks"] = checks
    return Outcome(result, sample, genome, cfg["scoring"], lim)
