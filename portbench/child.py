"""The child process of a benchmark run: the port's CLI, in process, with
the measurement around it.

    python portbench/child.py --report PATH --trace 0|1 --min-devices N \
        -- align [flags] INDEX_PREFIX -

It runs `bwamem_tpu_torch.cli.main(argv)` on a thread of its own, so that
this process's main thread can start and stop the profiler. Around the
program it
- records every `Timings.span` interval (label, thread key, start, end on
  the monotonic clock) and each span thread's ids, and flushes standard output at the end of each
  `sam_write` span, so that a chunk's SAM reaches the pipe when it is
  written, not when the buffer fills;
- when the first chunk's `collect` span ends (the warm-up chunk is
  aligned; the runtime finalizes it once the next chunk arrives), with
  --trace 1 starts torch.profiler (CUDA activity), reads the process's
  CPU times and the device memory peak so far, and then prints
  WINDOW_MARK on standard error: the harness starts the window there;
- at exit writes the report: the spans, the whole run's peak of
  `torch.cuda.max_memory_allocated()`, the device, the CPU times, any
  JAX module found in `sys.modules`, and with --trace 1 the device
  operations and kernel launches of the traced window.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "bwamem_tpu")
WINDOW_MARK = "[portbench] first chunk collected"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def cpu_seconds() -> float:
    a = resource.getrusage(resource.RUSAGE_SELF)
    b = resource.getrusage(resource.RUSAGE_CHILDREN)
    return a.ru_utime + a.ru_stime + b.ru_utime + b.ru_stime


def thread_key() -> int:
    """The calling thread's key in the spans: the low 32 bits of its
    pthread id."""
    return threading.get_ident() & 0xFFFFFFFF


def thread_ids() -> list[int]:
    """Every id the profiler's CUDA runtime events may give the calling
    thread: the low 32 bits of its pthread id, as unsigned and as the
    magnitude of a signed 32-bit number, and its kernel thread id."""
    u = thread_key()
    return sorted({u, (1 << 32) - u if u >> 31 else u,
                   threading.get_native_id()})


class Recorder:
    def __init__(self):
        self.spans: list = []
        self.threads: dict = {"main": thread_ids()}
        self.first_collect = threading.Event()

    def install(self, timing_module) -> None:
        orig = timing_module.Timings.span
        rec = self

        @contextmanager
        def span(self, label: str):
            t0 = time.perf_counter()
            try:
                with orig(self, label):
                    yield
            finally:
                t1 = time.perf_counter()
                key = thread_key()
                rec.spans.append((label, key, t0, t1))
                if str(key) not in rec.threads:
                    rec.threads[str(key)] = thread_ids()
                if label == "sam_write":
                    sys.stdout.flush()
                elif label == "collect":
                    rec.first_collect.set()

        timing_module.Timings.span = span


def clock_offset_us() -> float:
    """Epoch microseconds (the profiler's clock) less monotonic
    microseconds, the smallest of a few reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        e = time.time_ns() / 1e3
        b = time.perf_counter()
        off = e - (a + b) / 2 * 1e6
        if best is None or (b - a) < best[0]:
            best = (b - a, off)
    return best[1]


def read_trace(path: Path, offset_us: float) -> dict:
    """Device operations and kernel launches of a Chrome trace, on the
    monotonic clock in seconds: ops [name index, start, end, correlation],
    launches [correlation, thread id, time], names."""
    with open(path) as f:
        tr = json.load(f)
    base = tr.get("baseTimeNanoseconds", 0) / 1e3
    names: dict[str, int] = {}
    ops, launches = [], []
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts = (float(e["ts"]) + base - offset_us) / 1e6
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            k = names.setdefault(e["name"], len(names))
            ops.append([k, ts, ts + float(e.get("dur", 0)) / 1e6,
                        corr if corr is not None else -1])
        elif cat in _LAUNCH_CATS and corr is not None:
            launches.append([corr, e.get("tid"), ts])
    return dict(names=list(names), ops=ops, launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--min-devices", type=int, default=1)
    ap.add_argument("cli", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cli_argv = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    report: dict = dict(spans=[], t_start=time.perf_counter())
    rc = 1
    try:
        import torch

        if args.min_devices:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n < args.min_devices:
                print(f"[portbench] {n} CUDA devices; the cell needs "
                      f"{args.min_devices}", file=sys.stderr)
                return 3
        from bwamem_tpu_torch import cli
        from bwamem_tpu_torch.utils import timing

        rec = Recorder()
        rec.install(timing)
        report["spans"] = rec.spans
        report["threads"] = rec.threads
        out: dict = {}

        def run():
            try:
                out["rc"] = cli.main(cli_argv)
            except SystemExit as e:
                out["rc"] = e.code if isinstance(e.code, int) else 1
                if not isinstance(e.code, int) and e.code is not None:
                    print(e.code, file=sys.stderr)
            except BaseException:  # noqa: BLE001 - reported, then exit 1
                out["rc"] = 1
                traceback.print_exc()

        sys.argv = ["bwamem-tpu-torch", *cli_argv]
        th = threading.Thread(target=run, name="cli")
        th.start()
        while not rec.first_collect.wait(0.05):
            if not th.is_alive():
                break
        prof = None
        if rec.first_collect.is_set():
            if args.trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                off0 = clock_offset_us()
                prof = profile(activities=acts)
                prof.start()
                report["trace_start"] = time.perf_counter()
            report["window_cpu0"] = (time.perf_counter(), cpu_seconds())
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                report["setup_memory_peak_bytes"] = int(
                    torch.cuda.max_memory_allocated())
            print(WINDOW_MARK, file=sys.stderr, flush=True)
        th.join()
        rc = out.get("rc", 1)
        report["window_cpu1"] = (time.perf_counter(), cpu_seconds())
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            report["trace_stop"] = time.perf_counter()
            off = (off0 + clock_offset_us()) / 2
            path = Path(args.report).with_suffix(".trace.json")
            prof.export_chrome_trace(str(path))
            report["trace"] = read_trace(path, off)
            path.unlink()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            report["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated())
            report["device_kind"] = torch.cuda.get_device_name(0)
            report["device_count"] = torch.cuda.device_count()
    finally:
        sys.stdout.flush()
        report["forbidden_modules"] = forbidden_modules()
        report["rc"] = rc
        tmp = args.report + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, args.report)
    return rc


if __name__ == "__main__":
    sys.exit(main())
