"""One run of a cell: the program as a child process fed FASTQ through one
pipe, its SAM read back through another.

1. Set-up: the child starts; the harness feeds the program's first chunk
   (the same reads in every run) and the reads that fill the program's
   last read block behind it (the
   port's FASTQ reader takes its input in blocks of `read_block` bytes and
   waits for a whole block). When the child reports the first chunk
   aligned (child.WINDOW_MARK), set-up ends and the window starts:
   `setup_s` is the time from the child's start to that report.
2. Window: the harness feeds reads for `seconds`, closes the pipe and
   waits for the last SAM record. The window's reads are every read fed
   after the first chunk, the filler included: the program starts work on
   them only in the window. (The port's runtime writes the first chunk's
   SAM only once the second chunk has arrived, so it comes in the
   window.)

The SAM reader checks that the primary records come in the order the
reads were fed (`order_wrong` counts those that do not), counts them, and
keeps every record of the sampled reads.

Where the machine gives the run four cores or more, the harness (feeder
and SAM reader) keeps to the last of them and the child to the others,
so that the load generator takes no core from the program; the
harness's own CPU seconds over the window are kept beside the child's.
"""
from __future__ import annotations

import collections
import os
import resource
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from .traffic import WARM_CYCLE, Traffic, parse_name

WINDOW_MARK = "[portbench] first chunk collected"  # child.WINDOW_MARK

# the port's FASTQ reader reads standard input in blocks of this size
# (`bwamem_tpu_torch/io/fastx.py`, `_read_fastx_native`'s `chunk`)
READ_BLOCK = 8 << 20
FEED_RECORDS = 256        # records a write to the pipe
INFLIGHT_CHUNKS = 4       # chunks fed ahead of the SAM that came back
WARM_TIMEOUT_S = 1100     # a first run in a checkout builds the kernels
DRAIN_TIMEOUT_S = 240


@dataclass
class Result:
    setup_s: float = 0.0
    window_start: float = 0.0
    last_record: float = 0.0
    window_records: int = 0
    window_primaries: int = 0
    order_wrong: int = 0
    sampled: dict = field(default_factory=dict)   # (cycle, idx) -> [lines]
    report: dict = field(default_factory=dict)
    rc: int = 0
    stderr_tail: str = ""
    spawn: float = 0.0
    warm_record: float = 0.0
    feed_end: float = 0.0
    harness_cpu_s: float | None = None


class _SamReader(threading.Thread):
    """Reads the SAM: the warm-up chunk's records (cycle WARM_CYCLE) come
    first, then the window's, in the order they were fed."""

    def __init__(self, stream, traffic: Traffic, warm_records: int,
                 sample: set):
        super().__init__(daemon=True, name="sam-reader")
        self.stream = stream
        self.paired = traffic.paired
        self.units = len(traffic) // (2 if self.paired else 1)
        self.warm = warm_records
        self.sample = sample
        self.t_warm = 0.0
        self.t_last = 0.0
        self.next = 0
        self.primaries = 0
        self.order_wrong = 0
        self.kept: dict = collections.defaultdict(list)
        self.error: BaseException | None = None

    def run(self):
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - surfaced by the run
            self.error = e

    def _run(self):
        paired, units, warm = self.paired, self.units, self.warm
        for line in self.stream:
            if line[:1] == b"@":
                continue
            now = time.perf_counter()
            name, flag, _ = line.split(b"\t", 2)
            flag = int(flag)
            cycle, idx = parse_name(name)
            window = cycle != WARM_CYCLE
            unit = cycle * units + idx if window else idx
            if not flag & 0x900:
                k = 2 * unit + (0 if flag & 0x40 else 1) if paired else unit
                k += warm if window else 0
                if k != self.next:
                    self.order_wrong += 1
                self.next = k + 1
                self.primaries += 1
                if self.primaries == warm:
                    self.t_warm = now
            if window and idx in self.sample:
                self.kept[(cycle, idx)].append(line)
            self.t_last = now


def _tail(stream, keep: collections.deque, mark: bytes,
          seen: threading.Event):
    for line in stream:
        if line.startswith(mark):
            seen.set()
        keep.append(line.decode(errors="replace"))
    seen.set()


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _cores() -> tuple[set | None, set | None]:
    """(the harness's core, the child's cores), or (None, None) on a
    machine that gives the run fewer than four cores."""
    try:
        cpus = os.sched_getaffinity(0)
    except (AttributeError, OSError):
        return None, None
    if len(cpus) < 4:
        return None, None
    last = max(cpus)
    return {last}, cpus - {last}


def run(child_argv: list, env: dict, warm: Traffic, traffic: Traffic,
        seconds: float, sample: set, read_block: int = READ_BLOCK) -> Result:
    """Start the child, warm it up on `warm` (one chunk of reads, the same
    in every run), feed the window from `traffic` (the run's seed), and
    collect. In the
    window at most INFLIGHT_CHUNKS chunks of reads (beyond the warm-up's
    filler) are fed ahead of the SAM that has come back: enough for both
    collector threads, the finalize and the reader, and few enough that
    the port's queues take them without blocking the pipe, so that the
    feeding stops on time and the drain stays a few chunks long."""
    res = Result()
    rec_len = traffic.records.shape[1]
    n_pool = len(traffic)
    step = 2 if traffic.paired else 1
    c1 = len(warm)
    # the first chunk, two records more, then up to the end of a read block
    target = -(-((c1 + 2) * rec_len) // read_block) * read_block
    warm_end = -(-target // rec_len)
    warm_end += warm_end % step
    if warm_end - c1 > n_pool:
        raise ValueError(f"the pool ({n_pool}) is shorter than the filler")
    mine, theirs = _cores()
    before = os.sched_getaffinity(0) if mine else None
    with tempfile.TemporaryDirectory(prefix="portbench-") as run_dir:
        report_path = Path(run_dir) / "report.json"
        argv = [a if a != "{report}" else str(report_path) for a in child_argv]
        if mine:
            os.sched_setaffinity(0, mine)
        t_spawn = time.perf_counter()
        proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, cwd=run_dir, env=env,
            preexec_fn=(lambda: os.sched_setaffinity(0, theirs))
            if theirs else None)
        err_tail: collections.deque = collections.deque(maxlen=200)
        marked = threading.Event()
        et = threading.Thread(target=_tail, args=(proc.stderr, err_tail,
                                                  WINDOW_MARK.encode(), marked),
                              daemon=True)
        et.start()
        reader = _SamReader(proc.stdout, traffic, c1, sample)
        reader.start()
        fed = 0
        cycle = 0
        traffic.set_cycle(0)
        warm.set_cycle(WARM_CYCLE)

        def feed(upto: int) -> None:
            """Feed records up to record `upto` of the run: the warm-up
            chunk, then the pool over and over (whole blocks)."""
            nonlocal fed, cycle
            while fed < upto:
                if fed < c1:
                    src, i = warm.records, fed
                    j = min(c1, i + min(FEED_RECORDS, upto - fed))
                else:
                    i = (fed - c1) % n_pool
                    if i == 0 and fed > c1:
                        cycle += 1
                        if cycle == WARM_CYCLE:
                            raise ValueError("the pool was fed 999 times")
                        traffic.set_cycle(cycle)
                    src = traffic.records
                    j = min(n_pool, i + min(FEED_RECORDS, upto - fed))
                proc.stdin.write(memoryview(src[i:j]).cast("B"))
                fed += j - i

        try:
            try:
                feed(warm_end)
                proc.stdin.flush()
                if not marked.wait(WARM_TIMEOUT_S) or proc.poll() is not None:
                    raise BrokenPipeError
                res.window_start = t0 = time.perf_counter()
                h0 = _cpu_s()
                limit = INFLIGHT_CHUNKS * c1 + warm_end - c1
                while time.perf_counter() - t0 < seconds:
                    if fed - reader.primaries < limit:
                        feed(fed + FEED_RECORDS)
                    else:
                        time.sleep(0.01)
                res.feed_end = time.perf_counter()
                proc.stdin.close()
            except BrokenPipeError:
                pass
            proc.wait(timeout=DRAIN_TIMEOUT_S + WARM_TIMEOUT_S)
            if res.window_start:
                res.harness_cpu_s = round(_cpu_s() - h0, 3)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            reader.join(timeout=30)
            et.join(timeout=30)
            if before:
                os.sched_setaffinity(0, before)
        res.rc = proc.returncode
        if reader.primaries < c1 or not res.window_start:
            res.rc = res.rc or 1
            err_tail.append("[portbench] the first chunk never came back\n")
        res.setup_s = res.window_start - t_spawn if res.window_start else 0.0
        res.spawn, res.warm_record = t_spawn, reader.t_warm
        res.stderr_tail = "".join(err_tail)
        if reader.error is not None:
            raise reader.error
        res.last_record = reader.t_last
        res.window_records = fed - c1
        res.window_primaries = reader.primaries - c1
        res.order_wrong = reader.order_wrong
        res.sampled = dict(reader.kept)
        if report_path.exists():
            import json

            res.report = json.loads(report_path.read_text())
    return res
