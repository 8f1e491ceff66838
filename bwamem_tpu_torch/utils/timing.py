"""Run timing / metrics subsystem.

Equivalent of the reference's hand-rolled per-stage timing
(reference: src/utils.h:139-161 time_struct, src/main.c:128-174 exit
report, src/fastmap.c:515-524 run_exec_time.txt TSV): labeled wall-clock
spans accumulated across the run, an end-of-run breakdown, an appendable
`time.log`, and a TSV row with run metadata.

The same spans also feed a trace, kept in memory while it is on
(`enable`, as `align --trace-out` does): each span with its thread, its
chunk (the runtime's `chunk` context), its parent span and the thread's
CPU time over it, and counter events (`count`) from wherever the work
happens. `Trace.chrome` exports it as Chrome trace-event JSON on the clock
of torch.profiler's traces (epoch microseconds). Off, which is the
default, a span or a count checks one module-level reference and records
nothing more than the totals.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_trace: "Trace | None" = None  # the trace being recorded, if any


class _ThreadState(threading.local):
    def __init__(self):
        self.chunk = None   # the runtime's chunk id on this thread
        self.open = []      # ids of this thread's open spans, innermost last


_state = _ThreadState()


def clock_offset_us() -> float:
    """Epoch microseconds (the clock of torch.profiler's Chrome traces)
    less `time.perf_counter()` microseconds, from the read of a few whose
    two perf_counter reads lie closest together."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        e = time.time_ns() / 1e3
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) / 2 * 1e6)
    return best[1]


class Trace:
    """The in-memory record of one run.

    spans: (id, label, thread ident, chunk, parent id, t0, t1, thread CPU
    seconds), t0 and t1 on `time.perf_counter()`; counters: (name, n, t,
    thread ident, chunk); threads: ident -> (native id, name) of every
    thread that recorded; offsets: `clock_offset_us()` at enable and at
    each export."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.counters: list[tuple] = []
        self.threads: dict[int, tuple[int, str]] = {}
        self.offsets = [clock_offset_us()]
        self._ids = itertools.count(1)

    def _thread(self) -> int:
        ident = threading.get_ident()
        if ident not in self.threads:
            t = threading.current_thread()
            self.threads[ident] = (threading.get_native_id(), t.name)
        return ident

    def chrome(self) -> dict:
        """Chrome trace-event JSON: `X` per span (args: chunk, parent,
        id, cpu_us), `C` per counter event (args: n, and chunk where the
        event had one), `M` thread names; `ts` in epoch microseconds, the
        clock torch.profiler's trace gives after its
        `baseTimeNanoseconds`. `otherData` holds the perf_counter
        offsets, read at enable and now."""
        self.offsets.append(clock_offset_us())
        off = (self.offsets[0] + self.offsets[-1]) / 2
        pid = os.getpid()
        tid = {ident: native for ident, (native, _) in self.threads.items()}
        ev = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": native,
               "args": {"name": name, "pthread_id": ident & 0xFFFFFFFF}}
              for ident, (native, name) in self.threads.items()]
        for sid, label, ident, chunk, parent, t0, t1, cpu in self.spans:
            ev.append({"ph": "X", "cat": "span", "name": label, "pid": pid,
                       "tid": tid[ident], "ts": t0 * 1e6 + off,
                       "dur": (t1 - t0) * 1e6,
                       "args": {"chunk": chunk, "parent": parent, "id": sid,
                                "cpu_us": cpu * 1e6}})
        for name, n, t, ident, chunk in self.counters:
            args = {"n": n} if chunk is None else {"n": n, "chunk": chunk}
            ev.append({"ph": "C", "name": name, "pid": pid,
                       "tid": tid[ident], "ts": t * 1e6 + off,
                       "args": args})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"clock": "epoch_us",
                              "perf_counter_offset_us": off,
                              "offset_reads_us": list(self.offsets)}}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)


def enable() -> Trace:
    """Start recording a trace (a fresh one) in this process."""
    global _trace
    _trace = Trace()
    return _trace


def disable() -> "Trace | None":
    """Stop recording; returns the trace recorded, if any."""
    global _trace
    tr, _trace = _trace, None
    return tr


def recording() -> bool:
    """Whether a trace is being recorded (for counts that cost work to
    compute)."""
    return _trace is not None


def count(name: str, n: int = 1) -> None:
    """A counter event of `n` units of `name` on the calling thread, in its
    chunk; nothing while no trace is recorded."""
    tr = _trace
    if tr is None:
        return
    tr.counters.append((name, int(n), time.perf_counter(), tr._thread(),
                        _state.chunk))


@contextmanager
def chunk(cid: int):
    """The calling thread works on chunk `cid` inside the block: its spans
    and counter events carry that id."""
    if _trace is None:
        yield
        return
    prev, _state.chunk = _state.chunk, cid
    try:
        yield
    finally:
        _state.chunk = prev


class Timings:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.meta: dict[str, object] = {}
        self._start = time.perf_counter()

    @contextmanager
    def span(self, label: str):
        tr = _trace
        if tr is None:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[label] += time.perf_counter() - t0
                self.counts[label] += 1
            return
        st = _state
        sid = next(tr._ids)
        parent = st.open[-1] if st.open else None
        st.open.append(sid)
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            yield
        finally:
            c1 = time.thread_time()
            t1 = time.perf_counter()
            st.open.pop()
            self.totals[label] += t1 - t0
            self.counts[label] += 1
            tr.spans.append((sid, label, tr._thread(), st.chunk, parent, t0,
                             t1, c1 - c0))

    def add(self, label: str, seconds: float) -> None:
        self.totals[label] += seconds
        self.counts[label] += 1

    def report(self) -> str:
        total = time.perf_counter() - self._start
        lines = [f"total wall time: {total:.3f}s"]
        for label in sorted(self.totals, key=lambda k: -self.totals[k]):
            t = self.totals[label]
            lines.append(
                f"  {label:<28s} {t:9.3f}s  ({100 * t / total:5.1f}%)"
                f"  x{self.counts[label]}"
            )
        return "\n".join(lines)

    def append_log(self, path: str, cmdline: str) -> None:
        with open(path, "a") as f:
            f.write(f"# {cmdline}\n{self.report()}\n\n")

    def append_tsv(self, path: str, **fields) -> None:
        """One tab-separated row: metadata columns then per-label totals
        (the run_exec_time.txt equivalent)."""
        cols = {**self.meta, **fields,
                **{k: f"{v:.4f}" for k, v in sorted(self.totals.items())}}
        header = "\t".join(cols.keys())
        row = "\t".join(str(v) for v in cols.values())
        try:
            with open(path) as f:
                has_header = f.readline().strip() == header
        except FileNotFoundError:
            has_header = False
        with open(path, "a") as f:
            if not has_header:
                f.write(header + "\n")
            f.write(row + "\n")
