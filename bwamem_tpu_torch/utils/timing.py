"""Run timing / metrics subsystem.

Equivalent of the reference's hand-rolled per-stage timing
(reference: src/utils.h:139-161 time_struct, src/main.c:128-174 exit
report, src/fastmap.c:515-524 run_exec_time.txt TSV): labeled wall-clock
spans accumulated across the run, an end-of-run breakdown, an appendable
`time.log`, and a TSV row with run metadata.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timings:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.meta: dict[str, object] = {}
        self._start = time.perf_counter()

    @contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[label] += time.perf_counter() - t0
            self.counts[label] += 1

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
