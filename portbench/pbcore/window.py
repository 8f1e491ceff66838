"""The window's spans and trace, and the arithmetic the per-layer metric
readers share. Every time is on the monotonic clock, in seconds.

- A span's time counts only where it overlaps the window [start, end]
  (the harness's window start to the last SAM record).
- A device operation's time counts only inside the traced window, the
  part of the window the profiler ran over.
- A kernel belongs to a span when the host call that launched it (the
  runtime event with the kernel's correlation id) falls inside a span of
  that label on the same thread (`thread_map` pairs the profiler's thread
  ids with the ids the child recorded for each span thread): by where it
  was launched, not by its name, so that a renamed or merged kernel still
  counts.
"""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field


def _merge(intervals):
    """Union of [a, b) intervals as a sorted disjoint list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _overlap(a, b, lo, hi) -> float:
    return max(0.0, min(b, hi) - max(a, lo))


@dataclass
class Window:
    start: float
    end: float
    reads: int
    spans: list                      # (label, tid, t0, t1)
    threads: dict | None = None      # child's thread key -> its ids
    cpu: tuple | None = None         # ((t0, cpu_s0), (t1, cpu_s1))
    trace: dict | None = None        # child.read_trace's dict
    trace_start: float | None = None
    trace_stop: float | None = None
    _busy: list | None = field(default=None, repr=False)
    _threads: dict | None = field(default=None, repr=False)

    # --------------------------------------------------------- spans
    def span_seconds(self, label: str) -> float | None:
        """Summed overlap of `label` spans (all threads) with the window;
        None when the run recorded no such span."""
        hit = [s for s in self.spans if s[0] == label]
        if not hit:
            return None
        return sum(_overlap(s[2], s[3], self.start, self.end) for s in hit)

    def per_kread_ms(self, seconds: float | None) -> float | None:
        if seconds is None or self.reads <= 0:
            return None
        return seconds * 1e3 / (self.reads / 1e3)

    # --------------------------------------------------------- device
    @property
    def traced(self) -> tuple[float, float] | None:
        if not self.trace or not self.trace.get("ops"):
            return None
        lo = max(self.start, self.trace_start or self.start)
        hi = min(self.end, self.trace_stop or self.end)
        return (lo, hi) if hi > lo else None

    def busy_intervals(self) -> list:
        if self._busy is None:
            tw = self.traced
            self._busy = [] if tw is None else _merge(
                (max(a, tw[0]), min(b, tw[1]))
                for _, a, b, _ in self.trace["ops"]
                if b > tw[0] and a < tw[1])
        return self._busy

    def busy_s(self) -> float | None:
        if self.traced is None:
            return None
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float | None:
        tw = self.traced
        return None if tw is None else tw[1] - tw[0]

    def _span_index(self, label: str):
        """Per thread (by its id as text), the sorted (t0, t1) of its
        `label` spans."""
        by = collections.defaultdict(list)
        for lab, tid, a, b in self.spans:
            if lab == label:
                by[str(tid)].append((a, b))
        return {t: sorted(v) for t, v in by.items()}

    @staticmethod
    def _inside(iv, t) -> bool:
        k = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return k >= 0 and iv[k][0] <= t <= iv[k][1]

    def thread_map(self) -> dict:
        """Each launch thread of the trace to the child's thread of the
        same id: a span thread's key, or "main". The profiler names a
        thread by one of the ids the child records for it
        (`child.thread_ids`)."""
        if self._threads is None:
            ids = {}
            for key, aliases in (self.threads or {}).items():
                for i in aliases:
                    ids[str(i)] = key
            for _, tid, _, _ in self.spans:
                ids.setdefault(str(tid), str(tid))
            self._threads = {str(lt): ids[str(lt)] for _, lt, _ in
                             self.trace["launches"] if str(lt) in ids}
        return self._threads

    def unpaired_ops(self) -> list:
        """[operations, device seconds] inside the traced window that were
        launched from threads the child does not know."""
        tw = self.traced
        if tw is None:
            return [0, 0.0]
        tmap = self.thread_map()
        lost = {corr for corr, tid, _ in self.trace["launches"]
                if str(tid) not in tmap}
        hit = [_overlap(a, b, *tw) for _, a, b, corr in self.trace["ops"]
               if corr in lost and b > tw[0] and a < tw[1]]
        return [len(hit), sum(hit)]

    def kernel_seconds(self, label: str) -> float | None:
        """Device time, inside the traced window, of the operations
        launched from inside `label` spans (on the launching thread);
        None when the trace holds none, or holds operations of a thread
        it cannot pair, which may have been launched in such a span."""
        tw = self.traced
        if tw is None:
            return None
        by_tid = self._span_index(label)
        if not by_tid or self.unpaired_ops()[0]:
            return None
        tmap = self.thread_map()
        hits = set()
        for corr, tid, t in self.trace["launches"]:
            st = tmap.get(str(tid))
            if st in by_tid and self._inside(by_tid[st], t):
                hits.add(corr)
        return sum(_overlap(a, b, *tw) for _, a, b, corr in self.trace["ops"]
                   if corr in hits)

    # ------------------------------------------------------ breakdown
    def top_device_ops(self, n: int = 10) -> list:
        tw = self.traced
        if tw is None:
            return []
        names = self.trace["names"]
        tot = collections.Counter()
        for k, a, b, _ in self.trace["ops"]:
            tot[names[k]] += _overlap(a, b, *tw)
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_by_host_activity(self, n: int = 10) -> list:
        """Idle device time inside the traced window, by the spans the host
        had open at the middle of each gap ('+'-joined labels, 'none')."""
        tw = self.traced
        if tw is None:
            return []
        gaps, t = [], tw[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if tw[1] > t:
            gaps.append((t, tw[1]))
        # sweep the gaps' midpoints in order over the spans' starts and ends
        events = sorted([(s[2], 0, i) for i, s in enumerate(self.spans)]
                        + [(s[3], 1, i) for i, s in enumerate(self.spans)])
        open_: collections.Counter = collections.Counter()
        tot = collections.Counter()
        k = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while k < len(events) and events[k][0] <= mid:
                _, end, i = events[k]
                open_[self.spans[i][0]] += -1 if end else 1
                k += 1
            label = "+".join(sorted(x for x, c in open_.items() if c > 0))
            tot[label or "none"] += b - a
        return [[k_, v] for k_, v in tot.most_common(n)]

    def cpu_seconds(self) -> float | None:
        if not self.cpu:
            return None
        return self.cpu[1][1] - self.cpu[0][1]
