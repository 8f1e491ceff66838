"""The port's own trace (utils/timing) on the CPU: spans with their chunk,
parent and thread CPU time, per-chunk counters, the Chrome export on
torch.profiler's clock, and the port's runtime (which owns the chunk ids)
against the JAX package's runtime, SAM byte for byte."""
import copy
import io
import json
import threading
import time

import numpy as np
import pytest

from bwamem_tpu.pipeline.runtime import run_pipeline as jax_run_pipeline
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")

B = "ACGT"
STAGES = ("collect", "finalize", "sam_write")


@pytest.fixture(autouse=True)
def _trace_off():
    from bwamem_tpu_torch.utils import timing

    timing.disable()
    yield
    timing.disable()


def _fq(f, name, r):
    f.write(f"@{name}\n{''.join(B[c] for c in r)}\n+\n{'I' * len(r)}\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 60 kb random genome; 64 SE reads and 40 interleaved FR pairs of
    150 bp, read 2 of every 4th pair unseedable (a substitution every 12
    bases) so that mate rescue runs."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.utils.simgenome import write_fasta

    d = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(13)
    g = rng.integers(0, 4, 60_000).astype(np.uint8)
    write_fasta(str(d / "ref.fa"), [("chr1", "".join(B[c] for c in g))])

    def mut(r, every=0):
        r = r.copy()
        if every:
            r[::every] = (r[::every] + 1) % 4
        e = rng.random(len(r)) < 0.01
        r[e] = (r[e] + 1) % 4
        return r

    with open(d / "se.fq", "w") as f:
        for i in range(64):
            p = int(rng.integers(0, len(g) - 150))
            r = mut(g[p:p + 150])
            _fq(f, f"s{i}", (3 - r)[::-1] if i % 2 else r)
    with open(d / "pe.fq", "w") as f:
        for i in range(40):
            p = int(rng.integers(0, len(g) - 400))
            frag = g[p:p + 350]
            _fq(f, f"p{i}", mut(frag[:150]))
            _fq(f, f"p{i}", mut((3 - frag[-150:])[::-1], 12 * (i % 4 == 3)))
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


@pytest.fixture(scope="module")
def runs(world):
    """`align -t 1 --trace-out` on the CPU, SE and PE, in this process:
    each run's exported trace, its aligner's stats, and the DP cells of
    the extension launches, summed from the launches' own (qlen, tlen)."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.pipeline import aligner as aligner_mod
    from bwamem_tpu_torch.pipeline import runtime

    out = {}
    for mode, fq, flags in (("se", "se.fq", ["-K", "2000"]),
                            ("pe", "pe.fq", ["-K", "6000", "-p"])):
        seen, cells = {}, []
        real_rp = runtime.run_pipeline
        real_ext = aligner_mod.extend_choose_desc

        def rp(records, aligner, *a, **k):
            seen["aligner"] = aligner
            return real_rp(records, aligner, *a, **k)

        def ext(fm, reads_dev, read, qstart, qlen, tstart, tlen, *a):
            cells.append(int((qlen.long() * tlen.long()).sum()))
            return real_ext(fm, reads_dev, read, qstart, qlen, tstart, tlen,
                            *a)

        trace = world / f"{mode}.json"
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(world)  # the CLI appends to ./time.log
            mp.setattr(runtime, "run_pipeline", rp)
            mp.setattr(aligner_mod, "extend_choose_desc", ext)
            assert main(["align", "--device", "cpu", "-t", "1", *flags,
                         "--trace-out", str(trace), str(world / "idx"),
                         str(world / fq), "-o",
                         str(world / f"{mode}.sam")]) == 0
        with open(trace) as f:
            out[mode] = (json.load(f), seen["aligner"].stats, sum(cells))
    return out


def _spans(tr):
    return [e for e in tr["traceEvents"] if e["ph"] == "X"]


def test_off_records_nothing():
    from bwamem_tpu_torch.utils import timing

    t = timing.Timings()
    with timing.chunk(3), t.span("a"):
        timing.count("reads", 5)
    assert not timing.recording() and timing._trace is None
    assert timing._state.chunk is None and timing._state.open == []
    assert t.counts == {"a": 1} and t.totals["a"] >= 0


def test_spans_nest_with_cpu_within_wall():
    from bwamem_tpu_torch.utils import timing

    tr = timing.enable()
    t = timing.Timings()

    def work(cid):
        with timing.chunk(cid), t.span("outer"):
            with t.span("busy"):
                x = 0
                for i in range(200_000):
                    x += i
            with t.span("sleep"):
                time.sleep(0.02)
            timing.count("units", cid)

    ths = [threading.Thread(target=work, args=(c,), name=f"w{c}")
           for c in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=30)
        assert not th.is_alive()
    assert timing.disable() is tr
    by_id = {s[0]: s for s in tr.spans}
    assert len(by_id) == 9
    for sid, label, ident, chunk, parent, t0, t1, cpu in tr.spans:
        assert 0 <= cpu <= t1 - t0
        assert chunk == int(tr.threads[ident][1][1:])
        if label == "outer":
            assert parent is None
        else:
            p = by_id[parent]
            assert p[1] == "outer" and p[2] == ident
            assert p[5] <= t0 <= t1 <= p[6]
        if label == "sleep":
            assert cpu < (t1 - t0) / 2
    assert sorted((name, n, c) for name, n, _, _, c in tr.counters) == [
        ("units", 0, 0), ("units", 1, 1), ("units", 2, 2)]


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_align_spans_carry_chunk_ids(runs, mode):
    tr = runs[mode][0]
    spans = _spans(tr)
    by_id = {e["args"]["id"]: e for e in spans}
    ids = {}
    for stage in STAGES:
        got = sorted((e["ts"], e["args"]["chunk"]) for e in spans
                     if e["name"] == stage)
        ids[stage] = [c for _, c in got]
        assert None not in ids[stage]
        assert len(set(ids[stage])) == len(ids[stage])
    assert len(ids["collect"]) >= 2
    assert sorted(ids["collect"]) == ids["finalize"] == ids["sam_write"]
    assert ids["finalize"] == list(range(len(ids["finalize"])))
    # every span inside a collect carries that collect's chunk
    inner = 0
    for e in spans:
        p = e["args"]["parent"]
        while p is not None and by_id[p]["name"] != "collect":
            p = by_id[p]["args"]["parent"]
        if p is not None:
            assert e["args"]["chunk"] == by_id[p]["args"]["chunk"]
            inner += 1
    assert inner >= 2 * len(ids["collect"])
    names = {e["args"]["name"] for e in tr["traceEvents"]
             if e["ph"] == "M"}
    assert {"reader", "writer", "collect_0"} <= names
    labels = {e["name"] for e in spans}
    assert {"read", "seed_device", "ext_device", *STAGES} <= labels
    assert not labels & {"seed_total", "native_total"}
    counters = {e["name"] for e in tr["traceEvents"] if e["ph"] == "C"}
    want = {"reads", "bases", "seeds", "ext_jobs", "ext_cells", "host_syncs"}
    if mode == "pe":
        want |= {"rescue_jobs", "rescue_applied"}
    assert want <= counters
    assert all("chunk" in e["args"] for e in tr["traceEvents"]
               if e["ph"] == "C")


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_counters_sum_to_stats(runs, mode):
    tr, stats, cells = runs[mode]
    tot: dict = {}
    per_chunk: dict = {}
    for e in tr["traceEvents"]:
        if e["ph"] == "C":
            tot[e["name"]] = tot.get(e["name"], 0) + e["args"]["n"]
            per_chunk.setdefault(e["name"], set()).add(e["args"]["chunk"])
    assert tot["reads"] == stats["n_reads"] == (64 if mode == "se" else 80)
    assert tot["bases"] == 150 * stats["n_reads"]
    assert tot["seeds"] == stats["n_seeds"]
    assert tot["ext_jobs"] == stats["n_extensions"]
    assert tot["ext_cells"] == cells > 0
    if mode == "pe":
        assert tot["rescue_jobs"] == stats["rescue_jobs"] > 0
        assert 0 < tot["rescue_applied"] == stats["rescue_applied"]
    # every chunk syncs the host: the seeding's compactions, S4's totals,
    # the seeds' and the extension's copies
    n_chunks = len(per_chunk["reads"])
    assert per_chunk["host_syncs"] == per_chunk["reads"]
    assert tot["host_syncs"] >= 8 * n_chunks


def test_spans_lie_on_the_profilers_clock(tmp_path):
    """A torch op run inside a span, as torch.profiler's Chrome trace
    places it (ts + baseTimeNanoseconds: epoch us), falls inside the
    span as the export places it, within 2 ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwamem_tpu_torch.utils import timing

    timing.enable()
    t = timing.Timings()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with t.span("op"):
                time.sleep(0.003)
                x = torch.mm(x, x).clamp_(-1, 1)
                time.sleep(0.003)
    ours = timing.disable().chrome()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    with open(tmp_path / "prof.json") as f:
        theirs = json.load(f)
    base = theirs.get("baseTimeNanoseconds", 0) / 1e3
    mms = [(e["ts"] + base, e["ts"] + base + e["dur"])
           for e in theirs["traceEvents"]
           if e.get("ph") == "X" and e.get("name") == "aten::mm"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in _spans(ours)]
    assert len(mms) == len(spans) == 3
    for (a, b), (s0, s1) in zip(sorted(mms), sorted(spans)):
        assert s0 - 2000 <= a and b <= s1 + 2000


class _Replay:
    """The port's aligner with each chunk's collect result kept, so that
    every runtime and lookahead finalizes the same regions, computed
    once."""

    def __init__(self, al):
        self.al, self.opt, self.idx = al, al.opt, al.idx
        self.timings = None
        self.memo: dict = {}

    def _get(self, fn, seqs):
        key = b"|".join(s.tobytes() for s in seqs)
        if key not in self.memo:
            self.memo[key] = fn(seqs)
        return copy.deepcopy(self.memo[key])

    def collect_regs_batch(self, seqs):
        return self._get(self.al.collect_regs_batch, seqs)

    def collect_pairs_batch(self, seqs):
        return self._get(self.al.collect_pairs_batch, seqs)


@pytest.fixture(scope="module")
def replay(world):
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MEM_F_PE, MemOptions

    idx = FMIndex.load(str(world / "idx.bmt"))
    opt = MemOptions()
    pe = MemOptions()
    pe.flag |= MEM_F_PE
    return {False: _Replay(MemAligner(opt, idx, device="cpu")),
            True: _Replay(MemAligner(pe, idx, device="cpu"))}


def _records(world, paired):
    from bwamem_tpu_torch.io.fastx import read_fastx

    return list(read_fastx(str(world / ("pe.fq" if paired else "se.fq"))))


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("lookahead", [0, 2])
def test_runtime_matches_jax_runtime(world, replay, paired, lookahead):
    from bwamem_tpu_torch.pipeline.hostpool import HostPool
    from bwamem_tpu_torch.pipeline.runtime import run_pipeline

    al = replay[paired]
    pool = HostPool(al.opt, al.idx, 1)
    sams = []
    for rp in (run_pipeline, jax_run_pipeline):
        out = io.StringIO()
        n = rp(iter(_records(world, paired)), al, 3000, out, paired=paired,
               host_pool=pool, lookahead=lookahead)
        assert n == (80 if paired else 64)
        sams.append(out.getvalue())
    assert sams[0] == sams[1] and sams[0].count("\n") >= n


def test_runtime_reader_error_surfaces(world, replay):
    from bwamem_tpu_torch.pipeline.hostpool import HostPool
    from bwamem_tpu_torch.pipeline.runtime import run_pipeline

    recs = _records(world, False)

    def failing():
        for i, r in enumerate(recs):
            if i == 40:
                raise ValueError("parse error at record 40")
            yield r

    al = replay[False]
    with pytest.raises(ValueError, match="record 40"):
        run_pipeline(failing(), al, 3000, io.StringIO(),
                     host_pool=HostPool(al.opt, al.idx, 1))
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name in ("reader", "writer") and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name in ("reader", "writer") and t.is_alive()
                   for t in threading.enumerate())
