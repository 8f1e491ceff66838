"""The span and trace arithmetic on a recorded sample with known
answers."""
import json

import pytest

from pbtest_helpers import PB  # noqa: F401
import child
from pbcore.window import Window

SPANS = [
    # label, thread, start, end (seconds)
    ("collect", 11, 0.5, 2.5),
    ("seed_device", 11, 0.6, 1.0),
    ("ext_device", 11, 1.2, 1.6),
    ("collect", 12, 1.0, 3.0),
    ("seed_device", 12, 1.1, 1.3),
    ("finalize", 10, 2.6, 3.4),
    ("sam_write", 9, 3.4, 3.5),
]
TRACE = {
    "names": ["seed_k", "ext_k", "memcpy"],
    # name, start, end, correlation
    "ops": [[0, 0.70, 0.80, 1], [0, 1.15, 1.25, 2], [1, 1.30, 1.50, 3],
            [2, 1.90, 2.00, 4], [0, 3.70, 3.80, 5], [2, 2.75, 2.85, 6]],
    # correlation, thread, launch time
    "launches": [[1, 11, 0.65], [2, 12, 1.12], [3, 11, 1.25],
                 [4, 10, 1.85], [5, 11, 2.2], [6, 12, 2.7]],
}


def _win(**kw):
    args = dict(start=1.0, end=3.6, reads=2000, spans=SPANS,
                cpu=((1.0, 10.0), (3.6, 12.5)), trace=json.loads(
                    json.dumps(TRACE)), trace_start=0.9, trace_stop=3.9)
    args.update(kw)
    return Window(**args)


def test_spans_clip_to_the_window():
    w = _win()
    # collect: [1.0, 2.5] + [1.0, 3.0] = 1.5 + 2.0
    assert w.span_seconds("collect") == pytest.approx(3.5)
    assert w.span_seconds("seed_device") == pytest.approx(0.2)
    assert w.span_seconds("pe_rescue") is None
    assert w.per_kread_ms(3.5) == pytest.approx(3.5e3 / 2.0)


def test_device_busy_and_idle():
    w = _win()
    # traced window [1.0, 3.6]: ops 1.15-1.25, 1.30-1.50, 1.90-2.00 and
    # 2.75-2.85 lie inside; the first and the one at 3.7 lie out
    assert w.window_s() == pytest.approx(2.6)
    assert w.busy_s() == pytest.approx(0.5)
    idle = dict(w.idle_by_host_activity())
    assert sum(idle.values()) == pytest.approx(2.1)
    # gaps by the spans open at their middles: 1.0-1.15, 1.5-1.9 and
    # 2.0-2.75 under collect alone, 1.25-1.30 under seed and ext spans too,
    # 2.85-3.6 under finalize
    assert idle["collect"] == pytest.approx(1.3)
    assert idle["finalize"] == pytest.approx(0.75)
    assert idle["collect+ext_device+seed_device"] == pytest.approx(0.05)
    top = dict(w.top_device_ops())
    assert top["ext_k"] == pytest.approx(0.2)
    assert top["memcpy"] == pytest.approx(0.2)
    assert top["seed_k"] == pytest.approx(0.1)


def _relabel(tr, names):
    """The profiler names threads its own way: launches of span thread t
    get names[t]."""
    tr = json.loads(json.dumps(tr))
    for x in tr["launches"]:
        x[1] = names[x[1]]
    return tr


def test_kernels_by_launching_span_and_thread():
    w = _win()
    # the profiler's thread ids are the spans'
    assert w.thread_map() == {"11": "11", "12": "12", "10": "10"}
    # seed_device: corr 2 (thread 12 at 1.12, inside 1.1-1.3); corr 1 is
    # launched in a seed span but runs before the window
    assert w.kernel_seconds("seed_device") == pytest.approx(0.1)
    # ext_device: corr 3 (thread 11 at 1.25); the memcpy launched at 2.2
    # in thread 11's collect counts for neither
    assert w.kernel_seconds("ext_device") == pytest.approx(0.2)
    # collect: corr 2, 3 and 6 (corr 4 came from the unpaired thread 10)
    assert w.kernel_seconds("collect") == pytest.approx(0.4)


# the ids the child recorded for each thread (child.thread_ids)
THREADS = {"11": [11, 1811941696], "12": [12, 124791104],
           "10": [10, 805308736, 4489], "main": [77, 4480]}


def test_profiler_thread_ids_are_paired_by_recorded_ids():
    names = {11: 1811941696, 12: 124791104, 10: 4489}
    w = _win(trace=_relabel(TRACE, names), threads=THREADS)
    assert w.thread_map() == {"1811941696": "11", "124791104": "12",
                              "4489": "10"}
    assert w.unpaired_ops() == [0, 0.0]
    assert w.kernel_seconds("seed_device") == pytest.approx(0.1)
    assert w.kernel_seconds("ext_device") == pytest.approx(0.2)
    # the child's main thread launches too (a synchronize): known, unused
    tr = _relabel(TRACE, names)
    tr["launches"].append([9, 4480, 3.5])
    w = _win(trace=tr, threads=THREADS)
    assert w.thread_map()["4480"] == "main"
    assert w.kernel_seconds("ext_device") == pytest.approx(0.2)


def test_unpaired_launch_thread_reads_nothing():
    # thread 12's launches come under an id the child never recorded: its
    # seed kernel at 1.15-1.25 could be anyone's, so the kernel metrics
    # read nothing, whatever the label
    w = _win(trace=_relabel(TRACE, {11: 11, 12: 999, 10: 10}),
             threads=THREADS)
    assert "999" not in w.thread_map()
    n, sec = w.unpaired_ops()
    assert n == 2 and sec == pytest.approx(0.2)
    assert w.kernel_seconds("seed_device") is None
    assert w.kernel_seconds("ext_device") is None
    # busy time and idle gaps need no pairing
    assert w.busy_s() == pytest.approx(0.5)
    # an unknown thread whose operations all lie outside the traced
    # window takes nothing away
    tr = _relabel(TRACE, {11: 11, 12: 12, 10: 10})
    tr["launches"].append([5, 999, 2.2])
    tr["launches"] = [x for x in tr["launches"] if x[:2] != [5, 11]]
    w = _win(trace=tr, threads=THREADS)
    assert w.unpaired_ops() == [0, 0.0]
    assert w.kernel_seconds("ext_device") == pytest.approx(0.2)


def test_no_trace_reads_nothing():
    w = _win(trace=None)
    assert w.busy_s() is None and w.kernel_seconds("seed_device") is None
    assert w.top_device_ops() == [] and w.idle_by_host_activity() == []
    assert w.cpu_seconds() == pytest.approx(2.5)


def test_metric_readers(tmp_path):
    from pbcore import registry

    w = _win()
    vals = {m: registry.metric(m).read(w) for m in (
        "runtime.collect_ms_per_kread", "aligner.seed_ms_per_kread",
        "kernels.seed_dev_ms_per_kread", "device.idle_share",
        "host.cpu_ms_per_kread", "pairing.rescue_ms_per_kread")}
    assert vals["runtime.collect_ms_per_kread"] == pytest.approx(1750.0)
    assert vals["aligner.seed_ms_per_kread"] == pytest.approx(100.0)
    assert vals["kernels.seed_dev_ms_per_kread"] == pytest.approx(50.0)
    assert vals["device.idle_share"] == pytest.approx(100 * 2.1 / 2.6)
    assert vals["host.cpu_ms_per_kread"] == pytest.approx(1250.0)
    assert vals["pairing.rescue_ms_per_kread"] is None
    assert registry.metric("device.idle_share").read(_win(trace=None)) is None


MEM_VARIANTS = sorted(m["name"] for m in json.loads(
    (PB.parent / "BENCHMARK.json").read_text())["per_layer"]
    if m["name"].endswith(".mem"))


@pytest.mark.parametrize("name", MEM_VARIANTS)
def test_mem_variants_read_as_the_metrics_they_stand_for(name):
    # the cells that hold reads_per_s per layer report each per-layer
    # metric under a name that moves device_mem_peak_mib; the reading is
    # the same
    from pbcore import registry

    spans = SPANS + [("pe_rescue", 11, 1.4, 2.0)]
    mod = registry.metric(name)
    assert mod.MOVES == "device_mem_peak_mib"
    if name == "runtime.reads_per_s.mem":
        # 2,000 reads over the window's 2.6 s
        assert mod.read(_win()) == pytest.approx(2000 / 2.6)
        assert mod.read(_win(reads=0)) is None
        return
    for w in (_win(), _win(spans=spans), _win(trace=None), _win(reads=0)):
        assert mod.read(w) == registry.metric(name[:-4]).read(w)


def test_read_trace_converts_clocks(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({
        "baseTimeNanoseconds": 1_000_000_000_000,
        "traceEvents": [
            {"ph": "X", "cat": "kernel", "name": "k", "ts": 2_000_000.0,
             "dur": 500.0, "args": {"correlation": 7}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": 1_999_000.0, "dur": 5.0, "tid": 42,
             "args": {"correlation": 7}},
            {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0},
            {"ph": "M", "name": "thread_name"}]}))
    # epoch us = 1e9 + ts; monotonic = epoch - offset
    tr = child.read_trace(p, offset_us=1_000_000_000.0)
    assert tr["names"] == ["k"]
    assert tr["ops"] == [[0, pytest.approx(2.0), pytest.approx(2.0005), 7]]
    assert tr["launches"] == [[7, 42, pytest.approx(1.999)]]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    for name in ("bwamem_tpu_torch", "bwamem_tpu_torch.cli", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert child.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bwamem_tpu.ops",
                        types.ModuleType("bwamem_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert child.forbidden_modules() == ["bwamem_tpu.ops", "jax"]
