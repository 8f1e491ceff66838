"""BENCHMARK.json against the benchmark's contract, and the harness
finding a new configuration, traffic mix, cell and per-layer metric by
name when they are added as files."""
import json
import re

import numpy as np

from pbtest_helpers import PB
from pbcore import registry
from pbcore.window import Window

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((PB.parent / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and \
            _line(c["source"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert all(k in cfg["reduced_from_source"] for k in c["reduced"])
        names.add(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        registry.traffic(w["traffic"])
        assert set(registry.limits(w["name"])) >= {
            "records_wrong", "order_wrong", "tags_wrong"}
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        mod = registry.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                   m["moves"])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in registry.end_to_end_for(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = registry.per_layer_for(BENCH, w["name"])
        assert per_layer
        # a per-layer metric moves an end-to-end metric of its cell
        assert all(m["moves"] in e2e for m in per_layer), w["name"]


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "pb"
    for d in ("configs", "traffic", "limits", "metrics"):
        (base / d).mkdir(parents=True)
    (base / "configs/yeast.json").write_text(json.dumps(
        {"name": "yeast", "genome": {"length_bp": 12_000_000}}))
    (base / "traffic/se100.json").write_text(json.dumps(
        {"name": "se100", "read_len": 100, "paired": False}))
    (base / "limits/yeast.se100.json").write_text(json.dumps(
        {"records_wrong": 0}))
    (base / "metrics/runtime.write_ms_per_kread.py").write_text(
        'LAYER = "cli and pipeline/runtime"\nUNIT = "ms/kread"\n'
        'MOVES = "reads_per_s"\n\n\ndef read(w):\n'
        '    return w.per_kread_ms(w.span_seconds("sam_write"))\n')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "yeast.se100", "config": "yeast",
                               "traffic": "se100", "chips": 1, "why": "t"})
    bench["per_layer"].append({
        "name": "runtime.write_ms_per_kread", "unit": "ms/kread",
        "better": "lower", "source": "program_span",
        "layer": "cli and pipeline/runtime", "moves": "reads_per_s",
        "workloads": ["yeast.se100"]})
    c = registry.cell(bench, "yeast.se100")
    assert registry.config(c["config"], base)["genome"]["length_bp"] == 12e6
    assert registry.traffic(c["traffic"], base)["read_len"] == 100
    assert registry.limits("yeast.se100", base) == {"records_wrong": 0}
    names = [m["name"] for m in registry.per_layer_for(bench, "yeast.se100")]
    assert "runtime.write_ms_per_kread" in names
    assert "pairing.rescue_ms_per_kread" not in names
    assert "runtime.write_ms_per_kread" not in [
        m["name"] for m in registry.per_layer_for(bench, "chr21.se150")]
    mod = registry.metric("runtime.write_ms_per_kread", base)
    w = Window(0.0, 2.0, 1000, [("sam_write", 1, 0.5, 0.75)])
    assert np.isclose(mod.read(w), 250.0)
