"""Everything the harness finds by name: `BENCHMARK.json` at the checkout's
root, `configs/<name>.json`, `traffic/<name>.json`, `limits/<cell>.json`
and `metrics/<name>.py` under the benchmark's folder. A new
configuration, traffic mix, cell or per-layer metric is a new file.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(base: Path, kind: str, name: str) -> dict:
    path = base / kind / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def config(name: str, base: Path = BASE) -> dict:
    return _json(base, "configs", name)


def traffic(name: str, base: Path = BASE) -> dict:
    return _json(base, "traffic", name)


def limits(cell_name: str, base: Path = BASE) -> dict:
    return _json(base, "limits", cell_name)


def metric(name: str, base: Path = BASE):
    """The reader module of per-layer metric `name`: it defines LAYER,
    UNIT, MOVES and read(window) -> number or None."""
    path = base / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_for(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    with no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in e2e)]


def end_to_end_for(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]
