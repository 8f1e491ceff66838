"""Whole runs of a tiny cell on the CPU (the chip check skipped, the port
on --device cpu): a sound run is correct and its records are checked;
the control (the reference's DP on 8-bit cells in the program's place)
and each fault the cell can have, planted in the timed path (mate rescue
switched off among them), come out not correct. A one-card benchmark has no exchange between chips to leave out.
"""
import pytest

from pbtest_helpers import PB, cpu_run, make_base

from pbcore import reference


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("portbench")
    return root, root / "cache"


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_sound_run_is_correct(world, paired):
    root, cache = world
    bench, base = make_base(root, paired)
    out = cpu_run(bench, base, cache, seed=2**31 + 11, trace=True)
    r = out.result
    assert r["correct"], r["checks"]
    assert r["readings"]["checked"] >= 40 and r["attempted"] > 200
    assert list(r)[-1] == "checks"
    m = r["metrics"]
    assert m["runtime.collect_ms_per_kread"]["value"] > 0
    assert 0 < m["aligner.seed_ms_per_kread"]["value"] < \
        m["runtime.collect_ms_per_kread"]["value"], m
    assert ("pairing.rescue_ms_per_kread" in m) == paired
    # every unseedable mate of the window is judged
    assert ("rescue_missed" in r["checks"]) == paired
    assert r["readings"].get("rescue_judged", 0) >= (10 if paired else 0)
    # no device on the CPU: the device metrics read nothing
    assert "device.idle_share" not in m


def test_end_to_end_metrics(world):
    root, cache = world
    bench, base = make_base(root, False)
    r = cpu_run(bench, base, cache, seed=3).result
    assert r["correct"]
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["metrics"]["reads_per_s"]["value"] > 0


def test_control_is_not_correct(world):
    root, cache = world
    bench, base = make_base(root, False)
    out = cpu_run(bench, base, cache, seed=4)
    ctl = reference.judge(out.genome, out.sample, out.scoring,
                          replace_as=reference.control_as(
                              out.genome, out.sample, out.scoring, 8))
    assert out.result["correct"]
    assert ctl["tags_wrong"] > out.limits["tags_wrong"]


@pytest.mark.parametrize("fault", ["half", "stale", "alter", "norescue"])
def test_fault_is_not_correct(world, fault):
    root, cache = world
    bench, base = make_base(root, fault in ("stale", "norescue"))
    out = cpu_run(bench, base, cache, seed=6,
                  child=PB / "tests/fault_child.py",
                  env={"PORTBENCH_FAULT": fault})
    checks = out.result["checks"]
    assert not out.result["correct"], checks
    if fault == "norescue":
        # only rescue places the unseedable mates, and only this number
        # judges every one of them
        assert checks["rescue_missed"]["value"] >= 10, checks
