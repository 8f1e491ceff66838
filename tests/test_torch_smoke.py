"""chip_smoke.py rehearsed on the CPU at a small size (its phases with the
kernels' plain versions and --device cpu: SE, PE, long reads, --vanilla,
-F, -x pacbio, the seeding variants, fastmap and the 16-bit probe), plus
its refusal to
run — and to print a result — without a CUDA device or outside the
repository."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tests.test_torch_index import SUBPROCESS_ENV  # noqa: E402
from tests.test_torch_index import native_lib  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("native_lib")


def _check_rec(rec):
    assert {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms")} == dict(
        max_abs_err=0, ms=None, plain_ms=None)
    assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                       "operations")


def test_kernel_phase_on_cpu():
    _check_rec(chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=48, TMAX=96), timed=False))


def test_sw_kernel_phase_on_cpu():
    _check_rec(chip_smoke.sw_kernel_phase(
        "cpu", dict(N=200, QMAX=48, TMAX=96), timed=False))


def test_pacbio_kernel_phase_on_cpu():
    _check_rec(chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=64, TMAX=256, tail=256), timed=False,
        variants=[(False, 0)], scoring=chip_smoke.PACBIO))


@pytest.mark.parametrize("scoring", [None, chip_smoke.PACBIO])
def test_seed_filter_sw_kernel_phase_on_cpu(scoring):
    _check_rec(chip_smoke.sw_kernel_phase(
        "cpu", dict(N=200, QMAX=200, TMAX=200), timed=False,
        variants=[(0, 0)], product=(0, 0), jobs=chip_smoke.make_filter_jobs,
        scoring=scoring, label="seed filter"))


def test_banded_kernel_phase_on_cpu():
    _check_rec(chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=300, TMAX=360), timed=False, kernel="K3",
        variants=[(40, 0), (40, 30)]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world"))
    chip_smoke.make_world(d, genome_len=200_000, n_reads=300, n_pairs=128)
    subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index", "-r",
                    "4", os.path.join(d, "ref.fa"), "-p",
                    os.path.join(d, "idx")], check=True, timeout=300,
                   capture_output=True, env=SUBPROCESS_ENV)
    return d


def test_world_and_align_phases_on_cpu(world):
    launches, rate = chip_smoke.align_phase(world, device="cpu",
                                            chunk_reads=128)
    assert launches == 0 and rate > 0  # CPU tensors never launch K1


def test_pe_align_phase_on_cpu(world, monkeypatch):
    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    k1, k2, rate = chip_smoke.pe_align_phase(world, device="cpu",
                                             chunk_pairs=64)
    assert k1 == k2 == 0 and rate > 0  # CPU tensors launch no kernel


def test_long_read_phases_on_cpu(world, monkeypatch):
    """Phases 6-8 at a tiny size, with their SAM checks against a second
    CPU run; CPU tensors launch no kernel."""
    from bwamem_tpu_torch.io.fastx import read_fastx

    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    contigs = [(r.name, "".join("ACGTN"[c] for c in r.seq))
               for r in read_fastx(os.path.join(world, "ref.fa"))]
    runs = chip_smoke.long_read_phases(world, contigs, device="cpu",
                                       sizes=(4, 16, 32, 4),
                                       heads=(2, 8, 16, 2))
    assert set(runs) == {"long", "vanilla", "shd", "pacbio"}
    for r in runs.values():
        assert r["K1"] == r["K2"] == r["K3"] == 0 and r["reads_per_s"] > 0


def test_probe_kernel_phase_on_cpu():
    rec = chip_smoke.probe_kernel_phase("cpu", [(8, 128), (64, 130)],
                                        timed=False)
    _check_rec(rec)
    assert rec["library_ms"] is None and rec["bound_by"] == "bytes"


def test_variant_and_fastmap_phases_on_cpu(world, monkeypatch):
    """Phases 9 and 10 at a tiny size, with their checks against a second
    CPU run; CPU tensors launch no kernel."""
    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    runs = chip_smoke.variant_phases(world, device="cpu", sizes=(48, 16),
                                     heads=(12, 6))
    assert set(runs) == {"u2", "u3", "g", "u4"}
    for r in runs.values():
        assert r["K1"] == r["K2"] == r["K3"] == 0 and r["reads_per_s"] > 0
    assert chip_smoke.fastmap_phase(world, device="cpu", n_head=10) > 0


def test_probe_phase_on_cpu(capsys):
    assert chip_smoke.probe_phase("cpu") == 0  # the plain versions
    out = capsys.readouterr().out
    assert out.count("  PASS ") == 6 and "  VERDICT: " in out


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu_or_repo(tmp_path, alone):
    import torch

    if torch.cuda.is_available() and not alone:
        pytest.skip("a GPU is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in SUBPROCESS_ENV.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
