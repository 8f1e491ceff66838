"""chip_smoke.py rehearsed on the CPU at a small size (its phases with the
kernels' plain versions and --device cpu, SE and PE), plus its refusal to
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


def test_kernel_phase_on_cpu():
    rec = chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=48, TMAX=96), timed=False)
    assert rec == dict(max_abs_err=0, ms=None, plain_ms=None)


def test_sw_kernel_phase_on_cpu():
    rec = chip_smoke.sw_kernel_phase(
        "cpu", dict(N=200, QMAX=48, TMAX=96), timed=False)
    assert rec == dict(max_abs_err=0, ms=None, plain_ms=None)


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
