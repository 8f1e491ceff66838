"""The port's `fastmap` and `ingest` subcommands against the JAX CLI's.

fastmap: the text (SQ / EM / // lines) equals the JAX CLI's on the CPU, at
the default -l/-w and at -l 25 -w 5 -p, on reads of a repeat-rich genome
(so that some SMEMs have more occurrences than -w and print '*').
ingest: on a reference-format index built by the reference's own binaries
(the skip of tests/test_index_ingest.py: they are not in every image), the
port's CLI writes the index the JAX CLI writes; without input files it
fails with one line, as the JAX CLI does."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_index_ingest import REF_BWA
from tests.test_index_ingest import ref_index  # noqa: F401
from tests.test_torch_index import SUBPROCESS_ENV
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 60 kb repeat-rich genome indexed by the port's CLI and 50 reads of
    70-150 bp on both strands (1% substitutions, 0.2% indels)."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads,
                                                  write_fasta, write_fastq)

    d = tmp_path_factory.mktemp("fastmap")
    rng = np.random.default_rng(91)
    contigs, _ = make_repeat_genome(rng, 60_000, n_contigs=2)
    write_fasta(str(d / "ref.fa"), contigs)
    recs = []
    for ln in (70, 150):
        recs += simulate_reads(rng, contigs, 25, read_len=ln, sub=0.01,
                               ins=0.002, dele=0.002, prefix=f"r{ln}")
    write_fastq(str(d / "r.fq"), recs)
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


@pytest.mark.parametrize("flags", [[], ["-l", "25", "-w", "5", "-p"]],
                         ids=["default", "l25_w5_p"])
def test_fastmap_matches_jax(world, flags, capsys):
    from bwamem_tpu.cli import main as jax_main
    from bwamem_tpu_torch.cli import main as port_main

    args = [*flags, str(world / "idx"), str(world / "r.fq")]
    assert jax_main(["fastmap", *args]) == 0
    want = capsys.readouterr().out
    assert port_main(["fastmap", "--device", "cpu", *args]) == 0
    got = capsys.readouterr().out
    lines = got.splitlines()
    assert sum(ln.startswith("SQ") for ln in lines) == 50
    assert sum(ln.startswith("EM") for ln in lines) >= 50
    assert any(ln.endswith("\t*") for ln in lines)  # above -w
    assert got == want


def test_fastmap_cuda_device_without_gpu_exits(world):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "fastmap",
         str(world / "idx"), str(world / "r.fq")], env=SUBPROCESS_ENV,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and not res.stdout


def test_ingest_without_files_fails_in_one_line(tmp_path):
    from bwamem_tpu_torch.cli import main

    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "ingest",
         str(tmp_path / "absent")], env=SUBPROCESS_ENV, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 1
    assert res.stderr.startswith("[bwamem-tpu-torch] error:")
    assert len(res.stderr.splitlines()) == 1
    assert main(["ingest", str(tmp_path / "absent")]) == 1


@pytest.mark.skipif(not os.path.exists(REF_BWA),
                    reason="reference bwa binary not present")
def test_cli_ingest_matches_jax(ref_index, tmp_path):  # noqa: F811
    from bwamem_tpu_torch.index.format import FMIndex

    d, pfx, fa = ref_index
    for pkg in ("bwamem_tpu", "bwamem_tpu_torch"):
        res = subprocess.run(
            [sys.executable, "-m", pkg, "ingest", pfx, "-p",
             str(tmp_path / pkg)], env={**SUBPROCESS_ENV,
                                        "JAX_PLATFORMS": "cpu"},
            capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-500:]
    a = np.load(str(tmp_path / "bwamem_tpu") + ".bmt.npz")
    b = np.load(str(tmp_path / "bwamem_tpu_torch") + ".bmt.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert FMIndex.load(str(tmp_path / "bwamem_tpu_torch") + ".bmt").l_pac
