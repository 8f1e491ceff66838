"""End-to-end SE alignment through the port on the CPU: SAM byte-identical
to the golden snapshot of the JAX package, and to the JAX MemAligner on a
second fixture (two contigs of a repeat-rich genome, both strands,
substitutions, indels and N bases) through the port's CLI at -t 1 and -t 2
(apart from the @PG line)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_golden import DATA, _se_reads, _world
from tests.test_torch_index import SUBPROCESS_ENV
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")


def test_golden_se_byte_identical():
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions

    g, idx = _world()
    al = MemAligner(MemOptions(), idx, device="cpu")
    se = al.align_batch(*_se_reads(g))
    with open(os.path.join(DATA, "golden_se.sam")) as f:
        assert f.read().splitlines() == se
    assert al.stats["n_reads"] == 48 and al.stats["n_extensions"] > 48


@pytest.fixture(scope="module")
def fixture2(tmp_path_factory):
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads,
                                                  write_fasta, write_fastq)

    d = tmp_path_factory.mktemp("se2")
    rng = np.random.default_rng(31)
    contigs, _ = make_repeat_genome(rng, 120_000, n_contigs=2)
    write_fasta(str(d / "ref.fa"), contigs)
    reads = simulate_reads(rng, contigs, 80, read_len=150, sub=0.01,
                           ins=0.002, dele=0.002)
    write_fastq(str(d / "r.fq"), reads)
    env = SUBPROCESS_ENV
    subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index",
                    str(d / "ref.fa"), "-p", str(d / "idx")], check=True,
                   env=env, capture_output=True, timeout=300)
    return d, env


def _records(lines):
    return [ln for ln in lines if not ln.startswith("@PG")]


def _jax_sam(d):
    from bwamem_tpu.index.format import FMIndex
    from bwamem_tpu.io.fastx import read_fastx
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    idx = FMIndex.load(str(d / "idx.bmt"))
    recs = list(read_fastx(str(d / "r.fq")))
    sam = MemAligner(MemOptions(), idx).align_batch(
        [r.name for r in recs], [r.seq for r in recs],
        [r.qual for r in recs])
    sq = [f"@SQ\tSN:{n}\tLN:{l}"
          for n, l in zip(idx.ann.names, idx.ann.lengths)]
    return sq + sam


@pytest.fixture(scope="module")
def jax_sam(fixture2):
    return _jax_sam(fixture2[0])


@pytest.mark.parametrize("threads", [1, 2])
def test_cli_matches_jax_aligner(fixture2, jax_sam, threads):
    d, env = fixture2
    out = d / f"out_t{threads}.sam"
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "align", "--device",
         "cpu", "-t", str(threads), str(d / "idx"), str(d / "r.fq"), "-o",
         str(out)], env=env, capture_output=True, text=True, timeout=300,
        cwd=str(d))
    assert res.returncode == 0, res.stderr
    got = out.read_text().splitlines()
    assert any(ln.startswith("@PG\tID:bwamem-tpu-torch") for ln in got)
    assert _records(got) == jax_sam
    flags = {int(ln.split("\t")[1]) & 16 for ln in got
             if not ln.startswith("@")}
    assert flags == {0, 16}  # both strands aligned


def test_unported_inputs_raise(fixture2):
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions

    d, env = fixture2
    idx = FMIndex.load(str(d / "idx.bmt"))
    seq = np.zeros(150, np.uint8)
    for field, value in (("seed_type", 2), ("re_seed", True),
                         ("shd_filter", True)):
        opt = MemOptions()
        setattr(opt, field, value)
        with pytest.raises(NotImplementedError):
            MemAligner(opt, idx, device="cpu").align_batch(["r"], [seq])
    al = MemAligner(MemOptions(), idx, device="cpu")
    with pytest.raises(NotImplementedError):
        al.align_batch(["r"], [np.zeros(600, np.uint8)])
    for flags in (["--n-chips", "2"], ["-F"]):
        res = subprocess.run(
            [sys.executable, "-m", "bwamem_tpu_torch", "align", "--device",
             "cpu", *flags, str(d / "idx"), str(d / "r.fq"), str(d / "r.fq")],
            env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 1 and "not ported yet" in res.stderr, flags


def test_cuda_device_without_gpu_exits(fixture2):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    d, env = fixture2
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "align", str(d / "idx"),
         str(d / "r.fq")], env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and not res.stdout.strip("\n@")
