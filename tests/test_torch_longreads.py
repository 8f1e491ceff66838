"""Long reads, the seed filters and the per-seed-object path through the
port's CLI on the CPU, against the JAX package's CLI on the same index and
reads: the SAM is identical apart from the @PG line for
  * 1 kb reads at the default flags (the native path with the per-seed SW
    filter, reads of 500 bp or more);
  * -F (the SHD filter) on 150 bp reads, single- and paired-end;
  * 250 bp reads under --vanilla (opt_ext with a band window narrower
    than the dense row: the banded kernel's routing on the card);
  * -x pacbio on 1 kb reads with 10% noise (-W 40: the object path);
  * -W 30 and -v 4 on short reads (the object path)."""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tests.test_torch_index import native_lib  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 100 kb repeat-rich genome, its index (built by the port's CLI)
    and the reads of every case."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads,
                                                  write_fasta, write_fastq)

    d = tmp_path_factory.mktemp("long")
    rng = np.random.default_rng(61)
    contigs, _ = make_repeat_genome(rng, 100_000, n_contigs=1)
    write_fasta(str(d / "ref.fa"), contigs)
    for name, n, ln, noise in (("long", 10, 1000, (0.01, 0.002, 0.002)),
                               ("pacbio", 6, 1000, (0.04, 0.03, 0.03)),
                               ("r250", 24, 250, (0.01, 0.0, 0.0)),
                               ("r150", 40, 150, (0.01, 0.002, 0.002))):
        sub, ins, dele = noise
        write_fastq(str(d / f"{name}.fq"), simulate_reads(
            rng, contigs, n, read_len=ln, sub=sub, ins=ins, dele=dele,
            prefix=name))
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    chip_smoke.make_pairs(str(d), g, 16, 62, victim_every=4)
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


CASES = {
    "long_default": (["long.fq"], []),
    "shd_se": (["r150.fq"], ["-F"]),
    "shd_pe": (["r1.fq", "r2.fq"], ["-F"]),
    "vanilla_250": (["r250.fq"], ["--vanilla"]),
    "pacbio": (["pacbio.fq"], ["-x", "pacbio"]),
    "min_chain_weight": (["r150.fq"], ["-W", "30"]),
    "verbose_4": (["r150.fq"], ["-v", "4"]),
}


def _records(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith("@PG")]


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(world, case, monkeypatch):
    from bwamem_tpu.cli import main as jax_main
    from bwamem_tpu_torch.cli import main as port_main

    monkeypatch.chdir(world)  # both CLIs append to ./time.log
    files, flags = CASES[case]
    inputs = [str(world / f) for f in files]
    outs = {}
    for tool, main in (("jax", jax_main), ("port", port_main)):
        out = world / f"{case}_{tool}.sam"
        dev = ["--device", "cpu"] if tool == "port" else []
        assert main(["align", *dev, "-t", "1", *flags, str(world / "idx"),
                     *inputs, "-o", str(out)]) == 0
        outs[tool] = _records(out)
    body = [ln.split("\t") for ln in outs["port"] if not ln.startswith("@")]
    assert len(body) >= 6
    assert sum(not int(f[1]) & 4 for f in body) >= 0.9 * len(body)
    assert outs["port"] == outs["jax"]

