"""The route without the native C++ core, the JAX package's own: with
`loader.try_load` patched to return None, MemAligner collects through the
per-seed-object path (Python chaining, the filters, extension tiles) and
finalizes SE reads with mem_mark_primary_se + samgen and PE pairs with
the pairing module's Python planner. Seeding and the extension still run
on the aligner's device. SE and PE SAM equal the native route's, through
the aligner and through the CLI, on a repeat-rich genome with mate-rescue
victims; and -g with the core missing equals -g with it."""
import numpy as np
import pytest

import chip_smoke
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 60 kb repeat-rich genome, 40 SE reads of 150 bp (1%
    substitutions, 0.2% indels) and 16 FR pairs with 4 victims (read 2
    unseedable), indexed by the port's CLI."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads,
                                                  write_fasta, write_fastq)

    d = tmp_path_factory.mktemp("nonative")
    rng = np.random.default_rng(5)
    contigs, _ = make_repeat_genome(rng, 60_000, n_contigs=1)
    write_fasta(str(d / "ref.fa"), contigs)
    write_fastq(str(d / "r.fq"), simulate_reads(
        rng, contigs, 40, read_len=150, sub=0.01, ins=0.002, dele=0.002))
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    chip_smoke.make_pairs(str(d), g, 16, 9, victim_every=4)
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


def _align(d, files, flags, tag):
    from bwamem_tpu_torch.cli import main

    out = d / f"{tag}.sam"
    assert main(["align", "--device", "cpu", "-t", "1", *flags,
                 str(d / "idx"), *(str(d / f) for f in files),
                 "-o", str(out)]) == 0
    return [ln for ln in out.read_text().splitlines()
            if not ln.startswith("@PG")]


@pytest.mark.parametrize("case,files,flags", [
    ("se", ["r.fq"], []), ("pe", ["r1.fq", "r2.fq"], []),
    ("g", ["r.fq"], ["-g"])])
def test_cli_without_native_matches_native(world, monkeypatch, case, files,
                                           flags):
    from bwamem_tpu_torch.native import loader

    want = _align(world, files, flags, f"{case}_native")
    calls = []

    def missing():
        calls.append(1)
        return None

    monkeypatch.setattr(loader, "try_load", missing)
    got = _align(world, files, flags, f"{case}_python")
    assert calls  # the route asked for the core and went without it
    body = [ln.split("\t") for ln in got if not ln.startswith("@")]
    assert len(body) >= 32
    assert sum(not int(f[1]) & 4 for f in body) >= 0.8 * len(body)
    assert got == want


def test_aligner_without_native_matches_native(world, monkeypatch):
    """MemAligner.align_batch and align_pairs_batch: _collect_native
    returns None and emit_sam_batch takes samgen."""
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.io.fastx import read_fastx
    from bwamem_tpu_torch.native import loader
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions

    idx = FMIndex.load(str(world / "idx.bmt"))
    se = list(read_fastx(str(world / "r.fq")))
    pe = [r for pair in zip(read_fastx(str(world / "r1.fq")),
                            read_fastx(str(world / "r2.fq"))) for r in pair]

    def run():
        al = MemAligner(MemOptions(), idx, device="cpu")
        a = al.align_batch([r.name for r in se], [r.seq for r in se])
        b = al.align_pairs_batch([r.name for r in pe], [r.seq for r in pe])
        return a, b

    want = run()
    monkeypatch.setattr(loader, "try_load", lambda: None)
    al = MemAligner(MemOptions(), idx, device="cpu")
    seeds = al.seed_batch_arrays([r.seq for r in se])
    assert al._collect_native([r.seq for r in se], seeds) is None
    assert run() == want
