"""The port never imports jax or the JAX package, not even indirectly: in a
subprocess whose import system refuses `jax*` and `bwamem_tpu` (but not
`bwamem_tpu_torch`), import every module of the port, build an index,
align single-end reads with --device cpu through the CLI, align pairs
from two files whose victims (read 2 without a seed) only mate rescue can
place, align with -F (the SHD filter) and align 1 kb reads with -x pacbio
(the per-seed SW filter and the per-seed-object path): those paths import
inside functions, so only runs of them can show that none reaches jax."""
import subprocess
import sys
import textwrap

import pytest

from tests.test_torch_index import SUBPROCESS_ENV
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")


SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.abc, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top == "jax" or top.startswith("jax") or top == "bwamem_tpu":
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    import bwamem_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        bwamem_tpu_torch.__path__, "bwamem_tpu_torch.")]
    for m in mods:
        if m != "bwamem_tpu_torch.__main__":
            importlib.import_module(m)

    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.utils.simgenome import (
        make_repeat_genome, simulate_reads, write_fasta, write_fastq)
    d = sys.argv[1]
    rng = np.random.default_rng(3)
    contigs, _ = make_repeat_genome(rng, 30_000, n_contigs=1)
    write_fasta(d + "/ref.fa", contigs)
    write_fastq(d + "/r.fq", simulate_reads(rng, contigs, 12))
    assert main(["index", d + "/ref.fa", "-p", d + "/idx"]) == 0
    assert main(["align", "--device", "cpu", d + "/idx", d + "/r.fq",
                 "-o", d + "/out.sam"]) == 0
    assert main(["align", "--device", "cpu", "-F", d + "/idx", d + "/r.fq",
                 "-o", d + "/shd.sam"]) == 0
    write_fastq(d + "/long.fq", simulate_reads(
        rng, contigs, 3, read_len=1000, sub=0.04, ins=0.03, dele=0.03))
    assert main(["align", "--device", "cpu", "-x", "pacbio", d + "/idx",
                 d + "/long.fq", "-o", d + "/pb.sam"]) == 0

    import chip_smoke
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    chip_smoke.make_pairs(d, g, 24, 4, victim_every=6)
    assert main(["align", "--device", "cpu", d + "/idx", d + "/r1.fq",
                 d + "/r2.fq", "-o", d + "/pe.sam"]) == 0
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] == "bwamem_tpu" or m.startswith("jax"))
    assert not bad, bad
    print("modules", len(mods))
""")


def test_port_runs_with_jax_refused(tmp_path):
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         env=SUBPROCESS_ENV, capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split("modules")[-1]) > 20
    sam = (tmp_path / "out.sam").read_text().splitlines()
    recs = [ln for ln in sam if not ln.startswith("@")]
    assert len(recs) >= 12
    assert sum(ln.split("\t")[2] != "*" for ln in recs) >= 11
    pe = [ln.split("\t") for ln in
          (tmp_path / "pe.sam").read_text().splitlines()
          if not ln.startswith("@")]
    victims = [f for f in pe if f[0].endswith("_1")
               and int(f[1]) & 0x80 and not int(f[1]) & 0x900]
    assert len(victims) == 4
    assert all(not int(f[1]) & 4 for f in victims)  # placed by rescue
    for name, n in (("shd.sam", 11), ("pb.sam", 3)):
        recs = [ln.split("\t") for ln in
                (tmp_path / name).read_text().splitlines()
                if not ln.startswith("@")]
        assert sum(f[2] != "*" for f in recs) >= n, name
