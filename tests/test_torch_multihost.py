"""Multi-host align through the port's CLI (--device cpu), the twin of
tests/test_multihost.py: W processes each align a contiguous record
range into `<out>.shard<r>`, host 0 merges the shards, and the merged SAM
is byte-identical (apart from @PG, whose command line differs) to the
one-host run's:

  * SE at world 2 with a coordinator (the hosts join a Gloo process
    group) and at world 4 without one (a filesystem-only launch: the
    remainder of the range split and a 4-way merge);
  * PE under a fixed insert model (-I; pestat runs per host and per
    chunk, as it does per chunk in one host) at (world, cards) (2, 1),
    (4, 1) and (2, 2), the last over a mesh of two CPU shards a host;
  * a repeat-rich genome at world 2, where every host restarts the read
    counter that breaks score ties (pipeline/runtime.py), as the JAX CLI
    does: the merged SAM equals the JAX CLI's merged SAM;
  * a failed Gloo join exits nonzero;
  * the record-range unit cases of the JAX test, on the port's copy."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bwamem_tpu_torch.parallel.multihost import record_range, take_range
from tests.test_torch_index import SUBPROCESS_ENV
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = dict(SUBPROCESS_ENV, JAX_PLATFORMS="cpu")


def test_record_range_even():
    assert record_range(100, 0, 2) == (0, 50)
    assert record_range(100, 1, 2) == (50, 100)


def test_record_range_remainder():
    spans = [record_range(103, r, 4) for r in range(4)]
    assert spans[0][0] == 0 and spans[-1][1] == 103
    for a, b in zip(spans, spans[1:]):
        assert a[1] == b[0]
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1


def test_record_range_paired_granularity():
    for n in (10, 14, 22, 30):
        for w in (2, 3):
            for r in range(w):
                lo, hi = record_range(n, r, w, granularity=2)
                assert lo % 2 == 0 and (hi % 2 == 0 or hi == n)


def test_take_range():
    assert list(take_range(iter(range(10)), 3, 7)) == [3, 4, 5, 6]
    assert list(take_range(iter(range(4)), 0, 4)) == [0, 1, 2, 3]
    assert list(take_range(iter(range(4)), 4, 4)) == []


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """tests/test_multihost.py's fixture: a 40 kb random genome, 48 SE
    reads of 100 bp with one substitution, 24 FR pairs (insert 300),
    indexed by the port's CLI."""
    from bwamem_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("tmh")
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 40000)
    bases = "ACGT"
    s = "".join(bases[c] for c in g)
    (d / "ref.fa").write_text(
        ">chr1\n" + "\n".join(s[i:i + 70] for i in range(0, len(s), 70))
        + "\n")
    with open(d / "se.fq", "w") as fq:
        for i in range(48):
            p = int(rng.integers(0, 40000 - 120))
            r = list(s[p:p + 100])
            r[int(rng.integers(0, 100))] = bases[int(rng.integers(0, 4))]
            fq.write(f"@s{i}\n{''.join(r)}\n+\n{'I' * 100}\n")
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(24):
            p = int(rng.integers(0, 40000 - 320))
            a = s[p:p + 100]
            b = "".join("TGCA"[c] for c in g[p + 200:p + 300][::-1])
            f1.write(f"@p{i}\n{a}\n+\n{'I' * 100}\n")
            f2.write(f"@p{i}\n{b}\n+\n{'I' * 100}\n")
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


def _align(extra, out, tool="bwamem_tpu_torch"):
    dev = ["--device", "cpu"] if tool == "bwamem_tpu_torch" else []
    return subprocess.Popen(
        [sys.executable, "-m", tool, "align", *dev, *extra, "-o", str(out)],
        env=SUBPROCESS_ENV if tool == "bwamem_tpu_torch" else JAX_ENV,
        cwd=str(out.parent), stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=600):
    for p in procs:
        err = p.communicate(timeout=timeout)[1]
        assert p.returncode == 0, err[-1500:]


def _records(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@PG")]


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _hosts(base, out, world, extra=(), tool="bwamem_tpu_torch"):
    return [_align([*base, "--n-hosts", str(world), "--host-id", str(r),
                    *extra], out, tool) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_se_parity(fixture_dir, world):
    d = fixture_dir
    base = [str(d / "idx"), str(d / "se.fq")]
    out = d / f"mh_se_{world}.sam"
    ref = d / f"ref_se_{world}.sam"
    extra = (["--coordinator", f"127.0.0.1:{_free_port()}"]
             if world == 2 else [])
    _wait([_align(base, ref), *_hosts(base, out, world, extra)])
    assert _records(out) == _records(ref)
    assert len([ln for ln in _records(out) if not ln.startswith("@")]) == 48
    for r in range(world):
        assert not (d / f"{out.name}.shard{r}").exists()
        assert not (d / f"{out.name}.shard{r}.done").exists()


@pytest.mark.parametrize("world,chips", [(2, 1), (4, 1), (2, 2)])
def test_multihost_pe_parity_fixed_insert(fixture_dir, world, chips):
    d = fixture_dir
    base = [str(d / "idx"), str(d / "r1.fq"), str(d / "r2.fq"),
            "-I", "300,30"]
    out = d / f"mh_pe_{world}_{chips}.sam"
    ref = d / f"ref_pe_{world}_{chips}.sam"
    chip_args = ["--n-chips", str(chips)] if chips > 1 else []
    _wait([_align(base, ref), *_hosts(base, out, world, chip_args)])
    assert _records(out) == _records(ref)


@pytest.fixture(scope="module")
def repeat_dir(tmp_path_factory):
    """A 60 kb repeat-rich genome indexed by the port's CLI and 96 SE
    reads of 150 bp (1% substitutions, 0.2% indels)."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads,
                                                  write_fasta, write_fastq)

    d = tmp_path_factory.mktemp("tmh_rep")
    rng = np.random.default_rng(41)
    contigs, _ = make_repeat_genome(rng, 60_000, n_contigs=1)
    write_fasta(str(d / "ref.fa"), contigs)
    write_fastq(str(d / "r.fq"), simulate_reads(
        rng, contigs, 96, read_len=150, sub=0.01, ins=0.002, dele=0.002))
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


def test_multihost_repeats_match_jax_cli(repeat_dir):
    """Two hosts on a repeat-rich genome: the port's merged SAM equals the
    JAX CLI's merged SAM (each host restarts its read counter at 0 in
    both packages, so both break score ties the same way)."""
    d = repeat_dir
    base = [str(d / "idx"), str(d / "r.fq")]
    port, jax_out = d / "port2.sam", d / "jax2.sam"
    _wait([*_hosts(base, port, 2,
                   ["--coordinator", f"127.0.0.1:{_free_port()}"]),
           *_hosts(base, jax_out, 2, tool="bwamem_tpu")], timeout=900)
    got = _records(port)
    assert len([ln for ln in got if not ln.startswith("@")]) >= 96
    assert got == _records(jax_out)


def test_failed_join_exits_nonzero(fixture_dir):
    """Host 0 cannot bind a coordinator port that is taken: the join
    fails and the process exits nonzero without a shard."""
    d = fixture_dir
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        sk.listen(1)
        port = sk.getsockname()[1]
        p = _align([str(d / "idx"), str(d / "se.fq"), "--n-hosts", "2",
                    "--host-id", "0", "--coordinator", f"127.0.0.1:{port}"],
                   d / "join.sam")
        err = p.communicate(timeout=300)[1]
    assert p.returncode != 0
    assert "joining the hosts" in err, err[-1500:]
    assert not (d / "join.sam.shard0").exists()
