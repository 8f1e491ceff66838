"""Paired-end alignment through the port on the CPU, against the JAX
package: the batched mate rescue mutates the regions exactly as the JAX
rescue does; the golden PE SAM is byte-identical; the port's CLI gives
the JAX aligner's SAM (apart from @PG) for two files, -p interleaved,
-I, -P, -S and -t 2 on a fixture with victim pairs (read 2
unseedable, placed only by rescue); bad PE input exits 1 with one line."""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tests.test_golden import DATA, _pe_reads, _world
from tests.test_torch_index import SUBPROCESS_ENV  # noqa: E402
from tests.test_torch_index import native_lib  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("native_lib")

N_PAIRS = 64
VICTIM_EVERY = 8


def test_rescue_batch_matches_jax(tiny_index):
    """mem_pe_rescue_batch of the port (descriptor arm, plain SW on the
    CPU) == the JAX package's (host-window lax arm) on the same regions,
    with rescues applied."""
    from bwamem_tpu.pipeline import pairing as jpair
    from bwamem_tpu.pipeline.aligner import MemAligner as JaxAligner
    from bwamem_tpu_torch.pipeline import pairing as tpair
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions

    genome, idx = tiny_index
    rng = np.random.default_rng(77)
    seqs = []
    for i in range(24):
        isize = 300 + int(rng.integers(0, 60))
        p = int(rng.integers(0, 2000 - isize - 1))
        frag = genome[p: p + isize]
        a = frag[:80].astype(np.uint8).copy()
        b = (3 - frag[-80:])[::-1].astype(np.uint8).copy()
        if i % 4 == 0:  # unseedable mate -> rescue target
            b[::12] = (b[::12] + 1) % 4
        elif i % 4 == 1:  # random mate: rescue probes that miss
            b = rng.integers(0, 4, 80, dtype=np.uint8)
        seqs += [a, b]
    pair_seqs = [(seqs[2 * i], seqs[2 * i + 1]) for i in range(24)]
    jal = JaxAligner(MemOptions(), idx)
    tal = MemAligner(MemOptions(), idx, device="cpu")
    jregs = jal.collect_regs_batch(seqs)
    # the JAX aligner returns region arrays from its native path and plain
    # lists from its object path (taken when its native core is not
    # loaded)
    jregs = jregs.to_lists() if hasattr(jregs, "to_lists") else jregs
    tregs = tal.collect_regs_batch(seqs).to_lists()
    pes = tpair.mem_pestat(tal.opt, idx.l_pac, tregs)
    assert [dataclasses.astuple(p) for p in pes] == [
        dataclasses.astuple(p)
        for p in jpair.mem_pestat(jal.opt, idx.l_pac, jregs)]

    def pairs(regs):
        return [[copy.deepcopy(regs[2 * i]), copy.deepcopy(regs[2 * i + 1])]
                for i in range(24)]

    jp, tp = pairs(jregs), pairs(tregs)
    n_jax = jpair.mem_pe_rescue_batch(jal.opt, idx, pes, pair_seqs, jp,
                                      dev=jal.fm)
    stats = {}
    n_port = tpair.mem_pe_rescue_batch(tal.opt, idx, pes, pair_seqs, tp,
                                       dev=tal.fm, stats=stats)
    assert n_port == n_jax > 0 and stats["rescue_applied"] == n_port
    key = ("rb", "re", "qb", "qe", "score", "csub", "truesc", "seedcov",
           "rid")
    n_added = 0
    for pi in range(24):
        for e in (0, 1):
            assert len(tp[pi][e]) == len(jp[pi][e])
            n_added += len(tp[pi][e]) - len(tregs[2 * pi + e])
            for x, y in zip(tp[pi][e], jp[pi][e]):
                assert [getattr(x, k) for k in key] == \
                    [getattr(y, k) for k in key]
    assert n_added > 0  # some rescues produced new hits


def test_golden_pe_byte_identical():
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MEM_F_PE, MemOptions

    g, idx = _world()
    opt = MemOptions()
    opt.flag |= MEM_F_PE
    pe = MemAligner(opt, idx, device="cpu").align_pairs_batch(*_pe_reads(g))
    with open(os.path.join(DATA, "golden_pe.sam")) as f:
        assert f.read().splitlines() == pe


@pytest.fixture(scope="module")
def pe_world(tmp_path_factory):
    """A 60 kb random genome and 64 FR pairs of 150 bp, every 8th with an
    unseedable read 2; as two files and one interleaved file."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.utils.simgenome import write_fasta

    d = tmp_path_factory.mktemp("pe")
    g = np.random.default_rng(41).integers(0, 4, 60_000).astype(np.uint8)
    write_fasta(str(d / "ref.fa"), [("chr1", "".join("ACGT"[c] for c in g))])
    chip_smoke.make_pairs(str(d), g, N_PAIRS, 42, victim_every=VICTIM_EVERY)
    r1 = (d / "r1.fq").read_text().splitlines(keepends=True)
    r2 = (d / "r2.fq").read_text().splitlines(keepends=True)
    with open(d / "inter.fq", "w") as f:
        for i in range(0, len(r1), 4):
            f.writelines(r1[i:i + 4] + r2[i:i + 4])
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


def _jax_sam(d, flag=0, insert=None):
    """The JAX aligner's SAM of the fixture (one chunk, like the CLI's
    default -K), with its @SQ header; and its run counters."""
    from bwamem_tpu.index.format import FMIndex
    from bwamem_tpu.io.fastx import read_fastx
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MEM_F_PE, MemOptions
    from bwamem_tpu.pipeline.pairing import pestat_from_spec

    idx = FMIndex.load(str(d / "idx.bmt"))
    recs = list(read_fastx(str(d / "inter.fq")))
    opt = MemOptions()
    opt.flag |= MEM_F_PE | flag
    al = MemAligner(opt, idx)
    if insert:
        al.pes_fixed = pestat_from_spec(insert)
    sam = al.align_pairs_batch([r.name for r in recs], [r.seq for r in recs],
                               [r.qual for r in recs])
    sq = [f"@SQ\tSN:{n}\tLN:{l}"
          for n, l in zip(idx.ann.names, idx.ann.lengths)]
    return sq + sam, al.stats


@pytest.fixture(scope="module")
def jax_base(pe_world):
    return _jax_sam(pe_world)


def _records(lines):
    return [ln for ln in lines if not ln.startswith("@PG")]


def _port_cli(d, flags, inputs, monkeypatch, threads=1):
    """The port's CLI on the fixture, in this process at -t 1 and in a
    subprocess at -t > 1 (its host pool forks)."""
    out = d / f"out_{'_'.join(flags + inputs)}_{threads}.sam"
    argv = ["align", "--device", "cpu", "-t", str(threads), *flags,
            str(d / "idx"), *(str(d / a) for a in inputs), "-o", str(out)]
    if threads == 1:
        from bwamem_tpu_torch.cli import main

        monkeypatch.chdir(d)  # the CLI appends to ./time.log
        assert main(argv) == 0
    else:
        res = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch",
                              *argv], env=SUBPROCESS_ENV, cwd=str(d),
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
    return out.read_text().splitlines()


def test_cli_two_files_and_interleaved(pe_world, jax_base, monkeypatch):
    want, stats = jax_base
    assert stats["rescue_applied"] > 0
    two = _port_cli(pe_world, [], ["r1.fq", "r2.fq"], monkeypatch)
    assert any(ln.startswith("@PG\tID:bwamem-tpu-torch") for ln in two)
    assert _records(two) == want
    inter = _port_cli(pe_world, ["-p"], ["inter.fq"], monkeypatch)
    assert _records(inter) == want
    # every victim's read 2 (no seed of its own) is mapped by rescue, in a
    # proper pair
    body = [ln.split("\t") for ln in want if not ln.startswith("@")]
    victims = [f for f in body if int(f[1]) & 0x80 and not int(f[1]) & 0x900
               and f[0].endswith("_1")]
    assert len(victims) == N_PAIRS // VICTIM_EVERY
    for f in victims:
        assert int(f[1]) & 2 and not int(f[1]) & 4, f[:6]


@pytest.mark.parametrize("flags,jax_flag,insert", [
    (["-I", "350,50"], 0, "350,50"),
    (["-P"], 0x4, None),   # MEM_F_NOPAIRING
    (["-S"], 0x20, None),  # MEM_F_NO_RESCUE
])
def test_cli_pe_flags_match_jax(pe_world, monkeypatch, flags, jax_flag,
                                insert):
    want, _ = _jax_sam(pe_world, jax_flag, insert)
    got = _port_cli(pe_world, flags, ["r1.fq", "r2.fq"], monkeypatch)
    assert _records(got) == want


def test_cli_two_threads(pe_world, jax_base, monkeypatch):
    got = _port_cli(pe_world, [], ["r1.fq", "r2.fq"], monkeypatch,
                    threads=2)
    assert _records(got) == jax_base[0]


@pytest.mark.parametrize("case", ["odd_interleaved", "unequal_files"])
def test_bad_pe_input_exits_with_one_line(pe_world, tmp_path, case):
    r1 = (pe_world / "r1.fq").read_text().splitlines(keepends=True)
    (tmp_path / "a.fq").write_text("".join(r1[:12]))  # 3 records
    if case == "odd_interleaved":
        args = ["-p", str(pe_world / "idx"), str(tmp_path / "a.fq")]
    else:
        (tmp_path / "b.fq").write_text("".join(r1[:16]))  # 4 records
        args = [str(pe_world / "idx"), str(tmp_path / "a.fq"),
                str(tmp_path / "b.fq")]
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "align", "--device",
         "cpu", *args, "-o", str(tmp_path / "o.sam")],
        env=SUBPROCESS_ENV, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 1
    lines = res.stderr.strip().splitlines()
    assert len(lines) == 1 and "error" in lines[0], res.stderr
