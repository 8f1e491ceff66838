"""The seeding variants through the port against the JAX package: -u 2
(fixed-length exact seeds), -u 3 (forward-only MEMs), -u 4 (fixed-length
seeds with at most one mismatch), -g (all MEMs) and the default SMEMs.

  * the aligners' seed_batch on the world of tests/test_seed_variants.py
    (a 20 kb random genome, sa_intv 8): the same seeds in the same order,
    at the default seed interval and at -J 7; and for -g on 400 bp reads
    of a repeat-rich genome (the JAX package's text walk) and on 256
    reads, enough candidates for the JAX walk's lane compaction, which
    is turned off there (the port never compacts);
  * the k-mer table equals the JAX table, and the jump-start through it
    gives the same seeds as the walk step by step;
  * the CLI: SAM identical to the JAX CLI's apart from @PG for SE -u 2,
    -u 3, -u 4, -g and PE -u 3 on a repeat-rich genome."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tests.test_torch_index import native_lib  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def env():
    """The genome of tests/test_seed_variants.py indexed by both packages,
    and reads on it: both strands, one substitution each, some with an N
    or a 2-base deletion, lengths 60-150."""
    from bwamem_tpu.index.build import build_index_from_codes as jbuild
    from bwamem_tpu.index.format import Annotation as JAnn
    from bwamem_tpu_torch.index.build import build_index_from_codes as tbuild
    from bwamem_tpu_torch.index.format import Annotation as TAnn

    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 20000, dtype=np.uint8)
    jidx = jbuild(g, JAnn(names=["c"], lengths=[20000], offsets=[0]),
                  sa_intv=8)
    tidx = tbuild(g, TAnn(names=["c"], lengths=[20000], offsets=[0]),
                  sa_intv=8)
    rng = np.random.default_rng(4)
    seqs = []
    for i in range(24):
        n = int(rng.integers(60, 151))
        p = int(rng.integers(0, len(g) - n - 2))
        r = g[p:p + n + 2].copy()
        if i % 6 == 5:
            c = int(rng.integers(20, n - 20))
            r = np.delete(r, [c, c + 1])
        r = r[:n]
        j = int(rng.integers(0, n))
        r[j] = (r[j] + 1) % 4
        if i % 2:
            r = (3 - r)[::-1].copy()
        if i % 4 == 3:
            r[int(rng.integers(0, n))] = 4
        seqs.append(r)
    return g, jidx, tidx, seqs


def _aligners(jidx, tidx, **opts):
    from bwamem_tpu.pipeline.aligner import MemAligner as JAl
    from bwamem_tpu.pipeline.options import MemOptions as JOpt
    from bwamem_tpu_torch.pipeline.aligner import MemAligner as TAl
    from bwamem_tpu_torch.pipeline.options import MemOptions as TOpt

    return (JAl(JOpt(**opts), jidx),
            TAl(TOpt(**opts), tidx, device="cpu"))


@pytest.mark.parametrize("opts", [
    dict(seed_type=1), dict(seed_type=2), dict(seed_type=3),
    dict(seed_type=4), dict(re_seed=True), dict(seed_type=2, seed_intv=7),
    dict(seed_type=4, seed_intv=7), dict(seed_type=3, full_reseed=False),
    dict(re_seed=True, full_reseed=False)],
    ids=["u1", "u2", "u3", "u4", "g", "u2_J7", "u4_J7", "u3_noreseed",
         "g_noreseed"])
def test_seeds_match_jax(env, opts):
    _, jidx, tidx, seqs = env
    jal, tal = _aligners(jidx, tidx, **opts)
    want = jal.seed_batch(seqs)
    got = tal.seed_batch(seqs)
    assert sum(map(len, got)) > len(seqs)
    assert got == want


@pytest.fixture(scope="module")
def repeats():
    """A 60 kb repeat-rich genome indexed by both packages."""
    from bwamem_tpu.index.build import build_index_from_codes as jbuild
    from bwamem_tpu.index.format import Annotation as JAnn
    from tests.test_torch_index import repeat_index

    g, tidx = repeat_index(size=60_000, seed=21)
    jidx = jbuild(g, JAnn(names=tidx.ann.names, lengths=tidx.ann.lengths,
                          offsets=tidx.ann.offsets), sa_intv=4)
    return g, jidx, tidx


def _sample(g, n, length, err, seed):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        p = int(rng.integers(0, len(g) - length))
        r = g[p:p + length].copy()
        e = rng.random(length) < err
        r[e] = (r[e] + 1) % 4
        seqs.append(r)
    return seqs


def test_mem_mode_long_reads_match_jax(repeats):
    """-g on 400 bp reads from a repeat-rich genome: the JAX package
    finishes unique lanes by text comparison (read buckets of 384 bp or
    more), the port walks them on; the seeds are the same."""
    g, jidx, tidx = repeats
    seqs = _sample(g, 4, 400, 0.02, 8)
    jal, tal = _aligners(jidx, tidx, re_seed=True)
    want = jal.seed_batch(seqs)
    assert tal.seed_batch(seqs) == want


def test_mem_mode_big_batch_matches_uncompacted_jax(repeats):
    """-g on a batch of more than 4096 candidates, where the JAX package's
    backward walk would compact its live lanes (and so compare a lane
    with another neighbour in the early kill, which decides the qbeg of a
    nested MEM that -g keeps): the port equals the JAX walk without
    compaction, every lane against its neighbour in (read, end) order."""
    from dataclasses import replace

    g, jidx, tidx = repeats
    seqs = _sample(g, 256, 150, 0.01, 3)
    jal, tal = _aligners(jidx, tidx, re_seed=True)
    jal.seed_cfg = replace(jal.seed_cfg, r1_schedule=())
    got = tal.seed_batch(seqs)
    assert sum(map(len, got)) > 4096
    assert got == jal.seed_batch(seqs)


def test_kmer_table_matches_jax(env):
    from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
    from bwamem_tpu.ops import fm as jfm_ops
    from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
    from bwamem_tpu_torch.ops import fm as tfm_ops

    _, jidx, tidx, _ = env
    for K in (4, 8):
        want = np.asarray(jfm_ops.kmer_intv_table(JaxFM.from_host(jidx), K))
        tfm = TorchFM.from_host(tidx, "cpu")
        got = tfm_ops.get_kmer_table(tfm, K)
        assert got.dtype == tfm_ops.idx_dt(tfm)
        np.testing.assert_array_equal(got.numpy(), want)
        assert tfm_ops.get_kmer_table(tfm, K) is got  # cached


@pytest.mark.parametrize("inexact", [False, True])
def test_kmer_jump_start_identical(env, inexact):
    """The 8-mer table jump-start equals stepping the walk base by base,
    mismatch branches inside the table's prefix included (as
    tests/test_seed_variants.py holds the JAX package)."""
    from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
    from bwamem_tpu_torch.ops import fm as tfm_ops
    from bwamem_tpu_torch.ops.seeding import bowtie_seed_batch

    g, _, tidx, _ = env
    fm = TorchFM.from_host(tidx, "cpu")
    rng = np.random.default_rng(17)
    B, L = 12, 60
    reads = np.full((B, L), 4, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(g) - L))
        r = g[p:p + L].copy()
        r[int(rng.integers(0, 20))] ^= 1  # a mismatch inside the prefix
        reads[i] = r
    rt = torch.from_numpy(reads)
    lt = torch.full((B,), L, dtype=torch.int32)
    a = bowtie_seed_batch(fm, rt, lt, seed_len=22, stride=11,
                          inexact=inexact)
    b = bowtie_seed_batch(fm, rt, lt, seed_len=22, stride=11,
                          inexact=inexact, ktab=tfm_ops.get_kmer_table(fm, 8),
                          ktab_k=8)
    assert len(a["rbeg"]) > B
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 100 kb repeat-rich genome indexed by the port's CLI, 40 SE reads
    of 150 bp (1% substitutions, 0.2% indels) and 16 FR pairs."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads,
                                                  write_fasta, write_fastq)

    d = tmp_path_factory.mktemp("variants")
    rng = np.random.default_rng(71)
    contigs, _ = make_repeat_genome(rng, 100_000, n_contigs=1)
    write_fasta(str(d / "ref.fa"), contigs)
    write_fastq(str(d / "r150.fq"), simulate_reads(
        rng, contigs, 40, read_len=150, sub=0.01, ins=0.002, dele=0.002,
        prefix="r150"))
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    chip_smoke.make_pairs(str(d), g, 16, 72, victim_every=4)
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


CASES = {
    "u2": (["r150.fq"], ["-u", "2"]),
    "u3": (["r150.fq"], ["-u", "3"]),
    "u4": (["r150.fq"], ["-u", "4"]),
    "g": (["r150.fq"], ["-g"]),
    "u3_pe": (["r1.fq", "r2.fq"], ["-u", "3"]),
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
    assert len(body) >= 32
    assert sum(not int(f[1]) & 4 for f in body) >= 0.8 * len(body)
    assert outs["port"] == outs["jax"]
