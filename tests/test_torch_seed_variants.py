"""The seeding variants through the port against the JAX package: -u 2
(fixed-length exact seeds), -u 3 (forward-only MEMs), -u 4 (fixed-length
seeds with at most one mismatch), -g (all MEMs) and the default SMEMs.

  * the aligners' seed_batch on the world of tests/test_seed_variants.py
    (a 20 kb random genome, sa_intv 8): the same seeds in the same order,
    at the default seed interval and at -J 7; and for -g on 400 bp reads
    of a repeat-rich genome (the JAX package's text walk), and on
    batches past 4096 candidate slots, where the JAX walk compacts its
    lanes (512 reads of a 200 kb and 256 of a 60 kb repeat-rich genome,
    the 256 with the compaction off on both sides, and 64 reads of 250 bp,
    whose pool the JAX aligner scales with the read length);
  * the k-mer table equals the JAX table, and the jump-start through it
    gives the same seeds as the walk step by step;
  * the CLI: SAM identical to the JAX CLI's apart from @PG for SE -u 2,
    -u 3, -u 4, -g (also on a batch past 4096 candidate slots) and PE
    -u 3 on a repeat-rich genome."""
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


@pytest.fixture(scope="module")
def repeats200():
    """A 200 kb repeat-rich genome (sa_intv 4) indexed by both packages."""
    from bwamem_tpu.index.build import build_index_from_codes as jbuild
    from bwamem_tpu.index.format import Annotation as JAnn
    from tests.test_torch_index import repeat_index

    g, tidx = repeat_index(size=200_000)
    jidx = jbuild(g, JAnn(names=tidx.ann.names, lengths=tidx.ann.lengths,
                          offsets=tidx.ann.offsets), sa_intv=4)
    return g, jidx, tidx


@pytest.mark.parametrize("world,n_reads,read_len,schedule", [
    ("repeats200", 512, 150, "default"), ("repeats", 256, 150, "default"),
    ("repeats", 256, 150, ()), ("repeats", 64, 250, "default")],
    ids=["200kb_512", "60kb_256", "60kb_256_off", "60kb_64x250bp"])
def test_mem_mode_big_batch_matches_uncompacted_jax(world, n_reads, read_len,
                                                    schedule, request,
                                                    tmp_path):
    """-g on a batch of at least 4096 candidate slots (the JAX pool is
    bucket_count(reads) x cand_pool), where the JAX package's backward
    walk compacts its live lanes at its r1_schedule points and so compares
    a lane with another neighbour in the early kill, which decides the
    qbeg of a nested MEM that -g keeps: the port, with the JAX run's
    schedule, sizes its pool as the JAX aligner does (cand_pool scaled
    with the read bucket: 64 slots a read at 250 bp, so 64 reads reach
    4096) and gives the same seeds; with the schedule off (()), both walk
    uncompacted. A fresh pool store keeps the JAX aligner's pool sizes
    from other tests' learning."""
    from dataclasses import replace

    from bwamem_tpu.pipeline.poolstore import PoolStore
    from bwamem_tpu_torch.utils.shapes import bucket_count

    g, jidx, tidx = request.getfixturevalue(world)
    seqs = _sample(g, n_reads, read_len, 0.01, 3)
    jal, tal = _aligners(jidx, tidx, re_seed=True)
    jal.pool_store = PoolStore(str(tmp_path / "pools.json"))
    if schedule != "default":
        jal.seed_cfg = replace(jal.seed_cfg, r1_schedule=schedule)
        tal.seed_cfg = replace(tal.seed_cfg, r1_schedule=schedule)
    want = jal.seed_batch(seqs)
    got = tal.seed_batch(seqs)
    assert tal.seed_cfg.cand_pool == jal.seed_cfg.cand_pool
    assert bucket_count(n_reads) * tal.seed_cfg.cand_pool >= 4096
    assert sum(map(len, got)) > 4096
    assert got == want


@pytest.mark.parametrize("n_reads", [16, 64])
def test_mem_mode_pool_overflow_matches_jax(repeats, n_reads, tmp_path):
    """-g on 190 bp reads at 5% substitutions, whose round-1 candidates
    (about 95 a read) overflow the JAX pool of bucket_count(reads) x 32
    slots: the JAX aligner grows cand_pool by its overflow retry's jump
    and seeds again on the wider pool; the port applies the same jump
    from its own candidate count before its walk (one pass) and gives
    the same seeds, and keeps the grown cand_pool for later batches.
    A fresh pool store starts the JAX aligner at the default cand_pool."""
    from bwamem_tpu.pipeline.poolstore import PoolStore

    g, jidx, tidx = repeats
    seqs = _sample(g, n_reads, 190, 0.05, 11)
    jal, tal = _aligners(jidx, tidx, re_seed=True)
    jal.pool_store = PoolStore(str(tmp_path / "pools.json"))
    start = jal.seed_cfg.cand_pool
    assert start == tal.seed_cfg.cand_pool == 32
    want = jal.seed_batch(seqs)
    got = tal.seed_batch(seqs)
    assert jal.seed_cfg.cand_pool > start  # the JAX pool overflowed
    assert tal.seed_cfg.cand_pool == jal.seed_cfg.cand_pool
    assert got == want
    # the port keeps the grown pool for later batches (the JAX aligner
    # would next adopt the size its pool store learned, which the port
    # does not follow)
    grown = tal.seed_cfg.cand_pool
    tal.seed_batch(seqs[:8])
    assert tal.seed_cfg.cand_pool == grown


def test_mem_mode_spill_split_matches_jax(repeats, tmp_path, monkeypatch):
    """-g where the JAX aligner's pools reach their caps and still
    overflow: with both sides' caps lowered to 64 candidate and 256 seed
    slots a read, the round-1 candidates of 64 reads of 190 bp at 5%
    substitutions (about 95 a read) overflow 64 x 64 slots, so the JAX
    aligner halves the batch, and halves again, until each part fits its
    own bucket_count(part) x 64 pool; each part then walks on a pool
    narrower than 4096 lanes, without the staged compaction. The port
    splits where the JAX aligner does and gives the same seeds. Under the
    parent's rule (the whole batch seeded on one pool of 64 x 64 lanes,
    which compacts) 18 of the 64 reads get other seeds. A fresh pool
    store starts the JAX aligner at the default pools."""
    import bwamem_tpu.pipeline.poolstore as jpools
    from bwamem_tpu.pipeline.poolstore import PoolStore
    from bwamem_tpu_torch.ops import seeding as tseeding
    from bwamem_tpu_torch.pipeline import aligner as taligner

    caps = {"cand_pool": 64, "seed_pool": 256}
    for f, v in caps.items():
        monkeypatch.setitem(jpools.POOL_CAPS, f, v)
        monkeypatch.setitem(tseeding.POOL_CAPS, f, v)
    g, jidx, tidx = repeats
    seqs = _sample(g, 64, 190, 0.05, 11)
    jal, tal = _aligners(jidx, tidx, re_seed=True)
    jal.pool_store = PoolStore(str(tmp_path / "pools.json"))
    want = jal.seed_batch(seqs)
    assert jal.seed_cfg.cand_pool == 64
    got = tal.seed_batch(seqs)
    assert tal.seed_cfg.cand_pool == 64
    assert got == want
    # the parent's rule: no split
    monkeypatch.setattr(taligner, "pool_spills", lambda *a: False)
    _, parent = _aligners(jidx, tidx, re_seed=True)
    old = parent.seed_batch(seqs)
    n_diff = sum(a != b for a, b in zip(old, want))
    assert n_diff == 18


def test_cli_start_pools_match_jax_cli(repeats200, tmp_path, monkeypatch):
    """-g through the CLI on 512 reads of 150 bp of a 200 kb repeat-rich
    genome: the JAX CLI starts its aligner at --seed-cands 48 and
    --seed-cap 8 slots a read, and the port's CLI passes both, so its SAM
    equals the JAX CLI's. With the JAX SeedConfig's 32 candidate slots
    (what the port's CLI used before it passed --seed-cands), 2 of the
    512 reads get other seeds than the JAX CLI's pool of 48 gives."""
    from bwamem_tpu.cli import main as jax_main
    from bwamem_tpu.ops.seeding import SeedConfig as JSC
    from bwamem_tpu.pipeline.aligner import MemAligner as JAl
    from bwamem_tpu.pipeline.options import MemOptions as JOpt
    from bwamem_tpu.pipeline.poolstore import PoolStore
    from bwamem_tpu_torch.cli import main as port_main
    from bwamem_tpu_torch.ops.seeding import SeedConfig as TSC
    from bwamem_tpu_torch.pipeline.aligner import MemAligner as TAl
    from bwamem_tpu_torch.pipeline.options import MemOptions as TOpt

    g, jidx, tidx = repeats200
    seqs = _sample(g, 512, 150, 0.01, 3)
    jal = JAl(JOpt(re_seed=True), jidx,
              seed_cfg=JSC(cand_pool=48, seed_pool=8, reseed=True))
    jal.pool_store = PoolStore(str(tmp_path / "pools.json"))
    want = jal.seed_batch(seqs)
    old = TAl(TOpt(re_seed=True), tidx, device="cpu",
              seed_cfg=TSC(cand_pool=32, reseed=True)).seed_batch(seqs)
    assert sum(a != b for a, b in zip(old, want)) == 2

    monkeypatch.chdir(tmp_path)  # both CLIs append to ./time.log
    monkeypatch.setenv("BWAMEM_TPU_POOLS", str(tmp_path / "cli_pools.json"))
    tidx.save(str(tmp_path / "idx.bmt"))
    with open(tmp_path / "r.fq", "w") as f:
        for i, r in enumerate(seqs):
            seq = "".join("ACGTN"[c] for c in r)
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(r)}\n")
    outs = {}
    for tool, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"{tool}.sam"
        dev = ["--device", "cpu"] if tool == "port" else []
        assert main(["align", *dev, "-t", "1", "-g", str(tmp_path / "idx"),
                     str(tmp_path / "r.fq"), "-o", str(out)]) == 0
        outs[tool] = [ln for ln in out.read_text().splitlines()
                      if not ln.startswith("@PG")]
    assert len(outs["port"]) > 512
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("c_need,reads,pool,want", [
    (512, 16, 32, 32), (513, 16, 32, 64), (1024, 16, 32, 64),
    (1025, 16, 32, 128), (1514, 16, 32, 128), (2049, 16, 32, 256),
    (10 ** 6, 16, 32, 4096), (10 ** 6, 16, 4096, 4096), (0, 16, 32, 32),
    (5000, 16, 2048, 2048), (40000, 16, 2048, 4096)])
def test_grown_cand_pool_rule(c_need, reads, pool, want):
    """The JAX overflow retry's jump (bwamem_tpu/pipeline/aligner.py):
    m = ceil(c_need / (reads x pool)); m > 1 grows the pool by
    2^bit_length(max(m - 1, 1)), capped at 4096; the grown pool holds
    every candidate, so a second round would not grow it again."""
    from bwamem_tpu_torch.ops.seeding import grown_cand_pool

    got = grown_cand_pool(c_need, reads, pool)
    assert got == want
    if got < 4096:
        assert reads * got >= c_need
        assert grown_cand_pool(c_need, reads, got) == got


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
    of 150 bp (1% substitutions, 0.2% indels), 16 FR pairs, and 192 SE
    reads of 150 bp: a -g batch of 192 x 32 = 6144 candidate slots, where
    the JAX walk compacts its lanes."""
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
    write_fastq(str(d / "r150_big.fq"), simulate_reads(
        rng, contigs, 192, read_len=150, sub=0.01, prefix="big"))
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)]
    chip_smoke.make_pairs(str(d), g, 16, 72, victim_every=4)
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


CASES = {
    "u2": (["r150.fq"], ["-u", "2"]),
    "u3": (["r150.fq"], ["-u", "3"]),
    "u4": (["r150.fq"], ["-u", "4"]),
    "g": (["r150.fq"], ["-g"]),
    "g_big": (["r150_big.fq"], ["-g"]),
    "u3_pe": (["r1.fq", "r2.fq"], ["-u", "3"]),
}


def _records(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith("@PG")]


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(world, case, monkeypatch, tmp_path):
    from bwamem_tpu.cli import main as jax_main
    from bwamem_tpu_torch.cli import main as port_main

    monkeypatch.chdir(world)  # both CLIs append to ./time.log
    # a fresh pool store: the JAX CLI starts at the default cand_pool,
    # as the port does, whatever other tests taught the shared store
    monkeypatch.setenv("BWAMEM_TPU_POOLS", str(tmp_path / "pools.json"))
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
