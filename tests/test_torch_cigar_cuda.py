"""K5 (the finalize's CIGAR solve, ops/kernels/cigar_kernel.py) on the card:
row for row equal to its plain version on jobs at the cells' shapes (150
and 250 bp on both strands, bands up to the retry loop's, N bases) and at 1
kb (tracebacks in global scratch, also beside 150 bp jobs in one launch and
over several launches), and single-call jobs equal to
bm_ksw_global; `align` on the card equal to `--device cpu` for SE and PE
at 150 and 250 bp, with every CIGAR solved by K5 (`cigar_host_jobs` 0).
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.

This file imports neither jax nor the JAX package:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cigar_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bwamem_tpu_torch.ops.kernels import cigar_kernel  # noqa: E402

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]
GAPS = (6, 1, 6, 1)


def _mat():
    m = np.full((5, 5), -4, np.int32)
    np.fill_diagonal(m, 1)
    m[4, :] = -1
    m[:, 4] = -1
    return m


def _pack(g):
    """The packed genome's words (16 bases a word, the first in the top
    bits), as int32."""
    w = np.zeros((len(g) + 15) // 16 * 16, np.uint64)
    w[:len(g)] = g
    w = w.reshape(-1, 16)
    sh = (30 - 2 * np.arange(16)).astype(np.uint64)
    return (w << sh).sum(1).astype(np.uint32).view(np.int32)


def make_jobs(rng, g, n, lens, max_band=64):
    """n jobs over genome codes g: a window on either strand, the query a
    mutated copy of the window as gen_cigar orients it (1-3% substitutions,
    indels, N bases, clipped ends), up to three bands in the retry loop's
    order. Returns (qstream, qoff, rb, desc) as numpy arrays."""
    lp = len(g)
    qs, qoff, rbs, desc = [], [], [], []
    off = 0
    for k in range(n):
        L = int(rng.choice(lens))
        rlen = max(1, L + int(rng.integers(-6, 7)))
        p = int(rng.integers(0, lp - rlen))
        rev = bool(rng.integers(0, 2))
        fw = g[p:p + rlen]
        # as gen_cigar orients it: the reverse strand's window, reversed,
        # is the forward run complemented
        t = 3 - fw if rev else fw
        q = list(t)
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, len(q) + 1))
            if rng.integers(0, 2):
                q.insert(i, int(rng.integers(0, 4)))
            elif i < len(q) and len(q) > 1:
                del q[i]
        q = np.array(q, np.uint8)
        sub = rng.random(len(q)) < rng.uniform(0.0, 0.03)
        q[sub] = (q[sub] + 1) % 4
        q[rng.random(len(q)) < 0.003] = 4
        if k % 9 == 0:                        # a clipped end
            q = q[int(rng.integers(1, 12)):]
        stored = q[::-1] if rev else q
        dl = abs(len(q) - rlen)
        b0 = int(rng.integers(0, max_band // 4 + 1)) + dl + 3
        bands = [b0, min(2 * b0, max_band), min(4 * b0, max_band)]
        nb = int(rng.integers(1, 4))
        bands = [b if c < nb else -1 for c, b in enumerate(bands)]
        if k % 13 == 0 and len(q) == rlen:   # gen_cigar's ungapped call
            bands[0] = -1
            bands[1:nb] = [-1] * (nb - 1)
        thr = len(q) - int(rng.integers(0, 12))
        qs.append(stored)
        qoff.append(off)
        off += len(stored)
        rbs.append(2 * lp - (p + rlen) if rev else p)
        desc.append([len(q), rlen, thr, nb, *bands, max(bands)])
    return (np.concatenate(qs).astype(np.uint8), np.array(qoff, np.int64),
            np.array(rbs, np.int64), np.array(desc, np.int32))


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(3).integers(0, 4, 300_000).astype(np.uint8)


def _solve(args, device, lp):
    qs, qoff, rb, desc = (torch.from_numpy(a).to(device) for a in args[:4])
    return cigar_kernel.solve(qs, qoff, rb, desc,
                              torch.from_numpy(args[4]).to(device), lp,
                              torch.from_numpy(_mat().reshape(25)).to(device),
                              *GAPS, cigar_kernel.launch_plan(args[3])).cpu()


@pytest.mark.parametrize("lens,max_band,n,tile", [
    ((150,), 40, 1000, None), ((250,), 64, 1000, None),
    ((1, 2, 31, 33, 97, 300), 300, 600, None), ((1000,), 400, 40, None),
    ((150, 1000), 400, 120, None), ((1000,), 400, 40, 1 << 20)])
def test_k5_matches_plain(genome, monkeypatch, lens, max_band, n, tile):
    """Rows equal the plain version's, one launch a tile of the launch
    plan; at 1 kb and a band of up to 400 the tracebacks pass the shared
    memory and go to global scratch (beside 150 bp jobs kept in shared
    memory, in one launch; over several launches where `tile` bounds a
    launch's scratch)."""
    if tile:
        monkeypatch.setattr(cigar_kernel, "TILE_BYTES", tile)
    rng = np.random.default_rng(len(lens) * 100 + max_band)
    args = (*make_jobs(rng, genome, n, lens, max_band), _pack(genome))
    plan = cigar_kernel.launch_plan(args[3])
    # tracebacks leave shared memory past 48 KB a job: 300 bp at a band
    # of 300, 1 kb
    assert (plan.tboff is not None) == (max(lens) >= 300)
    assert (len(plan.tiles) > 1) == bool(tile)
    n0 = cigar_kernel.LAUNCHES
    got = _solve(args, "cuda", len(genome))
    torch.cuda.synchronize()
    assert cigar_kernel.LAUNCHES == n0 + len(plan.tiles)
    want = _solve(args, "cpu", len(genome))
    bad = (got != want).any(1).nonzero()[:, 0].tolist()
    assert not bad, [(args[3][k].tolist(), got[k, :6].tolist(),
                      want[k, :6].tolist()) for k in bad[:4]]
    assert (got[:, 1] >= 0).float().mean() > 0.95


def test_k5_single_calls_match_bm_ksw_global(genome):
    """Jobs of one gen_cigar call: score and CIGAR are bm_ksw_global's on
    the oriented query and window."""
    from bwamem_tpu_torch.native import loader

    lib = loader.try_load()
    rng = np.random.default_rng(11)
    qs, qoff, rb, desc = make_jobs(rng, genome, 400, (150, 250), 64)
    desc[:, 3] = 1
    desc[:, 5:7] = -1
    desc[:, 7] = desc[:, 4]
    rows = _solve((qs, qoff, rb, desc, _pack(genome)), "cuda", len(genome))
    lp = len(genome)
    mat = _mat().astype(np.int8)
    for k in range(len(desc)):
        lq, rlen, band = int(desc[k, 0]), int(desc[k, 1]), int(desc[k, 4])
        q = qs[qoff[k]:qoff[k] + lq]
        if rb[k] >= lp:
            f0 = 2 * lp - (rb[k] + rlen)
            t, q = 3 - genome[f0:f0 + rlen], q[::-1]
        else:
            t = genome[rb[k]:rb[k] + rlen]
        if band < 0:
            continue
        sc, cig = loader.ksw_global_native(lib, q, t, mat, *GAPS, band)
        row = rows[k].tolist()
        if row[1] < 0:   # more runs than the row holds
            assert len(cig) > cigar_kernel.OPS_CAP
            continue
        assert row[0] == sc
        assert [(c & 15, c >> 4) for c in row[2:2 + row[1]]] == cig


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """A 300 kb repeat genome's index; SE 150 bp, FR pairs of 150 and
    250 bp at 1% substitutions."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.utils import simgenome as sg

    d = tmp_path_factory.mktemp("k5cli")
    rng = np.random.default_rng(17)
    contigs, _ = sg.make_repeat_genome(rng, 300_000, n_contigs=2)
    sg.write_fasta(str(d / "ref.fa"), contigs)
    sg.write_fastq(str(d / "se150.fq"),
                   sg.simulate_reads(rng, contigs, 400, sub=0.01))
    for L in (150, 250):
        with open(d / f"pe{L}.fq", "w") as f:
            for a, b in sg.simulate_pairs(rng, contigs, 200, read_len=L,
                                          isize_mean=2 * L + 100, sub=0.01):
                for r in (a, b):
                    f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


@pytest.mark.parametrize("reads", [["se150.fq"], ["pe150.fq", "-p"],
                                   ["pe250.fq", "-p"]])
def test_align_on_card_matches_cpu(cli_world, reads):
    """`align` SAM on the card (the finalize's CIGARs on K5) equals
    `--device cpu` (the native finalize), apart from @PG, with no CIGAR
    left to the host: the trace's `cigar_jobs` and `cigar_host_jobs`."""
    import json

    from bwamem_tpu_torch.cli import main

    d = cli_world
    inp = [str(d / reads[0]), *reads[1:]]
    out = {}
    for dev in ("cuda", "cpu"):
        n0 = cigar_kernel.LAUNCHES
        assert main(["align", "--device", dev, "-t", "1", "--trace-out",
                     str(d / f"{dev}.json"), str(d / "idx"), *inp, "-o",
                     str(d / f"{dev}.sam")]) == 0
        out[dev] = [ln for ln in open(d / f"{dev}.sam")
                    if not ln.startswith("@PG")]
        n = {"cigar_jobs": 0, "cigar_host_jobs": 0}
        for e in json.load(open(d / f"{dev}.json"))["traceEvents"]:
            if e.get("ph") == "C" and e["name"] in n:
                n[e["name"]] += e["args"]["n"]
        if dev == "cuda":
            assert n["cigar_jobs"] >= len(out[dev]) // 2
            assert n["cigar_host_jobs"] == 0
            assert cigar_kernel.LAUNCHES > n0
        else:
            assert n == {"cigar_jobs": 0, "cigar_host_jobs": 0}
            assert cigar_kernel.LAUNCHES == n0
    assert out["cuda"] == out["cpu"]
