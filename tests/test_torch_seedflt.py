"""The port's per-seed filters (pipeline/seedflt.py) against the JAX
package's, on the same chains: filter_seed_arrays (the native path's
flat-array filter) leaves the same seed and chain arrays and seed scores,
and SeedFilterBatch (the per-seed-object path) leaves the same seeds with
the same scores, for the SW filter (1 kb reads, windows run through the
local-SW kernel's plain version) and for -F (the SHD filter). Exact."""
import copy

import numpy as np
import pytest

from bwamem_tpu.pipeline import seedflt as jflt
from bwamem_tpu_torch.pipeline import seedflt as tflt
from bwamem_tpu_torch.pipeline.chain import chain_batch, chain_batch_raw
from bwamem_tpu_torch.pipeline.options import MemOptions
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import repeat_index

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def world():
    """A 40 kb repeat-rich genome and its seeds for 1 kb and 150 bp reads
    (1% substitutions, some indels, half reverse-complemented)."""
    from bwamem_tpu_torch.pipeline.aligner import MemAligner

    g, idx = repeat_index(40_000, seed=8)
    rng = np.random.default_rng(19)
    reads = {}
    for name, n, ln in (("long", 8, 1000), ("short", 24, 150)):
        seqs = []
        for i in range(n):
            p = int(rng.integers(0, len(g) - ln - 10))
            r = g[p:p + ln + 10].astype(np.uint8).copy()
            sub = rng.random(len(r)) < 0.01
            r[sub] = (r[sub] + 1) % 4
            keep = rng.random(len(r)) > 0.003
            r = r[keep][:ln]
            if i % 2:
                r = (3 - r)[::-1].copy()
            seqs.append(r)
        al = MemAligner(MemOptions(), idx, device="cpu")
        seeds = al.seed_batch_arrays(seqs)
        seeds.pop("reads_dev")
        reads[name] = (seqs, seeds)
    return idx, reads


def _opt(shd):
    opt = MemOptions()
    opt.shd_filter = shd
    return opt


@pytest.mark.parametrize("name,shd", [("long", False), ("short", True),
                                      ("long", True)])
def test_filter_seed_arrays_matches_jax(world, name, shd):
    idx, reads = world
    seqs, seeds = reads[name]
    opt = _opt(shd)
    raw = chain_batch_raw(opt, idx, [len(s) for s in seqs], None,
                          seed_arrays=seeds)
    want, got = copy.deepcopy(raw), copy.deepcopy(raw)
    jflt.filter_seed_arrays(opt, idx, want, seqs)
    tflt.filter_seed_arrays(opt, idx, got, seqs, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    # the filter did work here: seeds dropped or rescored
    assert (got["n_seeds"] < raw["n_seeds"]
            or not np.array_equal(got["s_score"], got["s_len"]))


def _seed_table(chains):
    return [[(s.qbeg, s.rbeg, s.len, s.score, s.sw_scored) for s in c.seeds]
            for per_read in chains for c in per_read]


@pytest.mark.parametrize("name,shd", [("long", False), ("short", True)])
def test_seed_filter_batch_matches_jax(world, name, shd):
    idx, reads = world
    seqs, seeds = reads[name]
    opt = _opt(shd)
    b = seeds["bounds"]
    cols = np.stack([seeds["qbeg"], seeds["qend"], seeds["rbeg"],
                     seeds["n_occ"]], axis=1)
    tuples = [[tuple(int(x) for x in row) for row in cols[b[i]:b[i + 1]]]
              for i in range(len(seqs))]
    chains = chain_batch(opt, idx, [len(s) for s in seqs], tuples)
    results = []
    for mod, kw in ((jflt, {}), (tflt, {"device": "cpu"})):
        mine = copy.deepcopy(chains)
        flt = mod.SeedFilterBatch(opt, idx, **kw)
        for r, seq in enumerate(seqs):
            flt.add_read(len(seq), seq, mine[r])
        flt.run()
        results.append(_seed_table(mine))
    assert results[1] == results[0]
    assert results[1] != _seed_table(chains)  # the filter changed seeds
