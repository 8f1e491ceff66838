"""The port's SMEM seeding against the JAX package's smem_seed_batch: the
same valid seeds (read, qbeg, qend, rbeg, n_occ) in the same order, with
the re-seed rounds on and off, on reads with N bases and indels from a
repeat-rich genome. The JAX side runs with pools large enough that it
never overflows (its retry loop converges to that untruncated result)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
from bwamem_tpu.ops import seeding as jseed
from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
from bwamem_tpu_torch.ops import seeding as tseed
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import jax_fm_arrays, repeat_index

pytestmark = pytest.mark.usefixtures("native_lib")

FIELDS = ("read_id", "qbeg", "qend", "rbeg", "n_occ")


@pytest.fixture(scope="module")
def world():
    g, idx = repeat_index(size=60_000, seed=21)
    rng = np.random.default_rng(22)
    B, L = 48, 160
    reads = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(90, 151))
        p = int(rng.integers(0, len(g) - n - 4))
        r = g[p:p + n + 4].copy()
        if b % 5 == 2:  # a 2-base deletion
            c = int(rng.integers(20, n - 20))
            r = np.delete(r, [c, c + 1])
        r = r[:n]
        e = rng.random(n) < 0.015
        r[e] = (r[e] + 1) % 4
        if b % 2:
            r = (3 - r)[::-1].copy()
        if b % 4 == 1:
            r[int(rng.integers(0, n))] = 4  # an N
        reads[b, :n] = r
        lens[b] = n
    return idx, reads, lens


def _jax_seeds(jfm, reads, lens, reseed):
    cfg = jseed.SeedConfig(reseed=reseed, cand_pool=512, seed_pool=512,
                           r2_pool=64, r2_cand=512, r3_pool=256,
                           merge_pool=512)
    out = jseed.smem_seed_batch(jfm, jnp.asarray(reads), jnp.asarray(lens),
                                cfg)
    assert not bool(out["overflow"])
    v = np.asarray(out["valid"])
    return {k: np.asarray(out[k])[v] for k in FIELDS}


@pytest.mark.parametrize("reseed", [False, True])
def test_seeds_match_jax(world, reseed):
    idx, reads, lens = world
    jfm = JaxFM.from_host(idx)
    tfm = TorchFM.from_numpy(jax_fm_arrays(jfm), "cpu")
    want = _jax_seeds(jfm, reads, lens, reseed)
    got = tseed.smem_seed_batch(tfm, torch.from_numpy(reads),
                                torch.from_numpy(lens),
                                tseed.SeedConfig(reseed=reseed))
    assert len(got["rbeg"]) == len(want["rbeg"]) > 0
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)


def test_seeds_without_occ2_match_occ2(world):
    """The single-base walks (indexes without the pair table) give the
    same seeds as the pair walks."""
    idx, reads, lens = world
    rt, lt = torch.from_numpy(reads), torch.from_numpy(lens)
    cfg = tseed.SeedConfig(reseed=True)
    a = tseed.smem_seed_batch(TorchFM.from_host(idx, "cpu", occ2=True),
                              rt, lt, cfg)
    b = tseed.smem_seed_batch(TorchFM.from_host(idx, "cpu", occ2=False),
                              rt, lt, cfg)
    for k in FIELDS:
        assert torch.equal(a[k].to(torch.int64), b[k].to(torch.int64)), k


def test_containment_filter_segments():
    qbeg = torch.tensor([5, 3, 4, 0, 9, 2, 2], dtype=torch.int32)
    qend = torch.tensor([30, 40, 50, 30, 40, 50, 60], dtype=torch.int32)
    grp = torch.tensor([0, 0, 0, 1, 2, 2, 2], dtype=torch.int32)
    keep = tseed._containment_filter(qbeg, qend, grp, 19)
    # strictly below every later qbeg of its own group
    assert keep.tolist() == [False, True, True, True, False, False, True]
