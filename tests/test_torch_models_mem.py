"""The fused device step (bwamem_tpu_torch/models/mem.py) against the JAX
package's device_align_step: every per-read output (score, qb, qe, rb,
re, has_seed) and the batch's seed count equal, exactly.

  * the JAX fixture of tests/test_multichip.py (16 exact 80 bp reads of
    an 8 kb random genome): full-length hits at the true positions;
  * a 60 kb repeat-rich genome, SMEMs with and without the re-seed
    rounds: 1% substitutions, N bases, reverse-strand reads, reads with
    no seed (random sequence, all N, length 0) and reads at both ends of
    the genome, whose windows start below 0 or run past 2 * l_pac;
  * a long-read batch (1 kb reads in 1024 columns), where the band
    window (640 lanes at w = 300) is narrower than the row: on a card
    the step launches K3 there; here both packages run their dense
    plain versions.
The JAX side seeds on pools large enough that it never overflows (its
step has no retry), which is checked; the port compacts exactly. And
the best-seed rule on ties against the JAX key slen * P + (P - 1 - slot).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
from bwamem_tpu.models import mem as jmem
from bwamem_tpu.ops import extend as jext
from bwamem_tpu.ops import seeding as jseed
from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
from bwamem_tpu_torch.models import mem as tmem
from bwamem_tpu_torch.ops import extend as text
from bwamem_tpu_torch.ops import seeding as tseed
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import jax_fm_arrays, repeat_index

pytestmark = pytest.mark.usefixtures("native_lib")
KEYS = ("score", "qb", "qe", "rb", "re", "has_seed")
# pools past every batch's need: the JAX step then truncates nothing
BIG_POOLS = dict(cand_pool=512, seed_pool=512, r2_pool=64, r2_cand=512,
                 r3_pool=256, merge_pool=512)


def _configs(reseed=False, **ext):
    j = jmem.AlignStepConfig(
        seed=jseed.SeedConfig(reseed=reseed, **BIG_POOLS),
        ext=jext.ExtendParams(**ext))
    t = tmem.AlignStepConfig(seed=tseed.SeedConfig(reseed=reseed),
                             ext=text.ExtendParams(**ext))
    return j, t


def _compare(idx, reads, lens, reseed=False, **ext):
    jfm = JaxFM.from_host(idx)
    tfm = TorchFM.from_numpy(jax_fm_arrays(jfm), "cpu")
    jcfg, tcfg = _configs(reseed, **ext)
    seeds = jseed.smem_seed_batch(jfm, jnp.asarray(reads), jnp.asarray(lens),
                                  jcfg.seed)
    assert not bool(seeds["overflow"])
    want = jmem.device_align_step(jfm, jnp.asarray(reads), jnp.asarray(lens),
                                  jcfg)
    got = tmem.device_align_step(tfm, torch.from_numpy(reads),
                                 torch.from_numpy(lens), tcfg)
    for k in KEYS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert int(got["n_seeds"]) == int(want["n_seeds"])
    return got


@pytest.fixture(scope="module")
def multichip():
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation

    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 8000, dtype=np.uint8)
    idx = build_index_from_codes(
        g, Annotation(names=["c"], lengths=[8000], offsets=[0]), sa_intv=8)
    B, L = 16, 80
    reads = np.full((B, L), 4, np.int32)
    lens = np.full(B, L, np.int32)
    truth = []
    for i in range(B):
        pos = int(rng.integers(0, 8000 - L))
        reads[i] = g[pos:pos + L]
        truth.append(pos)
    return idx, reads, lens, truth


def test_multichip_fixture_matches_jax(multichip):
    idx, reads, lens, truth = multichip
    got = _compare(idx, reads, lens)
    assert (got["score"].numpy() == 80).all()
    np.testing.assert_array_equal(got["rb"].numpy(), truth)
    np.testing.assert_array_equal(got["qe"].numpy(), 80)


def _repeat_reads(g, B, L, seed):
    """Reads of a repeat-rich genome: 1% substitutions, N bases, reverse
    strands, no-seed reads and reads at both genome ends."""
    rng = np.random.default_rng(seed)
    reads = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        p = int(rng.integers(0, len(g) - n))
        if b % 12 == 3:
            p = 0
        elif b % 12 == 7:
            p = len(g) - n
        r = g[p:p + n].copy()
        e = rng.random(n) < 0.01
        r[e] = (r[e] + 1) % 4
        if b % 12 == 5:
            r = rng.integers(0, 4, n).astype(np.uint8)  # likely no seed
        if b % 12 == 9:
            r[:] = 4  # all N
        if b % 3 == 1:
            r[int(rng.integers(0, n))] = 4
        if b % 2:
            r = np.where(r < 4, 3 - r, 4)[::-1].copy()
        reads[b, :n] = r
        lens[b] = n
    lens[-1] = 0
    reads[-1] = 4
    return reads, lens


@pytest.fixture(scope="module")
def repeats():
    return repeat_index(size=60_000, seed=21)


@pytest.mark.parametrize("reseed", [False, True])
def test_repeat_world_matches_jax(repeats, reseed):
    g, idx = repeats
    reads, lens = _repeat_reads(g, 48, 160, 3)
    got = _compare(idx, reads, lens, reseed)
    has = got["has_seed"].numpy()
    assert 30 <= has.sum() < len(has)
    assert not has[-1] and not has[9]
    assert (got["score"].numpy()[~has] == -1).all()


def test_long_reads_band_narrower_than_row(repeats):
    """1 kb reads in a 1024-column batch: round128(1025) = 1152 dense
    lanes against a 640-lane band window at w = 300, the shape a card
    sends to K3."""
    from bwamem_tpu_torch.ops.kernels import extend_banded

    g, idx = repeats
    reads, lens = _repeat_reads(g, 6, 1024, 9)
    lens[:] = np.minimum(lens, 1000)
    reads[:, 1000:] = 4
    assert extend_banded.window_lanes(300) < -(-1025 // 128) * 128
    assert 1024 <= extend_banded.qmax_limit(300)
    got = _compare(idx, reads, lens)
    assert got["has_seed"].numpy().sum() >= 3


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_best_seed_rule_matches_jax_key(seed):
    """Longest first, then the first in seed order, as the JAX key
    slen * P + (P - 1 - slot) picks by a segment max."""
    rng = np.random.default_rng(seed)
    n, B = 300, 40
    rid = np.sort(rng.integers(0, B - 5, n)).astype(np.int32)
    slen = rng.integers(19, 24, n).astype(np.int32)  # many ties
    P = n
    key = slen.astype(np.int64) * P + (P - 1 - np.arange(n))
    best_key = np.full(B, -1, np.int64)
    np.maximum.at(best_key, rid, key)
    has, best = tmem.best_seed(torch.from_numpy(rid), torch.from_numpy(slen),
                               B)
    np.testing.assert_array_equal(has.numpy(), best_key > 0)
    want = (P - 1) - best_key[best_key > 0] % P
    np.testing.assert_array_equal(best.numpy()[has.numpy()], want)
