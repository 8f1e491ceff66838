"""The port's SHD seed pre-filter (ops/shd.py) against the JAX package's
(bwamem_tpu/ops/shd.py): the same pass flags on the four cases of
tests/test_seedflt.py (identical windows and a few substitutions, unrelated
windows, a small indel, many scattered substitutions) and on a random
batch with shared lengths below the window width. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.ops.shd import shd_filter_batch as jax_shd
from bwamem_tpu_torch.ops.shd import shd_filter_batch as port_shd


def _both(R, F, lens, max_error=7):
    want = np.asarray(jax_shd(jnp.asarray(R), jnp.asarray(F),
                              jnp.asarray(lens), max_error))
    got = port_shd(torch.from_numpy(R), torch.from_numpy(F),
                   torch.from_numpy(lens), max_error).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def _pair(read, ref):
    n = min(len(read), len(ref))
    R = np.zeros((1, 128), np.int32)
    F = np.zeros((1, 128), np.int32)
    R[0, :n] = read[:n]
    F[0, :n] = ref[:n]
    return R, F, np.array([n], np.int32)


def _cases():
    """The windows of tests/test_seedflt.py:28-60, with their verdicts."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, 128).astype(np.int32)
    t = s.copy()
    for j in (10, 50, 90):
        t[j] = (t[j] + 1) % 4
    yield "identical", s, s, True
    yield "three_subs", s, t, True
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 128).astype(np.int32)
    b = rng.integers(0, 4, 128).astype(np.int32)
    yield "garbage", a, b, False
    rng = np.random.default_rng(2)
    s = rng.integers(0, 4, 128).astype(np.int32)
    t = np.concatenate([s[:40], s[43:], rng.integers(0, 4, 3)]).astype(
        np.int32)
    yield "indel", s, t, True
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, 128).astype(np.int32)
    t = s.copy()
    for j in range(0, 128, 6):
        t[j] = (t[j] + 1) % 4
    yield "scattered", s, t, False


@pytest.mark.parametrize("name,read,ref,verdict",
                         list(_cases()), ids=[c[0] for c in _cases()])
def test_seedflt_cases(name, read, ref, verdict):
    assert bool(_both(*_pair(read, ref))[0]) == verdict


def test_random_batch_short_lengths():
    """Windows cut short at read or contig ends (lens < 128), N bases,
    and near-miss mutation counts around max_error, at two thresholds."""
    rng = np.random.default_rng(9)
    n = 256
    R = rng.integers(0, 4, (n, 128)).astype(np.int32)
    F = R.copy()
    k = rng.integers(0, 16, n)
    for i in range(n):
        j = rng.choice(128, int(k[i]), replace=False)
        F[i, j] = (F[i, j] + rng.integers(1, 4, len(j))) % 4
        if i % 5 == 0:  # a shift: indel-like
            F[i] = np.roll(F[i], int(rng.integers(-3, 4)))
    R[rng.random((n, 128)) < 0.01] = 4
    lens = rng.integers(1, 128, n).astype(np.int32)
    lens[:4] = (0, 1, 2, 127)
    for max_error in (7, 3):
        ok = _both(R, F, lens, max_error)
        assert 0 < ok.sum() < n
