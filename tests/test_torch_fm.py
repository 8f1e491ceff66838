"""The port's FM primitives and window gathers against the JAX package's,
on random intervals, rows and windows of a repeat-rich index."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
from bwamem_tpu.ops import fm as jfm_ops
from bwamem_tpu.ops import refgather as jrg
from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
from bwamem_tpu_torch.ops import fm as tfm_ops
from bwamem_tpu_torch.ops import refgather as trg
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import jax_fm_arrays, repeat_index

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def fms():
    g, idx = repeat_index(size=30_000, seed=11)
    jfm = JaxFM.from_host(idx)
    return g, idx, jfm, TorchFM.from_numpy(jax_fm_arrays(jfm), "cpu")


def _intervals(rng, n, seq_len):
    """Random bi-intervals (k, l, s) with rows inside [0, seq_len]."""
    k = rng.integers(0, seq_len + 1, n)
    l = rng.integers(0, seq_len + 1, n)
    s = rng.integers(0, seq_len + 1 - np.maximum(k, l), n)
    s[: n // 4] = rng.integers(0, 3, n // 4)  # many tiny intervals
    return [a.astype(np.int32) for a in (k, l, s)]


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def test_backward_ext_ks(fms):
    _, idx, jfm, tfm = fms
    rng = np.random.default_rng(1)
    k, _, s = _intervals(rng, 4000, idx.seq_len)
    c = rng.integers(0, 4, 4000).astype(np.int32)
    jk, js = jfm_ops.backward_ext_ks_batch(jfm, jnp.asarray(k),
                                           jnp.asarray(s), jnp.asarray(c))
    tk, ts = tfm_ops.backward_ext_ks_batch(
        tfm, torch.from_numpy(k), torch.from_numpy(s), torch.from_numpy(c))
    _eq(tk, jk, "k")
    _eq(ts, js, "s")


def test_forward_ext4(fms):
    _, idx, jfm, tfm = fms
    rng = np.random.default_rng(2)
    k, l, s = _intervals(rng, 4000, idx.seq_len)
    j = jfm_ops.forward_ext4_batch(jfm, *map(jnp.asarray, (k, l, s)))
    t = tfm_ops.forward_ext4_batch(tfm, *map(torch.from_numpy, (k, l, s)))
    for a, b, name in zip(t, j, "kls"):
        _eq(a, b, name)


def test_forward_ext2(fms):
    _, idx, jfm, tfm = fms
    rng = np.random.default_rng(3)
    k, l, s = _intervals(rng, 4000, idx.seq_len)
    b1 = rng.integers(0, 5, 4000).astype(np.int32)
    b2 = rng.integers(0, 5, 4000).astype(np.int32)
    j = jfm_ops.forward_ext2_batch(jfm, *map(jnp.asarray, (k, l, s, b1, b2)))
    t = tfm_ops.forward_ext2_batch(
        tfm, *map(torch.from_numpy, (k, l, s, b1, b2)))
    for step in range(2):
        for a, b, name in zip(t[step], j[step], "kls"):
            _eq(a, b, f"step {step + 1} {name}")


def test_forward_ext2_is_two_ext4_steps(fms):
    """Both steps of the pair walk equal two single-base steps."""
    _, idx, _, tfm = fms
    rng = np.random.default_rng(4)
    k, l, s = map(torch.from_numpy, _intervals(rng, 2000, idx.seq_len))
    b1 = torch.from_numpy(rng.integers(0, 4, 2000).astype(np.int32))
    b2 = torch.from_numpy(rng.integers(0, 4, 2000).astype(np.int32))
    (k1, l1, s1), (k2, l2, s2) = tfm_ops.forward_ext2_batch(
        tfm, k, l, s, b1, b2)
    k4, l4, s4 = tfm_ops.forward_ext4_batch(tfm, k, l, s)
    pick = tfm_ops._sel
    assert torch.equal(s1, pick(s4, b1)) and torch.equal(k1, pick(k4, b1))
    live = s1 > 0
    k4b, l4b, s4b = tfm_ops.forward_ext4_batch(tfm, k1, l1, s1)
    assert torch.equal(s2[live], pick(s4b, b2)[live])
    assert torch.equal(k2[live], pick(k4b, b2)[live])


def test_sa_lookup(fms):
    _, idx, jfm, tfm = fms
    rng = np.random.default_rng(5)
    rows = rng.integers(0, idx.seq_len + 1, 3000).astype(np.int32)
    rows[:3] = [0, idx.primary, idx.seq_len]
    j = jfm_ops.sa_lookup_batch(jfm, jnp.asarray(rows))
    t = tfm_ops.sa_lookup_batch(tfm, torch.from_numpy(rows))
    _eq(t, j)


def test_popcount32():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    want = np.array([bin(int(v)).count("1") for v in x])
    got = tfm_ops.popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_gathers(fms):
    g, idx, jfm, tfm = fms
    rng = np.random.default_rng(7)
    lp = idx.l_pac
    start = rng.integers(-40, 2 * lp + 40, 500).astype(np.int32)
    start[:4] = [0, lp - 10, 2 * lp - 50, lp]
    j = jrg.gather_window_fast(jfm, jnp.asarray(start), 77)
    t = trg.gather_window_fast(tfm, torch.from_numpy(start), 77)
    _eq(t, j)
    codes = rng.integers(0, 5, (9, 70)).astype(np.int8)
    jw, jn = jrg.pack_codes_2bit(jnp.asarray(codes))
    tw, tn = trg.pack_codes_2bit(torch.from_numpy(codes))
    _eq(tw, np.asarray(jw).astype(np.int64))
    _eq(tn, np.asarray(jn).astype(np.int64))
    f0 = rng.integers(0, 9 * 80 - 40, 300).astype(np.int32)
    _eq(trg._extract_words_ascending(tw.reshape(-1), torch.from_numpy(f0), 40),
        jrg._extract_words_ascending(jw.reshape(-1), jnp.asarray(f0), 40))
