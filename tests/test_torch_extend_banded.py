"""The port's banded extension (ops/kernels/extend_banded.py) against the
JAX package's: the plain version equals the lax row scan
(bwamem_tpu.ops.extend.extend_batch with opt_ext) on the six cases of
tests/test_extend_banded.py, with the same generator and seeds; it equals
the Pallas banded kernel in interpret mode on one small case; and it
equals the port's dense plain version, which applies the band as a mask.
Every comparison is exact. The CUDA kernel itself is held against the
plain version on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.ops import extend as jext
from bwamem_tpu.ops.pallas.extend_banded import extend_batch_banded
from bwamem_tpu_torch.ops import extend as text
from bwamem_tpu_torch.ops.kernels import extend_banded, extend_kernel
from tests.test_extend_banded import _mk

OUT = ("score", "qle", "tle", "gscore", "gtle", "max_off")

# (seed, jobs, QMAX, TMAX, similarity, ExtendParams fields) of the six
# cases of tests/test_extend_banded.py
CASES = {
    "narrow_band": (11, 48, 400, 420, 0.85, dict(w=50, zdrop=0)),
    "default_band_long": (12, 32, 900, 950, 0.85, dict(w=100, zdrop=0)),
    "zdrop_large_h0": (13, 32, 500, 520, 0.7, dict(w=64, zdrop=100)),
    "window_covers_all": (14, 32, 80, 90, 0.85, dict(w=100, zdrop=0)),
    "pacbio_scoring": (15, 24, 1200, 1250, 0.8, dict(
        o_del=1, e_del=1, o_ins=1, e_ins=1, w=100, zdrop=100, max_mat=1,
        mismatch=1)),
    "degenerate_lanes": (16, 16, 300, 300, 0.85, dict(w=64, zdrop=0)),
}


def _case(name):
    seed, n, qmax, tmax, sim, kw = CASES[name]
    rng = np.random.default_rng(seed)
    Q, T, ql, tl, h0 = _mk(rng, n, qmax, tmax, sim)
    if name == "zdrop_large_h0":
        h0 = rng.integers(150, 400, len(ql)).astype(np.int32)
    if name == "degenerate_lanes":
        tl[3] = 0
        ql[5] = 1
        Q[7, 10:30] = 4
        T[9, 5:25] = 4
    jp = jext.ExtendParams(**kw)
    tp = text.ExtendParams(**{k: v for k, v in kw.items()
                              if k != "mismatch"})
    mat = jext.make_score_matrix(jp.max_mat, jp.mismatch)
    return (Q, T, ql, tl, h0), mat, jp, tp


def _torch_args(arrays, mat):
    Q, T, ql, tl, h0 = arrays
    return [torch.from_numpy(a) for a in (Q.astype(np.int8),
                                          T.astype(np.int8), ql, tl, h0,
                                          mat)]


def _assert_equal(got, want, what):
    for k in OUT:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_lax(name):
    arrays, mat, jp, tp = _case(name)
    want = jext.extend_batch(*(jnp.asarray(a) for a in arrays),
                             jnp.asarray(mat), jp)
    got = extend_banded.extend_batch_banded_plain(*_torch_args(arrays, mat),
                                                  tp)
    _assert_equal({k: v.numpy() for k, v in got.items()}, want, "lax")


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(21)
    arrays = _mk(rng, 12, 300, 320, 0.8)
    kw = dict(w=40, zdrop=30)
    mat = jext.make_score_matrix(1, 4)
    want = extend_batch_banded(*(jnp.asarray(a) for a in arrays),
                               jext.ExtendParams(**kw), interpret=True)
    got = extend_banded.extend_batch_banded(*_torch_args(arrays, mat),
                                            text.ExtendParams(**kw))
    _assert_equal({k: v.numpy() for k, v in got.items()}, want, "pallas")


@pytest.mark.parametrize("name", ["narrow_band", "zdrop_large_h0",
                                  "degenerate_lanes"])
def test_plain_matches_dense_plain(name):
    arrays, mat, _, tp = _case(name)
    args = _torch_args(arrays, mat)
    want = extend_kernel.extend_batch_plain(*args, tp)
    got = extend_banded.extend_batch_banded_plain(*args, tp)
    _assert_equal(got, want, "dense")


def test_cpu_routing_keeps_the_dense_plain_version():
    """On the CPU, extend_batch_auto runs the dense plain version whatever
    the band, as the JAX package's CPU path runs its lax twin."""
    arrays, mat, _, tp = _case("narrow_band")
    before = (extend_kernel.LAUNCHES, extend_banded.LAUNCHES)
    out = text.extend_batch_auto(*_torch_args(arrays, mat), tp)
    assert (extend_kernel.LAUNCHES, extend_banded.LAUNCHES) == before
    assert out["score"].shape == (len(arrays[2]),)


# K3's 16-bit route: the plain version with int16 cells against int64 on
# the alignments fits_i16 admits
I16_SCORINGS = {"default": (4, {}),
                "pacbio": (1, dict(o_del=1, e_del=1, o_ins=1, e_ins=1,
                                   end_bonus=0))}


def _k3_top(h0, tlen, TMAX, p, amax=1):
    """extend_banded.fits_i16's sum, as its docstring states it."""
    return (h0 + amax * min(tlen, TMAX)
            + p.e_ins * (extend_banded.window_lanes(p.w) + 1)
            + max(p.o_del + p.e_del, p.o_ins + p.e_ins) + p.end_bonus)


@pytest.mark.parametrize("zdrop", [0, 100])
@pytest.mark.parametrize("w", [100, 300])
@pytest.mark.parametrize("scoring", list(I16_SCORINGS))
def test_plain_in_int16_matches_int64(scoring, w, zdrop):
    """The window's cells in int16 (what the kernel's two 16-bit
    alignments a warp compute) equal its int64 cells, at the default and
    -x pacbio scoring, w 100 and 300, zdrop 0 and 100, on jobs shaped as
    the main path's with h0 up to fits_i16's edge."""
    import chip_smoke

    b, gaps = I16_SCORINGS[scoring]
    QMAX, TMAX = (256, 384) if w == 100 else (400, 560)
    rng = np.random.default_rng(w + zdrop)
    q, t, ql, tl, h0 = chip_smoke.make_jobs(rng, 40, QMAX, TMAX)
    p = text.ExtendParams(w=w, zdrop=zdrop, opt_ext=True, **gaps)
    h0[2] = 50  # make_jobs' h0 = 100000 lane is outside the predicate
    h0[5:10] = [extend_banded.I16_LIMIT - 1 - _k3_top(0, int(x), TMAX, p)
                for x in tl[5:10]]
    args = [torch.from_numpy(x) for x in (q, t, ql, tl, h0,
                                          jext.make_score_matrix(1, b))]
    fits = extend_banded.fits_i16(args[3], args[4], args[5], p, QMAX, TMAX)
    assert bool(fits.all())
    want = extend_banded.extend_batch_banded_plain(*args, p)
    got = extend_banded.extend_batch_banded_plain(*args, p, torch.int16)
    # the edge jobs' cells climb to within the window's margin of 2^14
    assert int(want["score"].max()) > 15_000
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_fits_i16_boundary():
    """extend_banded.fits_i16 at its edge: the largest h0 a full-length
    target admits, and one more; a negative h0, a match score of 2 or an
    entry outside a signed byte refuses the job."""
    TMAX = 384
    for w in (100, 300):
        p = text.ExtendParams(w=w, opt_ext=True)
        mat = torch.from_numpy(jext.make_score_matrix(1, 4))
        edge = extend_banded.I16_LIMIT - 1 - _k3_top(0, TMAX, TMAX, p)
        t = torch.tensor([TMAX, TMAX, TMAX + 9, 0], dtype=torch.int32)
        h = torch.tensor([edge, edge + 1, edge, -1], dtype=torch.int32)
        got = extend_banded.fits_i16(t, h, mat, p, 256, TMAX).tolist()
        assert got == [True, False, True, False]
        for a, b in ((2, 4), (1, 200)):
            m2 = torch.from_numpy(jext.make_score_matrix(a, b))
            assert not bool(extend_banded.fits_i16(
                t[:1], h[:1], m2, p, 256, TMAX).any())


def test_qmax_limit_routes_wide_queries_to_k1():
    """The kernel holds two score profiles of a query a warp in shared
    memory: qmax_limit(w) bounds QMAX, and extend_batch_auto sends wider
    rows to the dense kernel (its band as a mask gives the same result)."""
    for w in (0, 100, 300, 509):
        wp = extend_banded.window_lanes(w)
        lim = extend_banded.qmax_limit(w)
        pw = -(-(lim + w + wp // 32 + 8) // 4) * 4
        assert 10 * pw <= 232448 < 10 * (pw + 40)
