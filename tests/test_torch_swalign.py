"""The port's local SW (ops/swalign.py + the K2 kernel's plain version)
against the JAX package's: the lax path and the Pallas kernel in
interpret mode, with both gap settings, both score2 (minsc) regimes and
rev_skip; the degenerate lanes; the port's scalar ksw oracle; and the
descriptor-fed rescue launch on the tiny index. Every comparison is exact.
The CUDA kernel itself is held against the plain version on the card in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.ops.extend import make_score_matrix
from bwamem_tpu.ops.pallas.swalign_kernel import \
    sw_align_batch_pallas_stacked
from bwamem_tpu.ops.swalign import SW_KEYS as JAX_KEYS
from bwamem_tpu.ops.swalign import sw_align_batch as jax_sw
from bwamem_tpu_torch.ops import swalign
from bwamem_tpu_torch.ops.kernels import swalign_kernel
from tests.test_swalign_pallas import _random_sw_cases
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")

GAPS = [(0, 6, 1, 6, 1), (1, 5, 2, 7, 1)]  # bwa defaults; asymmetric


def _tiles(cases):
    N = len(cases)
    QMAX = max(len(q) for q, _ in cases)
    TMAX = max(len(t) for _, t in cases)
    Q = np.full((N, QMAX), 4, np.int8)
    T = np.full((N, TMAX), 4, np.int8)
    ql = np.zeros(N, np.int32)
    tl = np.zeros(N, np.int32)
    for i, (q, t) in enumerate(cases):
        Q[i, : len(q)] = q
        T[i, : len(t)] = t
        ql[i], tl[i] = len(q), len(t)
    return Q, T, ql, tl


def _port(Q, T, ql, tl, minsc, mat, gaps, a, rev_skip=0):
    out = swalign_kernel.sw_align_batch(
        *(torch.from_numpy(x) for x in (Q, T, ql, tl, minsc, mat)),
        *gaps, a, rev_skip)
    assert out.dtype == torch.int32 and out.shape == (6, len(ql))
    return out.numpy()


def _pallas(Q, T, ql, tl, minsc, a, b, gaps, rev_skip=0):
    return np.asarray(sw_align_batch_pallas_stacked(
        *(jnp.asarray(x.astype(np.int32)) for x in (Q, T, ql, tl, minsc)),
        a, b, *gaps, rev_skip=rev_skip, tile=8, interpret=True))


@pytest.mark.parametrize("seed,odel,edel,oins,eins", GAPS)
def test_plain_matches_lax_and_pallas(seed, odel, edel, oins, eins):
    rng = np.random.default_rng(2000 + seed)
    a, b = 1, 4
    mat = make_score_matrix(a, b)
    Q, T, ql, tl = _tiles(_random_sw_cases(rng, 37))
    minsc = np.full(len(ql), 19 * a, np.int32)
    minsc[::4] = 0  # both XSUBO eligibility regimes
    gaps = (odel, edel, oins, eins)
    got = _port(Q, T, ql, tl, minsc, mat, gaps, a)
    lax = jax_sw(*(jnp.asarray(x) for x in (Q.astype(np.int32),
                                            T.astype(np.int32), ql, tl,
                                            mat, minsc)), *gaps, a)
    assert swalign.SW_KEYS == JAX_KEYS
    for ki, k in enumerate(swalign.SW_KEYS):
        np.testing.assert_array_equal(got[ki], np.asarray(lax[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got, _pallas(Q, T, ql, tl, minsc, a, b,
                                               gaps))
    assert (got[0] > 0).sum() > 10 and (got[5] > 0).sum() > 0


def test_rev_skip_matches_pallas():
    """Jobs under rev_skip report qb = tb = -1, the rest are unchanged."""
    rng = np.random.default_rng(2002)
    a, b = 1, 4
    mat = make_score_matrix(a, b)
    Q, T, ql, tl = _tiles(_random_sw_cases(rng, 30))
    minsc = np.full(len(ql), 19, np.int32)
    gaps = (6, 1, 6, 1)
    got = _port(Q, T, ql, tl, minsc, mat, gaps, a, rev_skip=19)
    np.testing.assert_array_equal(
        got, _pallas(Q, T, ql, tl, minsc, a, b, gaps, rev_skip=19))
    low = got[0] < 19
    assert low.any() and (~low).any()
    assert (got[1][low] == -1).all() and (got[3][low] == -1).all()
    full = _port(Q, T, ql, tl, minsc, mat, gaps, a)
    np.testing.assert_array_equal(got[:, ~low], full[:, ~low])


def test_other_scores_match_lax():
    """-A 2 -B 3: a non-default matrix; score2's window uses a = 2."""
    rng = np.random.default_rng(2003)
    a, b = 2, 3
    mat = make_score_matrix(a, b)
    Q, T, ql, tl = _tiles(_random_sw_cases(rng, 24, qmax=64, tmax=120))
    minsc = np.full(len(ql), 2 * 19, np.int32)
    minsc[::3] = 0
    gaps = (5, 2, 7, 1)
    got = _port(Q, T, ql, tl, minsc, mat, gaps, a)
    lax = jax_sw(*(jnp.asarray(x) for x in (Q.astype(np.int32),
                                            T.astype(np.int32), ql, tl,
                                            mat, minsc)), *gaps, a)
    for ki, k in enumerate(swalign.SW_KEYS):
        np.testing.assert_array_equal(got[ki], np.asarray(lax[k]),
                                      err_msg=k)


@pytest.mark.parametrize("rev_skip", [0, 19])
def test_degenerate_lanes(rev_skip):
    """qlen 0, tlen 0, qlen 1, all-N and full-width lanes, as the Pallas
    kernel's own degenerate-lane test builds them."""
    a, b = 1, 4
    mat = make_score_matrix(a, b)
    Q = np.full((6, 16), 4, np.int8)
    T = np.full((6, 24), 4, np.int8)
    ql = np.array([0, 4, 16, 1, 8, 16], np.int32)
    tl = np.array([8, 0, 24, 1, 8, 24], np.int32)
    Q[1, :4] = [0, 1, 2, 3]
    Q[2, :16] = np.arange(16) % 4
    T[2, 4:20] = np.arange(16) % 4
    Q[3, 0] = T[3, 0] = 2
    Q[4, :8] = 2
    T[4, :8] = 2
    minsc = np.zeros(6, np.int32)
    got = _port(Q, T, ql, tl, minsc, mat, (6, 1, 6, 1), a, rev_skip)
    np.testing.assert_array_equal(
        got, _pallas(Q, T, ql, tl, minsc, a, b, (6, 1, 6, 1), rev_skip))
    zero = [0, 1, 5]  # qlen 0, tlen 0, all N: nothing scores
    assert (got[0][zero] == 0).all() and (got[5][zero] == 0).all()
    assert (got[2][zero] == -1).all() and (got[4][zero] == -1).all()
    assert got[0][2] == 16 and got[0][3] == 1 and got[0][4] == 8


def test_plain_matches_oracle():
    """The port's scalar ksw oracle (oracle/ksw.ksw_local), as the JAX
    package's lax path is held to it."""
    from bwamem_tpu_torch.oracle.ksw import ksw_local

    rng = np.random.default_rng(5)
    mat = make_score_matrix(1, 4)
    N, QMAX, TMAX = 24, 48, 96
    cases = []
    for i in range(N):
        qlen = int(rng.integers(8, QMAX + 1))
        tlen = int(rng.integers(16, TMAX + 1))
        t = rng.integers(0, 4, tlen).astype(np.int8)
        q = rng.integers(0, 4, qlen).astype(np.int8)
        if i % 3 != 0:  # plant the query (with noise) inside the target
            pos = int(rng.integers(0, tlen - min(qlen, tlen) + 1))
            m = min(qlen, tlen - pos)
            t[pos: pos + m] = q[:m]
            for _ in range(int(rng.integers(0, 3))):
                j = int(rng.integers(0, m))
                t[pos + j] = (t[pos + j] + 1) % 4
        cases.append((q, t))
    Q, T, ql, tl = _tiles(cases)
    minsc = np.full(N, 19, np.int32)
    out = swalign.sw_align_batch(
        *(torch.from_numpy(x) for x in (Q, T, ql, tl, mat, minsc)),
        6, 1, 6, 1, 1)
    for i, (q, t) in enumerate(cases):
        o = ksw_local(q, t, mat, 6, 1, 6, 1, minsc=19)
        assert int(out["score"][i]) == o.score, i
        if o.score > 0:
            assert (int(out["qe"][i]), int(out["te"][i])) == (o.qe, o.te), i
            assert (int(out["qb"][i]), int(out["tb"][i])) == (o.qb, o.tb), i
        assert int(out["score2"][i]) == o.score2, i


def test_rescue_descriptor_path_matches_jax(tiny_index):
    """sw_rescue_desc_stacked (window gather on the port's device index +
    local SW) == the JAX package's (gather + Pallas kernel in interpret
    mode), on windows of both strands like _matesw_build produces."""
    from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
    from bwamem_tpu.ops.swalign import sw_rescue_desc_stacked as jax_desc
    from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
    from bwamem_tpu_torch.pipeline.options import MemOptions

    _, idx = tiny_index
    opt = MemOptions()
    rng = np.random.default_rng(31)
    lp = idx.l_pac
    QMAX, TMAX, N = 96, 256, 24
    Q = np.full((N, QMAX), 4, np.int8)
    ql = np.zeros(N, np.int32)
    tl = np.zeros(N, np.int32)
    rb = np.zeros(N, np.int64)
    for i in range(N):
        l_ms = int(rng.integers(40, QMAX + 1))
        span = int(rng.integers(l_ms, TMAX + 1))
        lo, hi = (lp, 2 * lp) if i % 2 else (0, lp)
        b = int(rng.integers(lo, hi - span + 1))
        b2, e2, ref, rid = idx.fetch_seq_rid(b, b + span, mid=b + span // 2)
        assert rid == 0 and e2 > b2
        off = int(rng.integers(0, max(e2 - b2 - l_ms, 0) + 1))
        q = np.asarray(ref[off: off + l_ms], np.int8).copy()
        q = np.pad(q, (0, l_ms - len(q)), constant_values=4)
        for _ in range(int(rng.integers(0, 6))):
            q[int(rng.integers(0, l_ms))] = int(rng.integers(0, 4))
        Q[i, :l_ms] = q
        ql[i], tl[i], rb[i] = l_ms, e2 - b2, b2
    minsc = np.full(N, opt.min_seed_len * opt.a, np.int32)
    gaps = (opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, TMAX)
    for rev_skip in (0, opt.min_seed_len):
        want = np.asarray(jax_desc(
            JaxFM.from_host(idx), *(jnp.asarray(x) for x in (Q, ql, rb, tl,
                                                             minsc)),
            *gaps, rev_skip=rev_skip, interpret=True))
        got = swalign.sw_rescue_desc_stacked(
            TorchFM.from_host(idx, "cpu"),
            *(torch.from_numpy(x) for x in (Q, ql, rb, tl, minsc)),
            *gaps, rev_skip=rev_skip)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] >= opt.min_seed_len).sum() > N // 2


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(9)
    Q, T, ql, tl = _tiles(_random_sw_cases(rng, 6, qmax=20, tmax=40))
    args = [torch.from_numpy(x) for x in (Q, T, ql, tl, np.zeros(6, np.int32),
                                          make_score_matrix(1, 4))]
    before = swalign_kernel.LAUNCHES
    out = swalign_kernel.sw_align_batch(*args, 6, 1, 6, 1, 1)
    assert swalign_kernel.LAUNCHES == before and out.shape == (6, 6)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        swalign_kernel.sw_align_batch(*(x.to("meta") for x in args),
                                      6, 1, 6, 1, 1)
