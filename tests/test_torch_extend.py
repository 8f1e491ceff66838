"""The port's extension (ops/extend.py + the dense kernel's plain version)
against the JAX package's: the lax row scan and the Pallas kernel in
interpret mode, for all four (opt_ext, zdrop > 0) variants; end_choice;
and the descriptor path (window gathers + extension + choice) against
extend_choose_desc_jit. Every comparison is exact. The CUDA kernel itself
is held against the plain version on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
from bwamem_tpu.ops import extend as jext
from bwamem_tpu.ops.pallas.extend_kernel import extend_batch_pallas
from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
from bwamem_tpu_torch.ops import extend as text
from bwamem_tpu_torch.ops.kernels import extend_kernel
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import jax_fm_arrays

pytestmark = pytest.mark.usefixtures("native_lib")

OUT = ("score", "qle", "tle", "gscore", "gtle", "max_off")
VARIANTS = [(False, 0), (False, 40), (True, 0), (True, 40)]


def make_jobs(rng, N, QMAX, TMAX):
    """Random extension jobs (target = mutated superstring of the query)
    plus edge lanes: tlen 0, qlen 1, large h0, a target past TMAX."""
    q = rng.integers(0, 4, (N, QMAX)).astype(np.int8)
    t = np.concatenate(
        [q, rng.integers(0, 4, (N, TMAX - QMAX)).astype(np.int8)], axis=1)
    mut = rng.random((N, TMAX)) < 0.08
    t[mut] = rng.integers(0, 5, int(mut.sum()))
    qn = rng.random((N, QMAX)) < 0.01
    q[qn] = 4
    ql = rng.integers(1, QMAX + 1, N).astype(np.int32)
    tl = rng.integers(0, TMAX + 1, N).astype(np.int32)
    h0 = rng.integers(1, 60, N).astype(np.int32)
    ql[0], tl[1], h0[2], tl[3], ql[4], h0[4] = 1, 0, 10_000, TMAX, QMAX, 1
    return q, t, ql, tl, h0


def _params(opt_ext, zdrop, mod):
    return mod.ExtendParams(o_del=6, e_del=1, o_ins=6, e_ins=1, w=24,
                            zdrop=zdrop, end_bonus=5, opt_ext=opt_ext,
                            max_mat=1)


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS)
def test_plain_matches_lax_and_pallas(opt_ext, zdrop):
    rng = np.random.default_rng(100 + 2 * zdrop + opt_ext)
    q, t, ql, tl, h0 = make_jobs(rng, 40, 40, 88)
    mat = jext.make_score_matrix(1, 4)
    jp = _params(opt_ext, zdrop, jext)
    J = [jnp.asarray(a) for a in (q, t, ql, tl, h0)]
    lax_out = jext.extend_batch(*J, jnp.asarray(mat), jp)
    pal_out = extend_batch_pallas(*J, jp, tile=8, interpret=True)
    got = extend_kernel.extend_batch(
        *(torch.from_numpy(a) for a in (q, t, ql, tl, h0, mat)),
        _params(opt_ext, zdrop, text))
    for k in OUT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(lax_out[k]),
                                      err_msg=f"lax {k}")
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(pal_out[k]),
                                      err_msg=f"pallas {k}")


def test_plain_matches_lax_other_scores():
    """-A 2 -B 3 -O 5,7 -E 2,1: a non-default matrix and asymmetric gaps."""
    rng = np.random.default_rng(7)
    q, t, ql, tl, h0 = make_jobs(rng, 48, 36, 70)
    mat = jext.make_score_matrix(2, 3)
    kw = dict(o_del=5, e_del=2, o_ins=7, e_ins=1, w=30, zdrop=30,
              end_bonus=5, opt_ext=True, max_mat=2)
    want = jext.extend_batch(*(jnp.asarray(a) for a in (q, t, ql, tl, h0)),
                             jnp.asarray(mat),
                             jext.ExtendParams(mismatch=3, **kw))
    got = extend_kernel.extend_batch(
        *(torch.from_numpy(a) for a in (q, t, ql, tl, h0, mat)),
        text.ExtendParams(**kw))
    for k in OUT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_end_choice():
    args = [torch.tensor(v) for v in ([10, 10, 10], [5, 5, 5], [6, 6, 6],
                                      [-1, 4, 9], [7, 7, 7], [8, 8, 8])]
    s, q, t = text.end_choice(*args, 5)
    js, jq, jt = jext.end_choice(*(jnp.asarray(a.numpy()) for a in args), 5)
    assert s.tolist() == [10, 10, 9] == np.asarray(js).tolist()
    assert q.tolist() == [5, 5, 8] == np.asarray(jq).tolist()
    assert t.tolist() == [6, 6, 7] == np.asarray(jt).tolist()


@pytest.fixture(scope="module")
def desc_world():
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation

    rng = np.random.default_rng(77)
    G, L, B = 30_000, 128, 48
    g = rng.integers(0, 4, G, dtype=np.uint8)
    ann = Annotation(names=["c"], lengths=[G], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    reads = np.stack([g[p:p + L] for p in rng.integers(0, G - L, B)])
    reads = reads.astype(np.int8)
    reads[3, 40:43] = 4  # N run inside a read
    N, QMAX, TMAX = 96, 96, 160
    jr = rng.integers(0, B, N).astype(np.int32)
    jdir = np.where(rng.random(N) < 0.5, 1, -1).astype(np.int8)
    ql = rng.integers(10, 90, N).astype(np.int32)
    jqs = np.where(jdir > 0, rng.integers(0, 30, N),
                   rng.integers(95, L - 1, N)).astype(np.int32)
    tl = (ql + rng.integers(0, 60, N)).astype(np.int32)
    # doubled coords spanning both strands
    jts = rng.integers(TMAX + 2, 2 * G - TMAX - 2, N).astype(np.int64)
    h0 = rng.integers(15, 40, N).astype(np.int32)
    jfm = JaxFM.from_host(idx)
    return (jfm, reads, (jr, jqs, ql, jts, tl, jdir, h0), QMAX, TMAX, g)


def test_desc_windows(desc_world):
    """Windows gathered from descriptors equal the bases they name."""
    jfm, reads, (jr, jqs, ql, jts, tl, jdir, _), QMAX, TMAX, g = desc_world
    tfm = TorchFM.from_numpy(jax_fm_arrays(jfm), "cpu")
    Q, T = text.desc_windows(
        tfm, torch.from_numpy(reads),
        *(torch.from_numpy(a) for a in (jr, jqs, ql, jts, tl, jdir)),
        QMAX, TMAX)
    lp = len(g)
    for i in range(len(jr)):
        d = int(jdir[i])
        qi = jqs[i] + d * np.arange(ql[i])
        np.testing.assert_array_equal(Q[i, :ql[i]].numpy(),
                                      reads[jr[i], qi])
        assert (Q[i, ql[i]:] == 4).all() and (T[i, tl[i]:] == 4).all()
        p = jts[i] + d * np.arange(tl[i], dtype=np.int64)
        fwd = np.where(p < lp, g[np.clip(p, 0, lp - 1)],
                       3 - g[np.clip(2 * lp - 1 - p, 0, lp - 1)])
        np.testing.assert_array_equal(T[i, :tl[i]].numpy(), fwd)


def test_desc_path_matches_jax(desc_world):
    jfm, reads, jobs, QMAX, TMAX, _ = desc_world
    tfm = TorchFM.from_numpy(jax_fm_arrays(jfm), "cpu")
    mat = jext.make_score_matrix(1, 4)
    want = np.asarray(jext.extend_choose_desc_jit(
        jfm, jnp.asarray(reads), *(jnp.asarray(a) for a in jobs),
        jnp.asarray(mat), jext.ExtendParams(), 5, QMAX, TMAX))
    got = text.extend_choose_desc(
        tfm, torch.from_numpy(reads), *(torch.from_numpy(a) for a in jobs),
        torch.from_numpy(mat), text.ExtendParams(), 5, QMAX, TMAX)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    q, t, ql, tl, h0 = make_jobs(rng, 8, 16, 32)
    before = extend_kernel.LAUNCHES
    out = text.extend_batch_auto(
        *(torch.from_numpy(a) for a in (q, t, ql, tl, h0)),
        torch.from_numpy(jext.make_score_matrix()), text.ExtendParams())
    assert extend_kernel.LAUNCHES == before
    assert out["score"].shape == (8,)

