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



# the main path's K1 shapes (QMAX, TMAX, the largest h0 a seed gives there)
# and their scoring: 150 bp reads, 1 kb reads, -x pacbio's 1024 bucket
I16_SHAPES = [(192, 384, 160, {}), (1024, 2048, 1000, {}),
              (1024, 2048, 1000, dict(o_del=1, e_del=1, o_ins=1, e_ins=1,
                                      end_bonus=0))]


def _i16_top(h0, tlen, QMAX, TMAX, p, amax=1):
    """fits_i16's sum, as its docstring states it."""
    width = min(c for c in extend_kernel.CLASS_COLS if c >= min(QMAX, 1024))
    return (h0 + amax * min(tlen, TMAX) + p.e_ins * (width + 1)
            + max(p.o_del + p.e_del, p.o_ins + p.e_ins) + p.end_bonus)


@pytest.mark.parametrize("QMAX,TMAX,h0max,gaps", I16_SHAPES,
                         ids=["main", "1kb", "pacbio"])
def test_fits_i16_at_the_main_path_shapes(QMAX, TMAX, h0max, gaps):
    """The 16-bit predicate admits every job of the main path's shapes
    (h0 up to a whole read's seed, targets up to TMAX) and refuses the
    h0 = 100000 edge lane and the first h0 past its limit."""
    p = text.ExtendParams(**gaps)
    b = 1 if gaps else 4
    mat = torch.from_numpy(jext.make_score_matrix(1, b))
    tlen = torch.tensor([0, 1, TMAX // 2, TMAX, TMAX + 5], dtype=torch.int32)
    h0 = torch.full_like(tlen, h0max)
    assert bool(extend_kernel.fits_i16(tlen, h0, mat, p, QMAX, TMAX).all())
    assert not bool(extend_kernel.fits_i16(
        tlen, torch.full_like(tlen, 100_000), mat, p, QMAX, TMAX).any())
    # the largest h0 that fits for a full-length target, and the next one
    edge = extend_kernel.I16_LIMIT - 1 - _i16_top(0, TMAX, QMAX, TMAX, p)
    h = torch.tensor([edge, edge + 1], dtype=torch.int32)
    t = torch.tensor([TMAX, TMAX], dtype=torch.int32)
    assert extend_kernel.fits_i16(t, h, mat, p, QMAX, TMAX).tolist() == [
        True, False]
    assert not bool(extend_kernel.fits_i16(
        t[:1], torch.tensor([-1], dtype=torch.int32), mat, p, QMAX, TMAX))
    # a match score of 2, or an entry outside a signed byte: int32 cells
    for a, b in ((2, 4), (1, 200)):
        m2 = torch.from_numpy(jext.make_score_matrix(a, b))
        assert not bool(extend_kernel.fits_i16(
            tlen, h0, m2, p, QMAX, TMAX).any())


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS)
def test_plain_in_int16_at_the_predicate_edge(opt_ext, zdrop):
    """The plain version's recurrence run in int16 (what a kernel with two
    16-bit cells a register computes) equals the int64 version on jobs
    at fits_i16's edge: each job's h0 is the largest its target length
    admits, so its cells climb to just below 2^14."""
    rng = np.random.default_rng(11)
    QMAX, TMAX = 40, 96
    q, t, ql, tl, _ = make_jobs(rng, 96, QMAX, TMAX)
    p = _params(opt_ext, zdrop, text)
    h0 = np.array([extend_kernel.I16_LIMIT - 1
                   - _i16_top(0, int(x), QMAX, TMAX, p) for x in tl],
                  dtype=np.int32)
    args = [torch.from_numpy(a) for a in (q, t, ql, tl, h0,
                                          jext.make_score_matrix())]
    assert bool(extend_kernel.fits_i16(args[3], args[4], args[5], p, QMAX,
                                       TMAX).all())
    want = extend_kernel.extend_batch_plain(*args, p)
    got = extend_kernel._plain(*args, p, torch.int16)
    assert int(want["score"].max()) > extend_kernel.I16_LIMIT - 200
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_job_order_is_a_permutation_back_to_job_order():
    """job_bins states the kernel's job order: the widest width class
    first, its 16-bit jobs first, then by rows (powers of two), most
    first. Taking the jobs in bin order is a permutation, and the kernel
    writes job k's result at row k, so the results come back in job
    order: here the plain version run on the jobs in bin order and
    scattered back equals it run on the jobs as given."""
    rng = np.random.default_rng(12)
    QMAX, TMAX = 1100, 1200
    N = 300
    q, t, ql, tl, h0 = make_jobs(rng, N, QMAX, TMAX)
    ql[:40] = rng.integers(0, 33, 40)
    ql[40] = -1
    ql[41:45] = [32, 33, 1024, 1025]
    tl = np.minimum(tl, rng.integers(0, 48, N)).astype(np.int32)
    tl[45:49] = [0, 1, 3, 4]
    args = [torch.from_numpy(a) for a in (q, t, ql, tl, h0,
                                          jext.make_score_matrix())]
    fits = torch.from_numpy(rng.random(N) < 0.7)
    bins, cls = extend_kernel.job_bins(args[2], args[3], fits, QMAX, TMAX)
    assert bins.dtype == torch.int64 and cls.dtype == torch.int64
    qcol = args[2].long().clamp(0, QMAX)
    # class c holds the jobs of edges[c] < qcol <= edges[c + 1] (class 0
    # from qcol 0; the wide route past 1024)
    edges = (-1,) + extend_kernel.CLASS_COLS + (QMAX,)
    for c in range(len(edges) - 1):
        sel = cls == c
        assert bool(((qcol[sel] > edges[c]) & (qcol[sel] <= edges[c + 1])
                     ).all()), c
    assert cls[41:45].tolist() == [0, 1, 5, 6]
    # rows 0 | 1 | 2-3 | 4-7 ...: a bin per power of two, capped
    rows = args[3].long().clamp(0, TMAX).tolist()
    bucket = [min(r.bit_length(), extend_kernel.ROW_BINS - 1) for r in rows]
    assert bucket[45:49] == [0, 1, 2, 3]
    order = torch.argsort(bins, stable=True)
    assert sorted(order.tolist()) == list(range(N))
    # in bin order: the class descending, then 16-bit jobs first, then
    # the rows' bin descending
    lex = [(int(cls[j]), bool(fits[j]), bucket[j]) for j in order.tolist()]
    assert all(x >= y for x, y in zip(lex, lex[1:]))
    assert len({(c, f, r) for c, f, r in lex}) == len(set(bins.tolist()))
    p = _params(False, 40, text)
    want = extend_kernel.extend_batch_plain(*args, p)
    part = extend_kernel.extend_batch_plain(
        *(a[order] for a in args[:5]), args[5], p)
    for name in want:
        back = torch.empty_like(part[name])
        back[order] = part[name]
        assert torch.equal(back, want[name]), name
