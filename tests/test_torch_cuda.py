"""The kernels on the card. K1 (dense extension): exact against its plain
PyTorch version for all four (opt_ext, zdrop > 0) variants at QMAX 40,
192, 600, 1024, 1536, 4096 and 29000 (a global row buffer past 28672
columns), in one launch mixing every width class with its edge lanes
(tlen 0, qlen 0 and 1, h0 = 100000, h0 past 2^20, a match score past
int8), at -x pacbio's scoring in the object path's three buckets, one
launch counted per call, the wrapper's input checks, the job order the
kernel bins on the device against job_bins and fits_i16. K3 (banded
extension): exact against its plain version for (w, zdrop) in (100, 0),
(100, 40), (300, 0), (64, 100) with degenerate lanes, one launch per
call, and extend_batch_auto sends the banded shapes to it and the rest to
K1; its 16-bit pairs where z-drop ends the two alignments of a warp at
unlike rows beside int32 edge lanes (h0 past 2^20), and a matrix outside
int8. K2 (local SW): exact against its
plain version at the rescue path's widths and three others (TMAX 3072),
with and without rev_skip, and at
the seed filter's 200 x 200 windows (minsc 0, rev_skip 0) at the default
and -x pacbio scoring; in one launch spanning every width class with
16-bit and int32 jobs side by side, ties and edge lanes, in all four
(rev_skip, minsc) variants; with a matrix outside int8; one launch per
call, the wrapper's input checks. K4
(the 16-bit probe): every case exact against its plain version at the
probe's (8, 128), at (3, 34) and at (16384, 1024) on full-range int16, one
launch per call, and the wrapper refuses odd column counts, other dtypes
and misaligned data. The fused step (models/mem.py) equals itself on the
CPU at 150 bp (one K1 launch) and 1 kb (one K3 launch); a mesh of one
card equals one device, step and aligner SAM (SE and PE); `align
--n-chips` past the visible cards exits with an error. The seeding
kernels S1-S4 (ops/kernels/seed_kernels.py): every call of
smem_seed_batch (re-seed rounds on, max_occ subsampling) against its
plain version by the kernel's rule, on reads with N bases and of length
0, 1, 2 and 19, at 32, 160, 1024 and 4096 columns, with occ2 and
without, narrow and forced wide, S1 with and without round 3, the
round-2 lanes with floors above 1; the final seeds equal the plain
route's and the CPU's, one launch a wrapper call; S4 on every BWT row;
the wrappers' input checks. Every test needs
an NVIDIA GPU (marker `cuda`) and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bwamem_tpu_torch.ops import extend  # noqa: E402
from bwamem_tpu_torch.ops.kernels import extend_banded  # noqa: E402
from bwamem_tpu_torch.ops.kernels import extend_kernel  # noqa: E402
from bwamem_tpu_torch.ops.kernels import int16_probe  # noqa: E402
from bwamem_tpu_torch.ops.kernels import swalign_kernel  # noqa: E402
from chip_smoke import PACBIO, make_filter_jobs  # noqa: E402
from chip_smoke import make_jobs, make_mixed_jobs  # noqa: E402
from chip_smoke import make_sw_jobs  # noqa: E402

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]
VARIANTS = [(False, 0), (False, 40), (True, 0), (True, 40)]


def _args(n=2000, qmax=192, tmax=384, seed=5, tail=160, b=4):
    rng = np.random.default_rng(seed)
    arrays = make_jobs(rng, n, qmax, tmax, tail)
    return [torch.from_numpy(a) for a in (*arrays,
                                          extend.make_score_matrix(1, b))]


def _plain(fn, args, *rest):
    """A plain version on copies of the inputs on the card (the same torch
    ops as on the host, quicker there), its result back on the host."""
    out = fn(*(a.cuda() for a in args), *rest)
    if isinstance(out, dict):
        return {k: v.cpu() for k, v in out.items()}
    return out.cpu()


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS)
@pytest.mark.parametrize("qmax,tmax", [(192, 384), (40, 80), (600, 700)])
def test_kernel_matches_plain(opt_ext, zdrop, qmax, tmax):
    args = _args(1500, qmax, tmax)
    p = extend.ExtendParams(w=24, zdrop=zdrop, opt_ext=opt_ext)
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    before = extend_kernel.LAUNCHES
    got = extend_kernel.extend_batch(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    assert extend_kernel.LAUNCHES == before + 1
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_wrapper_checks_inputs():
    args = [a.cuda() for a in _args(64)]
    p = extend.ExtendParams()
    with pytest.raises(ValueError):  # int32 query: the kernel takes int8
        extend_kernel.extend_batch(args[0].int(), *args[1:], p)
    with pytest.raises(ValueError):  # non-contiguous target
        extend_kernel.extend_batch(args[0], args[1].t().contiguous().t(),
                                   *args[2:], p)
    empty = [a[:0] for a in args[:5]] + [args[5]]
    before = extend_kernel.LAUNCHES
    out = extend_kernel.extend_batch(*empty, p)
    assert out["score"].shape == (0,) and extend_kernel.LAUNCHES == before


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS)
@pytest.mark.parametrize("qmax", [1024, 1536, 4096])
def test_kernel_wide_route_matches_plain(opt_ext, zdrop, qmax):
    # fewer jobs at the widest rows keep the plain version quick
    args = _args(64 if qmax > 2048 else 300, qmax, qmax + 200)
    p = extend.ExtendParams(w=100, zdrop=zdrop, opt_ext=opt_ext)
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    before = extend_kernel.LAUNCHES
    got = extend_kernel.extend_batch(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    assert extend_kernel.LAUNCHES == before + 1
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("qmax,tmax", [(64, 1024), (192, 768), (1024, 2048)])
def test_kernel_pacbio_matches_plain(qmax, tmax):
    """-x pacbio's scoring (mismatch 1, gap open and extension 1, no end
    bonus) at the object path's buckets, targets up to the whole TMAX."""
    args = _args(300 if qmax > 192 else 1500, qmax, tmax, tail=tmax, b=1)
    gaps = {k: v for k, v in PACBIO.items() if k not in ("a", "b")}
    p = extend.ExtendParams(w=300, zdrop=0, opt_ext=False, **gaps)
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    before = extend_kernel.LAUNCHES
    got = extend_kernel.extend_batch(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    assert extend_kernel.LAUNCHES == before + 1
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_kernel_wide_route_global_rows():
    """29000 columns: one warp's row does not fit in shared memory, so
    the wrapper hands the kernel a global row buffer."""
    qmax = 29_000
    args = _args(24, qmax, qmax + 64)
    args[3].clamp_(max=300)  # short targets keep the plain version quick
    assert extend_kernel._wide_scratch(24, qmax, "cpu") is not None
    p = extend.ExtendParams()
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    got = extend_kernel.extend_batch(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS[1:])
def test_kernel_global_rows_other_variants(opt_ext, zdrop):
    """The global row buffer (29000 columns) under the other three
    (opt_ext, zdrop) variants."""
    qmax = 29_000
    args = _args(24, qmax, qmax + 64, seed=9)
    args[3].clamp_(max=300)
    p = extend.ExtendParams(w=100, zdrop=zdrop, opt_ext=opt_ext)
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    got = extend_kernel.extend_batch(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS)
@pytest.mark.parametrize("qmax,tmax", [(192, 384), (1100, 1300)])
def test_kernel_mixed_widths_one_launch(opt_ext, zdrop, qmax, tmax):
    """One launch whose jobs span every width class with the edge lanes
    of chip_smoke.make_mixed_jobs (qlen 0..QMAX, one long job among short
    ones, tlen 0, qlen 1 and -3, h0 100000 and past 2^20); then the same
    jobs under a matrix with a match score of 200 (outside int8)."""
    args = [torch.from_numpy(a) for a in (
        *make_mixed_jobs(np.random.default_rng(31), 700, qmax, tmax),
        extend.make_score_matrix(1, 4))]
    for a in (1, 200):
        if a != 1:
            args[5] = args[5].clone()
            args[5].fill_diagonal_(a)
        p = extend.ExtendParams(w=40, zdrop=zdrop, opt_ext=opt_ext,
                                max_mat=a)
        want = _plain(extend_kernel.extend_batch_plain, args, p)
        before = extend_kernel.LAUNCHES
        got = extend_kernel.extend_batch(*(x.cuda() for x in args), p)
        torch.cuda.synchronize()
        assert extend_kernel.LAUNCHES == before + 1
        for k in got:
            assert torch.equal(got[k].cpu(), want[k]), (a, k)


def test_kernel_job_order_matches_job_bins():
    """The job order the kernel builds on the device (its workspace after
    a launch) takes the jobs in job_bins' bin order, each once, flagged
    FITS16 exactly where fits_i16 admits the job; the results are exact."""
    args = [torch.from_numpy(a) for a in (
        *make_mixed_jobs(np.random.default_rng(31), 700, 1100, 1300),
        extend.make_score_matrix(1, 4))]
    p = extend.ExtendParams(w=40, zdrop=40)
    q, t, ql, tl, h0, mat = (a.cuda() for a in args)
    N, QMAX = q.shape
    TMAX = t.shape[1]
    out = torch.empty((N, 6), dtype=torch.int32, device="cuda")
    work = torch.empty(N + extend_kernel.WORK_HEADER, dtype=torch.int32,
                       device="cuda")
    assert extend_kernel._wide_scratch(N, QMAX, "cuda") is None
    rc = extend_kernel._load().bm_extend_dense(
        q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(),
        h0.data_ptr(), mat.data_ptr(), work.data_ptr(), out.data_ptr(), 0,
        N, QMAX, TMAX, p.o_del, p.e_del, p.o_ins, p.e_ins, p.w, p.zdrop,
        p.end_bonus, int(p.opt_ext), p.max_mat,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    ent = work[extend_kernel.WORK_HEADER:].cpu().long()
    job = ent & (extend_kernel.FITS16 - 1)
    assert sorted(job.tolist()) == list(range(N))
    fits = extend_kernel.fits_i16(args[3], args[4], args[5], p, QMAX, TMAX)
    assert not bool(fits.all()) and bool(fits.any())
    assert torch.equal((ent & extend_kernel.FITS16) != 0, fits[job])
    bins, _ = extend_kernel.job_bins(args[2], args[3], fits, QMAX, TMAX)
    assert bool((bins[job].diff() >= 0).all())
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    got = extend_kernel._fields(out.cpu())
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _banded_args(n, qmax, tmax, seed=7):
    args = _args(n, qmax, tmax, seed)
    q, t = args[0], args[1]
    q[5, 10:40] = 4  # N runs in the query and the target
    t[6, 5:30] = 4
    return args


@pytest.mark.parametrize("w,zdrop", [(100, 0), (100, 40), (300, 0),
                                     (64, 100)])
def test_banded_kernel_matches_plain(w, zdrop):
    qmax = 1024 if w == 300 else 384
    args = _banded_args(1200, qmax, qmax + 256)
    p = extend.ExtendParams(w=w, zdrop=zdrop, opt_ext=True)
    want = _plain(extend_banded.extend_batch_banded_plain, args, p)
    before = extend_banded.LAUNCHES
    got = extend_banded.extend_batch_banded(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    assert extend_banded.LAUNCHES == before + 1
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_banded_wrapper_checks_inputs():
    args = [a.cuda() for a in _banded_args(64, 384, 512)]
    with pytest.raises(ValueError):  # window of 1152 lanes
        extend_banded.extend_batch_banded(
            *args, extend.ExtendParams(w=520, opt_ext=True))
    with pytest.raises(ValueError):  # int32 query: the kernel takes int8
        extend_banded.extend_batch_banded(args[0].int(), *args[1:],
                                          extend.ExtendParams(w=100))


@pytest.mark.parametrize("w,opt_ext,qmax,route", [
    (20, True, 384, "K3"),     # band 128 < dense row 512
    (100, True, 256, "K3"),    # --vanilla, 250 bp reads: 256 < 384
    (100, True, 192, "K1"),    # band 256 = dense row 256
    (20, False, 384, "K1"),    # no opt_ext: dense
    (520, True, 2048, "K1"),   # window of 1152 lanes: past K3's registers
])
def test_extend_batch_auto_routes(w, opt_ext, qmax, route):
    args = [a.cuda() for a in _banded_args(64, qmax, qmax + 128)]
    p = extend.ExtendParams(w=w, opt_ext=opt_ext)
    before = (extend_kernel.LAUNCHES, extend_banded.LAUNCHES)
    got = extend.extend_batch_auto(*args, p)
    torch.cuda.synchronize()
    after = (extend_kernel.LAUNCHES, extend_banded.LAUNCHES)
    assert after == ((before[0], before[1] + 1) if route == "K3"
                     else (before[0] + 1, before[1]))
    want = _plain(extend_kernel.extend_batch_plain, args, p)
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


def _sw_args(n, qmax, tmax, seed=6, minsc=19):
    rng = np.random.default_rng(seed)
    q, t, ql, tl = make_sw_jobs(rng, n, qmax, tmax)
    wide = rng.random(n) < 0.3  # queries across the whole width too
    ql[5:][wide[5:]] = rng.integers(1, qmax + 1, int(wide[5:].sum()))
    return [torch.from_numpy(a) for a in (
        q, t, ql, tl, np.full(n, minsc, np.int32),
        extend.make_score_matrix(1, 4))]


@pytest.mark.parametrize("rev_skip", [0, 19])
@pytest.mark.parametrize("n,qmax,tmax", [(1200, 192, 768), (1200, 40, 80),
                                         (300, 600, 1024), (200, 150, 3072)])
def test_sw_kernel_matches_plain(rev_skip, n, qmax, tmax):
    args = _sw_args(n, qmax, tmax)
    gaps = (6, 1, 6, 1, 1, rev_skip)
    want = _plain(swalign_kernel.sw_align_batch_plain, args, *gaps)
    before = swalign_kernel.LAUNCHES
    got = swalign_kernel.sw_align_batch(*(a.cuda() for a in args), *gaps)
    torch.cuda.synchronize()
    assert swalign_kernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("scoring", ["default", "pacbio"])
def test_sw_kernel_seed_filter_shape(scoring):
    """The per-seed SW filter's launch: 200 x 200 windows, rev_skip 0 and
    minsc 0, at the default scoring and at -x pacbio's."""
    rng = np.random.default_rng(8)
    q, t, ql, tl = make_filter_jobs(rng, 2000, 200, 200)
    sc = PACBIO if scoring == "pacbio" else dict(a=1, b=4, o_del=6, e_del=1,
                                                 o_ins=6, e_ins=1)
    args = [torch.from_numpy(a) for a in (
        q, t, ql, tl, np.zeros(len(ql), np.int32),
        extend.make_score_matrix(sc["a"], sc["b"]))]
    gaps = (sc["o_del"], sc["e_del"], sc["o_ins"], sc["e_ins"], sc["a"], 0)
    want = _plain(swalign_kernel.sw_align_batch_plain, args, *gaps)
    before = swalign_kernel.LAUNCHES
    got = swalign_kernel.sw_align_batch(*(a.cuda() for a in args), *gaps)
    torch.cuda.synchronize()
    assert swalign_kernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


def test_sw_wrapper_checks_inputs():
    args = [a.cuda() for a in _sw_args(64, 48, 96)]
    gaps = (6, 1, 6, 1, 1)
    with pytest.raises(ValueError):  # int32 query: the kernel takes int8
        swalign_kernel.sw_align_batch(args[0].int(), *args[1:], *gaps)
    with pytest.raises(ValueError):  # non-contiguous target
        swalign_kernel.sw_align_batch(args[0], args[1].t().contiguous().t(),
                                      *args[2:], *gaps)
    empty = [a[:0] for a in args[:5]] + [args[5]]
    before = swalign_kernel.LAUNCHES
    out = swalign_kernel.sw_align_batch(*empty, *gaps)
    assert out.shape == (6, 0) and swalign_kernel.LAUNCHES == before


@pytest.mark.parametrize("shape", [(8, 128), (3, 34), (16384, 1024)])
@pytest.mark.parametrize("name", int16_probe.NAMES)
def test_int16_probe_matches_plain(name, shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    if shape == (8, 128):  # the probe's own input
        x = (np.arange(1024, dtype=np.int16) % 100).reshape(shape)
    else:
        x = rng.integers(-32768, 32768, shape, dtype=np.int16)
        x[0, 0], x[-1, -1] = -32768, 32767
    xc = torch.from_numpy(x).cuda()
    before = int16_probe.LAUNCHES
    got = int16_probe.run_case(name, xc)
    torch.cuda.synchronize()
    assert int16_probe.LAUNCHES == before + 1
    want = int16_probe.PLAIN[name](xc)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), int16_probe.PLAIN[name](xc.cpu()))


def test_int16_probe_wrapper_checks_inputs():
    before = int16_probe.LAUNCHES
    for bad in (torch.zeros((4, 33), dtype=torch.int16, device="cuda"),
                torch.zeros((4, 34), dtype=torch.int32, device="cuda"),
                torch.zeros(4 * 34 + 1, dtype=torch.int16,
                            device="cuda")[1:].view(4, 34)):
        with pytest.raises(ValueError):
            int16_probe.run_case("roll", bad)
    assert int16_probe.LAUNCHES == before


def _mixed_sw_args(n=1600, qmax=1000, tmax=700, seed=12, minsc=19, a=25):
    """One K2 launch over every width class: make_sw_jobs' jobs with qlen
    0..qmax in even steps over the first 200 jobs, short and long ones
    after; at a match score of 25 the jobs whose min(qlen, tlen) passes
    about 600 take int32 cells beside the 16-bit rest. Ties: queries and
    targets of a repeated base or a repeated pair (many cells share the
    row max, and many rows the best), an all-N target, qlen 0 and 1,
    tlen 0 and 1, a full-width job."""
    rng = np.random.default_rng(seed)
    q, t, ql, tl = make_sw_jobs(rng, n, qmax, tmax)
    ql[:200] = np.arange(200) * (qmax // 200)
    ql[200:] = rng.integers(0, qmax + 1, n - 200)
    tl[:] = rng.integers(0, tmax + 1, n)
    q[10:20] = 0
    t[10:20] = 0
    q[20:30] = np.tile([1, 2], qmax // 2)
    t[20:30] = np.tile([1, 2], tmax // 2)
    t[30] = 4
    ql[31], ql[32], tl[33], tl[34] = 0, 1, 0, 1
    ql[35], tl[35] = qmax, tmax
    return [torch.from_numpy(x) for x in (
        q, t, ql, tl, np.full(n, minsc, np.int32),
        extend.make_score_matrix(a, 4))]


@pytest.mark.parametrize("rev_skip,minsc", [(0, 0), (0, 19), (19, 0),
                                            (19, 19)])
def test_sw_kernel_every_class_in_one_launch(rev_skip, minsc):
    """K2 in one launch spanning every width class, 16-bit and int32 jobs
    side by side, ties on the earliest column and row, edge lanes: exact
    against the plain version in all four (rev_skip, minsc) variants."""
    args = _mixed_sw_args(minsc=minsc)
    gaps = (6, 1, 6, 1, 25, rev_skip)
    fits = swalign_kernel.fits_i16(args[2], args[3], args[5], *gaps[:4],
                                   args[0].shape[1], args[1].shape[1])
    assert 0 < int(fits.sum()) < len(fits)
    want = _plain(swalign_kernel.sw_align_batch_plain, args, *gaps)
    before = swalign_kernel.LAUNCHES
    got = swalign_kernel.sw_align_batch(*(a.cuda() for a in args), *gaps)
    torch.cuda.synchronize()
    assert swalign_kernel.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


def test_sw_kernel_matrix_outside_int8():
    """A match score past a signed byte: every job takes the int32 cells
    with the score from the shared matrix and a 64-bit row-max key."""
    args = _mixed_sw_args(n=600, qmax=300, tmax=300, a=300)
    gaps = (6, 1, 6, 1, 300, 19)
    want = _plain(swalign_kernel.sw_align_batch_plain, args, *gaps)
    got = swalign_kernel.sw_align_batch(*(a.cuda() for a in args), *gaps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("w,zdrop", [(100, 100), (100, 30), (300, 100)])
def test_banded_pairs_of_unlike_rows_under_zdrop(w, zdrop):
    """K3's 16-bit pairs where z-drop ends the two alignments of a warp at
    very different rows (targets that turn random after a prefix of
    random length), beside edge lanes on int32 cells (h0 = 100000, h0
    past 2^20 with its 64-bit key, qlen 0 and 1, tlen 0) and a full-width
    job: exact against the plain version."""
    qmax = 1024 if w == 300 else 256
    tmax = qmax + 256
    rng = np.random.default_rng(w + zdrop)
    q, t, ql, tl, h0 = make_jobs(rng, 1500, qmax, tmax, tail=256)
    cut = rng.integers(0, tmax, len(ql))
    for i in np.flatnonzero(rng.random(len(ql)) < 0.6):
        t[i, cut[i]:] = rng.integers(0, 4, tmax - cut[i])
    ql[5], ql[6], tl[7] = 0, 1, 0
    h0[8:11] = 3_000_000
    args = [torch.from_numpy(x) for x in (q, t, ql, tl, h0,
                                          extend.make_score_matrix(1, 4))]
    p = extend.ExtendParams(w=w, zdrop=zdrop, opt_ext=True)
    want = _plain(extend_banded.extend_batch_banded_plain, args, p)
    got = extend_banded.extend_batch_banded(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    rows = want["rows"]
    assert int(rows.max()) > 4 * int(rows[rows > 0].min())
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_banded_matrix_outside_int8():
    """A match score past a signed byte: every alignment takes the int32
    cells with the score from the shared matrix and a 64-bit key."""
    args = _banded_args(400, 256, 384)
    args[5] = torch.from_numpy(extend.make_score_matrix(200, 4))
    p = extend.ExtendParams(w=100, zdrop=100, opt_ext=True, max_mat=200)
    want = _plain(extend_banded.extend_batch_banded_plain, args, p)
    got = extend_banded.extend_batch_banded(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_sw_kernel_rows_past_shared_memory():
    """Past 14528 target rows K2 keeps its row maxima in a global buffer
    the wrapper allocates: exact against the plain version, with score2's
    rows far from the best one."""
    rng = np.random.default_rng(14)
    args = _sw_args(96, 160, 16_000, seed=14)
    tl = args[3].numpy()
    tl[:8] = rng.integers(14_600, 16_001, 8)
    gaps = (6, 1, 6, 1, 1, 19)
    want = _plain(swalign_kernel.sw_align_batch_plain, args, *gaps)
    got = swalign_kernel.sw_align_batch(*(a.cuda() for a in args), *gaps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.fixture(scope="module")
def sim_world():
    """A 200 kb repeat-rich genome (the port's index) with 150 bp and 1 kb
    simulated reads as code arrays."""
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import (make_repeat_genome,
                                                  simulate_reads)

    rng = np.random.default_rng(31)
    contigs, _ = make_repeat_genome(rng, 200_000, n_contigs=1)
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)].copy()
    g[g > 3] = 0
    idx = build_index_from_codes(g, Annotation(
        names=["c"], lengths=[len(g)], offsets=[0]), sa_intv=4)

    def codes(reads):
        return [_CODE_LUT[np.frombuffer(r.seq.encode(), np.uint8)]
                for r in reads]

    short = codes(simulate_reads(rng, contigs, 600, read_len=150, sub=0.01))
    long = codes(simulate_reads(rng, contigs, 64, read_len=1000, sub=0.01,
                                ins=0.002, dele=0.002))
    return idx, short, long


@pytest.mark.parametrize("which,kernel,other", [
    ("short", extend_kernel, extend_banded),
    ("long", extend_banded, extend_kernel)])
def test_fused_step_matches_cpu(sim_world, which, kernel, other):
    """The fused step on the card equals it on the CPU, output for output:
    150 bp reads launch K1 (and not K3), 1 kb reads, whose band window is
    narrower than the row, launch K3 (and not K1)."""
    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.models.mem import device_align_step
    from chip_smoke import _reads_tensors

    idx, short, long = sim_world
    seqs = short if which == "short" else long
    reads, lens = _reads_tensors(seqs, "cpu")
    want = device_align_step(DeviceFMIndex.from_host(idx, "cpu"), reads,
                             lens)
    k0, o0 = kernel.LAUNCHES, other.LAUNCHES
    got = device_align_step(DeviceFMIndex.from_host(idx, "cuda"),
                            reads.cuda(), lens.cuda())
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == k0 + 1 and other.LAUNCHES == o0
    assert got["has_seed"].float().mean() > 0.9
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_mesh_of_one_card_matches_one_device(sim_world):
    """A mesh of the first card: sharded_align_step equals the step, and
    MemAligner(mesh=...) gives the SAM of MemAligner() (SE and PE)."""
    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.models.mem import device_align_step
    from bwamem_tpu_torch.parallel import sharded
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions
    from chip_smoke import _reads_tensors

    idx, short, _ = sim_world
    fm = DeviceFMIndex.from_host(idx, "cuda")
    mesh = sharded.make_mesh(1)
    reads, lens = _reads_tensors(short, "cuda")
    out, total = sharded.sharded_align_step(mesh)(
        sharded.replicate_index(mesh, fm),
        *sharded.shard_reads(mesh, reads, lens)[:2])
    one = device_align_step(fm, reads, lens)
    assert total == int(one["n_seeds"])
    for k in out:
        assert torch.equal(out[k], one[k]), k
    names = [f"r{i}" for i in range(len(short))]
    runs = [MemAligner(MemOptions(), idx, fm=fm, mesh=m)
            for m in (None, mesh)]
    sams = [(al.align_batch(names, short),
             al.align_pairs_batch(names[:400], short[:400])) for al in runs]
    assert sams[0] == sams[1]


def test_cli_refuses_more_cards_than_visible(tmp_path):
    """`align --n-chips N` past the visible cards exits with an error."""
    import subprocess

    from bwamem_tpu_torch.cli import main

    g = "".join(np.random.default_rng(3).choice(list("ACGT"), 3000))
    (tmp_path / "ref.fa").write_text(f">c\n{g}\n")
    (tmp_path / "r.fq").write_text(f"@r\n{g[100:250]}\n+\n{'I' * 150}\n")
    assert main(["index", str(tmp_path / "ref.fa"), "-p",
                 str(tmp_path / "idx")]) == 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n = torch.cuda.device_count() + 1
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "align", "--n-chips",
         str(n), str(tmp_path / "idx"), str(tmp_path / "r.fq"), "-o",
         str(tmp_path / "out.sam")],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode != 0
    assert f"--n-chips {n}" in res.stderr and "visible" in res.stderr


# ---- the seeding kernels S1-S4 (ops/kernels/seed_kernels.py) ----

SEED_FORMS = ("occ2", "no_occ2", "occ2_wide", "no_occ2_wide")


@pytest.fixture(scope="module")
def seed_index():
    """(genome codes, FMIndex) of a 60 kb repeat-rich simulated genome."""
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import make_repeat_genome

    rng = np.random.default_rng(21)
    contigs, _ = make_repeat_genome(rng, 60_000, n_contigs=1)
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)].copy()
    g[g > 3] = rng.integers(0, 4, int((g > 3).sum()), dtype=np.uint8)
    return g, build_index_from_codes(g, Annotation(
        names=["c"], lengths=[len(g)], offsets=[0]), sa_intv=4)


def _seed_fm(idx, form, device="cuda"):
    import dataclasses

    from bwamem_tpu_torch.index.device import DeviceFMIndex

    fm = DeviceFMIndex.from_host(idx, device, occ2=form.startswith("occ2"))
    return dataclasses.replace(fm, wide=True) if "wide" in form else fm


@pytest.mark.parametrize("L", [32, 160, 1024, 4096])
@pytest.mark.parametrize("form", SEED_FORMS)
def test_seed_kernels_match_plain(seed_index, form, L):
    """Every call smem_seed_batch makes (re-seed rounds on, max_occ 3) on
    the card, each kernel against its plain version on the card by its
    rule (chip_smoke.check_seed_call: S1 and S3 on their emit masks and
    every emitted entry, S2 on the kept mask and every kept lane, S4 bit
    for bit), the round-2 lanes with floors above 1; the final seeds equal
    the plain route's, with one launch a wrapper call; then S1 without
    round 3, and round 1 alone."""
    from bwamem_tpu_torch.ops import seeding as sd
    from bwamem_tpu_torch.ops.kernels import seed_kernels as sk
    from chip_smoke import (check_seed_call, make_seed_reads,
                            seed_route_check)

    g, idx = seed_index
    reads, lens = make_seed_reads(g, np.random.default_rng(L),
                                  {32: 64, 160: 64, 1024: 16, 4096: 8}[L], L)
    fm = _seed_fm(idx, form)
    reads_t = torch.from_numpy(reads).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    before = dict(sk.LAUNCHES)
    calls = seed_route_check(f"{form} {L}", fm, reads_t, lens_t,
                             sd.SeedConfig(reseed=True, max_occ=3))
    torch.cuda.synchronize()
    assert {k: sk.LAUNCHES[k] - before[k] for k in before} == dict(
        seed_forward=1, seed_backward=2, seed_reseed_forward=1, sa_lookup=1)
    assert [c[0] for c in calls] == ["seed_forward", "seed_backward",
                                     "seed_reseed_forward", "seed_backward",
                                     "sa_lookup"]
    assert int(calls[3][2]["floor"].max()) > 1
    for call in calls:
        assert check_seed_call(f"{form} {L}", call, timed=False)[
            "max_abs_err"] == 0
    call = ("seed_forward", (fm, reads_t, lens_t, 19), {})
    assert check_seed_call("without round 3", call, False)["max_abs_err"] == 0
    before = dict(sk.LAUNCHES)
    seed_route_check(f"{form} {L} round 1", fm, reads_t, lens_t,
                     sd.SeedConfig())
    assert {k: sk.LAUNCHES[k] - before[k] for k in before} == dict(
        seed_forward=1, seed_backward=1, seed_reseed_forward=0, sa_lookup=1)


@pytest.mark.parametrize("reseed", [False, True])
def test_smem_seed_batch_card_equals_cpu(seed_index, reseed):
    """smem_seed_batch on the card (S1-S4) gives the CPU's seeds."""
    from bwamem_tpu_torch.ops import seeding as sd

    g, idx = seed_index
    reads, lens = map(torch.from_numpy, make_seed_reads_150(g))
    cfg = sd.SeedConfig(reseed=reseed)
    want = sd.smem_seed_batch(_seed_fm(idx, "occ2", "cpu"), reads, lens, cfg)
    got = sd.smem_seed_batch(_seed_fm(idx, "occ2"), reads.cuda(),
                             lens.cuda(), cfg)
    assert len(want["rbeg"]) > 0
    for k in ("read_id", "qbeg", "qend", "rbeg", "n_occ"):
        assert torch.equal(got[k].cpu(), want[k]), k


def make_seed_reads_150(g):
    from chip_smoke import make_seed_reads

    return make_seed_reads(g, np.random.default_rng(150), 256, 160)


@pytest.mark.parametrize("form", ["occ2", "occ2_wide"])
def test_sa_lookup_every_row(seed_index, form):
    """S4 equals sa_lookup_batch bit for bit on every BWT row."""
    from bwamem_tpu_torch.ops import fm as fmops
    from bwamem_tpu_torch.ops.kernels import seed_kernels as sk

    _, idx = seed_index
    fm = _seed_fm(idx, form)
    rows = torch.arange(int(fm.seq_len) + 1, device="cuda")
    before = sk.LAUNCHES["sa_lookup"]
    got = sk.sa_lookup(fm, rows)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["sa_lookup"] == before + 1
    assert torch.equal(got, fmops.sa_lookup_batch(fm, rows))


def test_seed_wrappers_check_inputs(seed_index):
    """The wrappers refuse an index on another device and lanes of unlike
    lengths, and launch nothing for an empty batch."""
    from bwamem_tpu_torch.ops.kernels import seed_kernels as sk

    g, idx = seed_index
    reads, lens = (torch.from_numpy(a).cuda()
                   for a in make_seed_reads_150(g))
    with pytest.raises(ValueError):
        sk.seed_forward(_seed_fm(idx, "occ2", "cpu"), reads, lens, 19)
    fm = _seed_fm(idx, "occ2")
    with pytest.raises(ValueError):
        sk.seed_forward(fm, reads, lens[:-1], 19)
    z = torch.zeros(3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        sk.seed_backward(fm, reads, z, z[:2], z, z)
    before = dict(sk.LAUNCHES)
    planes, r3 = sk.seed_forward(fm, reads[:0], lens[:0], 19)
    assert planes[3].shape == (0, 162) and r3 is None
    assert sk.sa_lookup(fm, z[:0].long()).shape == (0,)
    assert sk.LAUNCHES == before
