"""The kernels on the card. K1 (dense extension): exact against its plain
PyTorch version for all four (opt_ext, zdrop > 0) variants at the main
path's widths, on its wide route at QMAX 1024, 1536 and 4096 and with a
global row buffer past 28671 columns, at -x pacbio's scoring in the
object path's three buckets, one launch counted per call, the
wrapper's input checks. K3 (banded extension): exact against its plain
version for (w, zdrop) in (100, 0), (100, 40), (300, 0), (64, 100) with
degenerate lanes, one launch per call, and extend_batch_auto sends the
banded shapes to it and the rest to K1. K2 (local SW): exact against its
plain version at the rescue path's widths and three others (TMAX 3072:
exactly 48 KB of row maxima per block), with and without rev_skip, and at
the seed filter's 200 x 200 windows (minsc 0, rev_skip 0) at the default
and -x pacbio scoring, one launch per call, the wrapper's input checks. K4
(the 16-bit probe): every case exact against its plain version at the
probe's (8, 128), at (3, 34) and at (16384, 1024) on full-range int16, one
launch per call, and the wrapper refuses odd column counts, other dtypes
and misaligned data. Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one.

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
from chip_smoke import make_jobs, make_sw_jobs  # noqa: E402

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


@pytest.mark.parametrize("opt_ext,zdrop", VARIANTS)
@pytest.mark.parametrize("qmax,tmax", [(192, 384), (40, 80), (600, 700)])
def test_kernel_matches_plain(opt_ext, zdrop, qmax, tmax):
    args = _args(1500, qmax, tmax)
    p = extend.ExtendParams(w=24, zdrop=zdrop, opt_ext=opt_ext)
    want = extend_kernel.extend_batch_plain(*args, p)
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


@pytest.mark.parametrize("opt_ext,zdrop", [(False, 0), (True, 40)])
@pytest.mark.parametrize("qmax", [1024, 1536, 4096])
def test_kernel_wide_route_matches_plain(opt_ext, zdrop, qmax):
    # the plain version runs on the host: fewer jobs at the widest row
    args = _args(64 if qmax > 2048 else 300, qmax, qmax + 200)
    p = extend.ExtendParams(w=100, zdrop=zdrop, opt_ext=opt_ext)
    want = extend_kernel.extend_batch_plain(*args, p)
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
    want = extend_kernel.extend_batch_plain(*args, p)
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
    want = extend_kernel.extend_batch_plain(*args, p)
    got = extend_kernel.extend_batch(*(a.cuda() for a in args), p)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


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
    want = extend_banded.extend_batch_banded_plain(*args, p)
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
    want = extend_kernel.extend_batch_plain(*(a.cpu() for a in args), p)
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
    want = swalign_kernel.sw_align_batch_plain(*args, *gaps)
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
    want = swalign_kernel.sw_align_batch_plain(*args, *gaps)
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
