"""The kernels on the card. K1 (extension): exact against its plain
PyTorch version for all four (opt_ext, zdrop > 0) variants at the main
path's widths, one launch counted per call, the wrapper's input checks,
and the banded routing's refusal. K2 (local SW): exact against its plain
version at the rescue path's widths and two others, with and without
rev_skip, one launch per call, the wrapper's input checks. Every test
needs an NVIDIA GPU (marker `cuda`) and skips without one.

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
from bwamem_tpu_torch.ops.kernels import extend_kernel  # noqa: E402
from bwamem_tpu_torch.ops.kernels import swalign_kernel  # noqa: E402
from chip_smoke import make_jobs, make_sw_jobs  # noqa: E402

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]
VARIANTS = [(False, 0), (False, 40), (True, 0), (True, 40)]


def _args(n=2000, qmax=192, tmax=384, seed=5):
    rng = np.random.default_rng(seed)
    arrays = make_jobs(rng, n, qmax, tmax)
    return [torch.from_numpy(a) for a in (*arrays,
                                          extend.make_score_matrix(1, 4))]


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
    for k in want:
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


def test_banded_routing_is_not_ported():
    args = [a.cuda() for a in _args(64, qmax=384, tmax=512)]
    p = extend.ExtendParams(w=20, opt_ext=True)  # band 128 < dense row 512
    with pytest.raises(NotImplementedError):
        extend.extend_batch_auto(*args, p)


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
                                         (300, 600, 1024)])
def test_sw_kernel_matches_plain(rev_skip, n, qmax, tmax):
    args = _sw_args(n, qmax, tmax)
    gaps = (6, 1, 6, 1, 1, rev_skip)
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
