"""The extension kernel on the card: exact against its plain PyTorch
version for all four (opt_ext, zdrop > 0) variants at the main path's
widths, one launch counted per call, the wrapper's input checks, and the
banded routing's refusal. Every test needs an NVIDIA GPU (marker `cuda`)
and skips without one.

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
from chip_smoke import make_jobs  # noqa: E402

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
