"""The 16-bit probe K4 (ops/kernels/int16_probe.py) on the CPU:

  * tools/mosaic_probe.py — the Pallas TPU probe — runs with every
    pl.pallas_call in interpret mode and its six outputs recorded; the
    port's plain version of each case equals that output exactly;
  * the plain versions equal numpy on ragged and full-range int16 shapes;
  * the wrapper refuses odd column counts, other dtypes, non-contiguous
    or misaligned tensors and more than 2048 columns;
  * `python -m bwamem_tpu_torch.tools.int16_probe --device cpu` prints six
    PASS lines and its verdict and exits 0."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops.kernels import int16_probe as k4
from bwamem_tpu_torch.tools.int16_probe import SHAPE, numpy_case
from tests.test_torch_index import SUBPROCESS_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.fixture(scope="module")
def pallas_outputs():
    """{case: output} of the Pallas probe's six kernels, in interpret
    mode, on the probe's own input, in the probe's case order."""
    import contextlib
    import io

    import jax
    from jax.experimental import pallas as pl

    from tools import mosaic_probe

    recorded = []

    def pallas_call(kernel, **kw):
        call = pl.pallas_call(kernel, interpret=True, **kw)

        def run(x):
            out = call(x)
            recorded.append(np.asarray(out))
            return out
        return run

    fake = types.SimpleNamespace(pallas_call=pallas_call,
                                 BlockSpec=pl.BlockSpec)
    orig = mosaic_probe.pl
    mosaic_probe.pl = fake
    try:
        with jax.default_device(jax.devices("cpu")[0]), \
                contextlib.redirect_stdout(io.StringIO()) as text:
            mosaic_probe.main()
    finally:
        mosaic_probe.pl = orig
    lines = text.getvalue().splitlines()
    assert sum(ln.startswith("PASS") for ln in lines) == 6, lines
    assert len(recorded) == 6
    return dict(zip(k4.NAMES, recorded))


def _probe_input():
    return (np.arange(np.prod(SHAPE), dtype=np.int16) % 100).reshape(SHAPE)


@pytest.mark.parametrize("name", k4.NAMES)
def test_plain_matches_pallas_probe(pallas_outputs, name):
    want = pallas_outputs[name]
    assert want.dtype == np.int16 and want.shape == SHAPE
    got = k4.run_case(name, torch.from_numpy(_probe_input()))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 34), (1, 2), (5, 2048), (64, 130)])
@pytest.mark.parametrize("name", k4.NAMES)
def test_plain_matches_numpy(name, shape):
    rng = np.random.default_rng(shape[0] * 4096 + shape[1])
    x = rng.integers(-32768, 32768, shape, dtype=np.int16)
    x[0, 0], x[-1, -1] = -32768, 32767
    got = k4.run_case(name, torch.from_numpy(x))
    assert got.dtype == torch.int16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), numpy_case(name, x))


def test_wrapper_checks_inputs():
    x = torch.zeros((4, 34), dtype=torch.int16)
    for bad in (torch.zeros((4, 33), dtype=torch.int16),
                torch.zeros((4, 34), dtype=torch.int32),
                x[:, :32].t().contiguous().t(),
                torch.zeros((2, 2050), dtype=torch.int16),
                torch.zeros(34, dtype=torch.int16),
                torch.zeros(4 * 34 + 1, dtype=torch.int16)[1:].view(4, 34)):
        with pytest.raises(ValueError):
            k4.run_case("compare", bad)
    with pytest.raises(ValueError):
        k4.run_case("max", x)


def test_tool_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch.tools.int16_probe",
         "--device", "cpu"], env=SUBPROCESS_ENV, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert sum(ln.startswith("PASS ") for ln in lines) == 6
    assert not any(ln.startswith("FAIL") for ln in lines)
    assert lines[-1].startswith("VERDICT:")
