"""The port's device index (bwamem_tpu_torch.index.device) against the JAX
package's: every field equal, dtype and value, on the shared tiny index
and on a repeat-rich genome, with and without the occ2 pair table."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM

_STATIC = ("sa_intv", "wide", "has_occ2")


@pytest.fixture(scope="session")
def native_lib():
    """Build the port's native C++ core once, under a file lock: parallel
    test workers would otherwise compile and link the same library path
    at the same time, and one could load another's half-written file."""
    import fcntl

    from bwamem_tpu_torch.native import loader

    loader._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(loader._BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lib = loader.try_load()
    assert lib is not None, "native core failed to build"
    # one intra-op thread per test process: the suite runs in parallel
    # workers, and the small CPU ops of the port slow down sharply when
    # every worker's thread pool spins on the same cores
    torch.set_num_threads(1)
    return lib


# environment for the port's CLI subprocesses (see native_lib)
SUBPROCESS_ENV = dict(os.environ, OMP_NUM_THREADS="1",
                      PYTHONPATH=os.path.dirname(os.path.dirname(
                          os.path.abspath(__file__))))

pytestmark = pytest.mark.usefixtures("native_lib")


def jax_fm_arrays(jfm) -> dict:
    """The JAX index's state as numpy arrays (+ its static fields)."""
    return {f.name: (getattr(jfm, f.name) if f.name in _STATIC
                     else np.asarray(getattr(jfm, f.name)))
            for f in dataclasses.fields(jfm)}


def repeat_index(size=40_000, seed=5, sa_intv=4):
    """(codes, FMIndex) of a one-contig repeat-rich simulated genome."""
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation
    from bwamem_tpu_torch.io.fastx import _CODE_LUT
    from bwamem_tpu_torch.utils.simgenome import make_repeat_genome

    rng = np.random.default_rng(seed)
    contigs, _ = make_repeat_genome(rng, size, n_contigs=1)
    g = _CODE_LUT[np.frombuffer(contigs[0][1].encode(), np.uint8)].copy()
    amb = g > 3
    g[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
    ann = Annotation(names=[contigs[0][0]], lengths=[len(g)], offsets=[0])
    return g, build_index_from_codes(g, ann, sa_intv=sa_intv)


@pytest.fixture(scope="module")
def rep_index():
    return repeat_index()


def _assert_same(tfm, jfm):
    for f in dataclasses.fields(jfm):
        jv, tv = getattr(jfm, f.name), getattr(tfm, f.name)
        if f.name in _STATIC:
            assert tv == jv, f.name
            continue
        jn = np.asarray(jv)
        tn = tv.cpu().numpy()
        assert tn.dtype == jn.dtype, (f.name, tn.dtype, jn.dtype)
        assert tn.shape == jn.shape, f.name
        np.testing.assert_array_equal(tn, jn, err_msg=f.name)


@pytest.mark.parametrize("occ2", [True, False])
@pytest.mark.parametrize("which", ["tiny", "repeat"])
def test_from_host_matches_jax(which, occ2, tiny_index, rep_index):
    idx = (tiny_index if which == "tiny" else rep_index)[1]
    jfm = JaxFM.from_host(idx, occ2=occ2)
    tfm = TorchFM.from_host(idx, "cpu", occ2=occ2)
    assert tfm.has_occ2 == occ2
    _assert_same(tfm, jfm)


def test_from_numpy_round_trips(rep_index):
    jfm = JaxFM.from_host(rep_index[1])
    arrays = jax_fm_arrays(jfm)
    tfm = TorchFM.from_numpy(arrays, "cpu")
    _assert_same(tfm, jfm)
    back = tfm.to_numpy()
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v),
                                      err_msg=k)
    assert TorchFM.from_numpy(back, "cpu").occ_blocks.device.type == "cpu"


def test_default_occ2_switch(tiny_index):
    tfm = TorchFM.from_host(tiny_index[1], torch.device("cpu"))
    assert tfm.has_occ2 and not tfm.wide
    assert tfm.occ2_blocks.shape[1] == 32
