"""Drift guard for the host layer the port copies instead of importing:
each copied module equals its original in bwamem_tpu once `bwamem_tpu` is
rewritten to `bwamem_tpu_torch`. The one allowed content edit is the
native loader's build directory (the port builds libbwamem_native.so into
its own `_build/` directory, from the same <repo>/native sources)."""
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = [
    "index/format.py", "index/build.py", "index/suffix_array.py",
    "io/fastx.py", "native/loader.py", "native/samfmt_opts.py",
    "pipeline/options.py", "pipeline/chain.py", "pipeline/regions.py",
    "pipeline/samgen.py", "pipeline/regarrays.py", "pipeline/runtime.py",
    "pipeline/hostpool.py", "oracle/ksw.py", "ops/globalalign.py",
    "utils/dna.py", "utils/shapes.py", "utils/timing.py",
    "utils/simgenome.py",
]

# (original line, port line) pairs, per module
EDITS = {
    "native/loader.py": [(
        '_BUILD_DIR = Path(__file__).resolve().parent / "_build"',
        '_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"')],
}


def _read(pkg, mod):
    with open(os.path.join(REPO, pkg, mod)) as f:
        return f.read()


@pytest.mark.parametrize("mod", COPIED)
def test_copy_matches_original(mod):
    want = re.sub(r"\bbwamem_tpu\b", "bwamem_tpu_torch",
                  _read("bwamem_tpu", mod))
    for old, new in EDITS.get(mod, []):
        assert want.count(old) == 1, (mod, old)
        want = want.replace(old, new)
    assert _read("bwamem_tpu_torch", mod) == want


def test_options_take_the_ports_score_matrix():
    """options.py's `from ..ops.extend import make_score_matrix` resolves to
    the port's ops/extend.py, with the same matrix."""
    import numpy as np

    from bwamem_tpu.pipeline.options import MemOptions as JaxOpts
    from bwamem_tpu_torch.ops import extend
    from bwamem_tpu_torch.pipeline import options

    assert options.make_score_matrix is extend.make_score_matrix
    o = options.MemOptions(a=2, b=3)
    np.testing.assert_array_equal(o.mat, JaxOpts(a=2, b=3).mat)
