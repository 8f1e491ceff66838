"""Drift guard for the host layer the port copies instead of importing:
each copied module equals its original in bwamem_tpu once `bwamem_tpu` is
rewritten to `bwamem_tpu_torch`. The one allowed content edit is the
native loader's build directory (the port builds libbwamem_native.so into
its own `_build/` directory, from the same <repo>/native sources).
utils/timing.py and pipeline/runtime.py are the port's own (its trace and
the chunk ids it carries); tests/test_torch_trace.py holds the port's
runtime to the JAX runtime's SAM."""
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = [
    "index/format.py", "index/build.py", "index/suffix_array.py",
    "index/ingest.py", "io/fastx.py", "native/loader.py", "native/samfmt_opts.py",
    "pipeline/options.py", "pipeline/chain.py", "pipeline/regions.py",
    "pipeline/samgen.py", "pipeline/regarrays.py",
    "pipeline/hostpool.py", "oracle/ksw.py", "ops/globalalign.py",
    "utils/dna.py", "utils/shapes.py", "utils/simgenome.py",
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


# pipeline/pairing.py: every top-level statement equals the original's
# except the rescue launch, which the port runs on its own device arm
PAIRING_REWRITTEN = ("_use_desc_rescue", "_run_sw_jobs")


def _top_level(src):
    """(name, source segment) of each top-level statement."""
    import ast

    return [(getattr(node, "name", None), ast.get_source_segment(src, node))
            for node in ast.parse(src).body]


def test_pairing_matches_original_but_the_rescue_launch():
    want = _top_level(_read("bwamem_tpu", "pipeline/pairing.py"))
    got = _top_level(_read("bwamem_tpu_torch", "pipeline/pairing.py"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, seg_got), (_, seg_want) in zip(got, want):
        if name in PAIRING_REWRITTEN:
            assert "jax" not in seg_got, name
        else:
            assert seg_got == seg_want, name


def test_multihost_matches_original_but_the_join():
    """parallel/multihost.py is a copy but for init_distributed, which
    joins a Gloo process group in place of jax.distributed."""
    want = _top_level(_read("bwamem_tpu", "parallel/multihost.py"))
    got = _top_level(_read("bwamem_tpu_torch", "parallel/multihost.py"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, seg_got), (_, seg_want) in zip(got, want):
        if name == "init_distributed":
            assert "jax" not in seg_got
            assert 'backend="gloo"' in seg_got
        else:
            seg_want = re.sub(r"\bbwamem_tpu\b", "bwamem_tpu_torch",
                              seg_want)
            assert seg_got == seg_want, name


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


# the per-seed-object path's host helpers in pipeline/aligner.py, and the
# job construction and survivorship of pipeline/seedflt.py, are copies;
# only the launches (run_extension_jobs, the filters' _run_* and the
# helpers they call) are the port's own
ALIGNER_COPIED = ("ExtJob", "chain2aln_jobs", "merge_extension_results",
                  "_dump_chains", "_dump_regs")
SEEDFLT_COPIED = ("_SWJob", "_SHDJob")
SEEDFLT_METHODS = ("add_read", "_add_sw", "_windows", "_add_shd", "run",
                   "_apply_drops")


def _methods(src, cls):
    import ast

    node = next(n for n in ast.parse(src).body
                if getattr(n, "name", None) == cls)
    return {n.name: ast.get_source_segment(src, n) for n in node.body
            if hasattr(n, "name")}


@pytest.mark.parametrize("mod,names", [
    ("pipeline/aligner.py", ALIGNER_COPIED),
    ("pipeline/seedflt.py", SEEDFLT_COPIED)])
def test_object_path_helpers_match_original(mod, names):
    want = dict(_top_level(_read("bwamem_tpu", mod)))
    got = dict(_top_level(_read("bwamem_tpu_torch", mod)))
    for name in names:
        assert got[name] == want[name], name


def test_seed_filter_job_construction_matches_original():
    want = _methods(_read("bwamem_tpu", "pipeline/seedflt.py"),
                    "SeedFilterBatch")
    got = _methods(_read("bwamem_tpu_torch", "pipeline/seedflt.py"),
                   "SeedFilterBatch")
    for name in SEEDFLT_METHODS:
        assert got[name] == want[name], name
