"""Data parallel over a mesh (bwamem_tpu_torch/parallel/sharded.py), the
twin of tests/test_multichip.py: the port's mesh of 8 CPU shards against
the port on one device and the JAX package on its 8-device CPU mesh
(tests/conftest.py):

  * sharded_align_step == device_align_step == the JAX
    sharded_align_step, and the total seed count (the JAX psum);
  * the full aligner, MemAligner(mesh=...): SE and PE SAM (with mate
    rescue) equal to one device's and to the JAX aligner's on its mesh;
  * -g on a mesh of 2, where each shard's walk compacts on its own pool
    width (its read count x cand_pool): seeds equal to the JAX aligner's
    on a 2-device mesh, which differ from one device's;
  * the mesh helpers: shard padding, the read-id rebase, the job split
    and make_mesh's refusal of more cards than are visible."""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.parallel import sharded as tsh
from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def setup():
    """tests/test_multichip.py's fixture (16 exact 80 bp reads of an 8 kb
    random genome), plus 4 reads with substitutions on the reverse
    strand, 20 reads in all: not a multiple of the mesh size."""
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation

    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 8000, dtype=np.uint8)
    idx = build_index_from_codes(
        g, Annotation(names=["c"], lengths=[8000], offsets=[0]), sa_intv=8)
    B, L = 16, 80
    reads = np.full((B + 4, L), 4, np.int32)
    lens = np.full(B + 4, L, np.int32)
    for i in range(B + 4):
        pos = int(rng.integers(0, 8000 - L))
        r = g[pos:pos + L].copy()
        if i >= B:
            r[::17] = (r[::17] + 1) % 4
            r = (3 - r)[::-1]
        reads[i] = r
    return idx, reads, lens


def test_sharded_step_matches_single_and_jax(setup):
    import jax
    from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
    from bwamem_tpu.parallel import sharded as jsh
    from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
    from bwamem_tpu_torch.models.mem import device_align_step

    idx, reads, lens = setup
    assert len(jax.devices()) >= 8
    jfm = JaxFM.from_host(idx)
    jmesh = jsh.make_mesh(8)
    r_sh, l_sh, B = jsh.shard_reads(jmesh, reads, lens)
    jout, jtotal = jsh.sharded_align_step(jmesh)(
        jsh.replicate_index(jmesh, jfm), r_sh, l_sh)

    mesh = tsh.make_mesh(8, "cpu")
    fm = TorchFM.from_host(idx, "cpu")
    rs, ls, tB = tsh.shard_reads(mesh, reads, lens)
    assert tB == B == 20 and [r.shape[0] for r in rs] == [3] * 8
    out, total = tsh.sharded_align_step(mesh)(
        tsh.replicate_index(mesh, fm), rs, ls)
    one = device_align_step(fm, torch.from_numpy(reads),
                            torch.from_numpy(lens))
    for k in ("score", "qb", "qe", "rb", "re", "has_seed"):
        assert out[k].shape[0] == 24
        np.testing.assert_array_equal(out[k][:B].numpy(),
                                      one[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(out[k].numpy(),
                                      np.asarray(jout[k]), err_msg=k)
    assert total == int(one["n_seeds"]) == int(jtotal)
    assert (out["score"][:16] == 80).all()
    shards, total2 = tsh.sharded_align_step(mesh, gather_out=False)(
        tsh.replicate_index(mesh, fm), rs, ls)
    assert len(shards) == 8 and total2 == total
    np.testing.assert_array_equal(
        torch.cat([s["rb"] for s in shards]).numpy(), out["rb"].numpy())


def _aligners(idx, mesh_n, **opts):
    """(port one device, port mesh of mesh_n CPU shards, JAX mesh of
    mesh_n devices) aligners with these options."""
    from bwamem_tpu.parallel.sharded import make_mesh as jmake
    from bwamem_tpu.pipeline.aligner import MemAligner as JAl
    from bwamem_tpu.pipeline.options import MemOptions as JOpt
    from bwamem_tpu_torch.pipeline.aligner import MemAligner as TAl
    from bwamem_tpu_torch.pipeline.options import MemOptions as TOpt

    return (TAl(TOpt(**opts), idx, device="cpu"),
            TAl(TOpt(**opts), idx, mesh=tsh.make_mesh(mesh_n, "cpu")),
            JAl(JOpt(**opts), idx, mesh=jmake(mesh_n)))


def test_full_pipeline_se_mesh_matches_single_and_jax():
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation

    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, 20000, dtype=np.uint8)
    idx = build_index_from_codes(
        g, Annotation(names=["c"], lengths=[20000], offsets=[0]), sa_intv=8)
    names, seqs = [], []
    for i in range(30):
        p = int(rng.integers(0, 20000 - 120))
        r = g[p:p + 120].copy()
        r[int(rng.integers(0, 120))] ^= 1
        if i % 2:
            r = (3 - r)[::-1]
        names.append(f"m{i}")
        seqs.append(r)
    one, mesh, jax_mesh = _aligners(idx, 8)
    single = one.align_batch(names, seqs)
    multi = mesh.align_batch(names, seqs)
    assert mesh.device == torch.device("cpu") and len(mesh.fms) == 8
    assert len(single) == 30
    assert multi == single
    assert multi == jax_mesh.align_batch(names, seqs)


def test_full_pipeline_pe_mesh_matches_single_and_jax():
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation

    rng = np.random.default_rng(23)
    g = rng.integers(0, 4, 40000, dtype=np.uint8)
    idx = build_index_from_codes(
        g, Annotation(names=["c"], lengths=[40000], offsets=[0]), sa_intv=8)
    names, seqs = [], []
    for i in range(40):
        isize = 240 + int(rng.integers(0, 80))
        p = int(rng.integers(0, 40000 - isize - 1))
        frag = g[p:p + isize]
        a = frag[:100].copy()
        b = (3 - frag[-100:])[::-1].copy()
        for r in (a, b):
            r[int(rng.integers(0, 100))] ^= 1
        if i % 7 == 0:  # a shattered mate: only rescue places it
            b = rng.integers(0, 4, 100, dtype=b.dtype)
        names += [f"p{i}", f"p{i}"]
        seqs += [a, b]
    one, mesh, jax_mesh = _aligners(idx, 8)
    single = one.align_pairs_batch(names, seqs)
    multi = mesh.align_pairs_batch(names, seqs)
    assert multi == single
    assert multi == jax_mesh.align_pairs_batch(names, seqs)


@pytest.mark.parametrize("case", ["compaction", "spill"])
def test_mem_mode_mesh_matches_jax_mesh(tmp_path, monkeypatch, case):
    """-g over a mesh of 2 on a 60 kb repeat-rich genome. compaction: 256
    reads of 150 bp; each shard's pool is 128 x 32 = 4096 lanes, where the
    JAX walk compacts, one device's 256 x 32. spill: 64 reads of 190 bp
    at 5% substitutions with both sides' caps lowered to 64 candidate and
    256 seed slots a read, so a shard's candidates overflow its capped
    pool and the batch splits (down to parts of 4 reads), each part
    padded to the mesh again. The port's mesh seeds equal the JAX mesh's,
    and in the compaction case differ from one device's. A fresh pool
    store starts the JAX aligner at the default pools."""
    import bwamem_tpu.pipeline.poolstore as jpools
    from bwamem_tpu.pipeline.poolstore import PoolStore
    from bwamem_tpu_torch.ops import seeding as tseeding
    from tests.test_torch_index import repeat_index
    from tests.test_torch_seed_variants import _sample

    g, idx = repeat_index(size=60_000, seed=21)
    if case == "spill":
        for f, v in (("cand_pool", 64), ("seed_pool", 256)):
            monkeypatch.setitem(jpools.POOL_CAPS, f, v)
            monkeypatch.setitem(tseeding.POOL_CAPS, f, v)
        seqs = _sample(g, 64, 190, 0.05, 11)
    else:
        seqs = _sample(g, 256, 150, 0.01, 3)
    one, mesh, jax_mesh = _aligners(idx, 2, re_seed=True)
    jax_mesh.pool_store = PoolStore(str(tmp_path / "pools.json"))
    want = jax_mesh.seed_batch(seqs)
    got = mesh.seed_batch(seqs)
    assert mesh.seed_cfg.cand_pool == jax_mesh.seed_cfg.cand_pool
    assert got == want
    if case == "compaction":
        assert one.seed_batch(seqs) != want


def test_shard_helpers():
    mesh = tsh.make_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.axis == "data"
    reads = torch.arange(7 * 4, dtype=torch.int8).reshape(7, 4)
    lens = torch.full((7,), 4, dtype=torch.int32)
    rs, ls, B = tsh.shard_reads(mesh, reads, lens)
    assert B == 7 and [r.shape[0] for r in rs] == [3, 3, 3]
    assert torch.equal(torch.cat(rs)[:7], reads)
    assert (torch.cat(rs)[7:] == 4).all() and (torch.cat(ls)[7:] == 0).all()
    assert tsh._job_ranges(mesh, 7) == [(0, 3), (3, 6), (6, 7)]
    assert tsh._job_ranges(mesh, 2) == [(0, 1), (1, 2), (2, 2)]
    assert tsh.make_mesh(None, "cpu").size == 1


def test_sharded_extend_matches_one_launch():
    from bwamem_tpu_torch.ops import extend
    from chip_smoke import make_jobs

    rng = np.random.default_rng(4)
    q, t, ql, tl, h0 = (torch.from_numpy(a)
                        for a in make_jobs(rng, 101, 64, 128))
    mat = torch.from_numpy(extend.make_score_matrix(1, 4))
    p = extend.ExtendParams(w=30)
    want = extend.extend_batch_auto(q, t, ql, tl, h0, mat, p)
    got = tsh.sharded_extend_batch(tsh.make_mesh(4, "cpu"), q, t, ql, tl,
                                   h0, mat, p)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_make_mesh_refuses_more_cards_than_visible():
    with pytest.raises(RuntimeError, match="visible"):
        tsh.make_mesh(torch.cuda.device_count() + 1)
