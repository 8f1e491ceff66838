"""Genomes past 2^31 positions through the port, the twin of
tests/test_wide_genome.py. No such index can be built here, so a small
index is forced wide (dataclasses.replace(fm, wide=True)), which turns
every row and position to int64:

  * the FM primitives (sa_lookup_batch, backward_ext_ks_batch) and the
    seeds' rbeg are int64 and equal the narrow index's values, with the
    pair table and without it;
  * the sampled-SA values rebuilt from their low words and ssa_vals_hi
    equal the oracle's (bwamem_tpu.oracle.fmd.FMOracle) when the high
    bytes are not 0, and the index file keeps ssa_vals_hi;
  * the window gathers of the extension descriptors, of mate rescue and
    of the fused step take int64 starts, and the fused step's rb and re
    stay int64 with the narrow values (its JAX twin's dtypes);
  * the aligner's SE and PE SAM on the wide index equal the narrow
    index's."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.index.device import DeviceFMIndex
from bwamem_tpu_torch.ops import fm as fmops
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import repeat_index

pytestmark = pytest.mark.usefixtures("native_lib")


@pytest.fixture(scope="module")
def idx():
    from bwamem_tpu_torch.index.build import build_index_from_codes
    from bwamem_tpu_torch.index.format import Annotation

    g = np.random.default_rng(3).integers(0, 4, 3000, dtype=np.uint8)
    return build_index_from_codes(
        g, Annotation(names=["c"], lengths=[3000], offsets=[0]), sa_intv=8)


def _wide(fm):
    return dataclasses.replace(fm, wide=True)


@pytest.mark.parametrize("occ2", [True, False])
def test_position_dtypes(idx, occ2):
    narrow = DeviceFMIndex.from_host(idx, "cpu", occ2=occ2)
    fm = _wide(narrow)
    assert fmops.idx_dt(fm) == torch.int64
    assert fm.L2.dtype == torch.int64 and fm.primary.dtype == torch.int64
    rows = torch.arange(0, 100, 7, dtype=torch.int64)
    vals = fmops.sa_lookup_batch(fm, rows)
    assert vals.dtype == torch.int64
    assert torch.equal(vals, fmops.sa_lookup_batch(
        narrow, rows.to(torch.int32)).to(torch.int64))
    c = torch.zeros(len(rows), dtype=torch.int32)
    k, s = fmops.backward_ext_ks_batch(fm, rows, torch.ones_like(rows), c)
    assert k.dtype == torch.int64 and s.dtype == torch.int64
    k2, s2 = fmops.backward_ext_ks_batch(
        narrow, rows.to(torch.int32), torch.ones_like(rows, dtype=torch.int32),
        c)
    assert torch.equal(k, k2.to(torch.int64))
    assert torch.equal(s, s2.to(torch.int64))


@pytest.mark.parametrize("occ2", [True, False])
@pytest.mark.parametrize("mode", ["smem", "mem"])
def test_seed_positions_are_wide(idx, occ2, mode):
    from bwamem_tpu_torch.ops.seeding import SeedConfig, smem_seed_batch

    narrow = DeviceFMIndex.from_host(idx, "cpu", occ2=occ2)
    reads = torch.from_numpy(np.stack([
        idx.get_base(np.arange(100 + 37 * i, 164 + 37 * i)).astype(np.int32)
        for i in range(6)]))
    reads[1] = 3 - reads[1].flip(0)
    lens = torch.full((6,), 64, dtype=torch.int32)
    cfg = SeedConfig(mode=mode, reseed=mode == "smem")
    a = smem_seed_batch(_wide(narrow), reads, lens, cfg)
    b = smem_seed_batch(narrow, reads, lens, cfg)
    assert a["rbeg"].dtype == torch.int64
    assert len(a["rbeg"]) >= 6
    for k in ("read_id", "qbeg", "qend", "rbeg", "n_occ"):
        assert torch.equal(a[k].to(torch.int64), b[k].to(torch.int64)), k


def test_ssa_hi_word_reconstruction(idx):
    from bwamem_tpu.oracle.fmd import FMOracle

    idx2 = copy.copy(idx)
    rng = np.random.default_rng(8)
    idx2.ssa_vals_hi = rng.integers(1, 3, len(idx.ssa_vals), dtype=np.uint8)
    fm = _wide(DeviceFMIndex.from_host(idx2, "cpu"))
    orc = FMOracle(idx2)
    rows = rng.integers(0, idx.seq_len + 1, 64).astype(np.int64)
    got = fmops.sa_lookup_batch(fm, torch.from_numpy(rows)).numpy()
    want = [orc.sa_lookup(int(r)) for r in rows]
    np.testing.assert_array_equal(got, want)
    assert (got >= 1 << 32).any()


def test_index_roundtrip_keeps_hi(tmp_path, idx):
    from bwamem_tpu_torch.index.format import FMIndex

    idx2 = copy.copy(idx)
    idx2.ssa_vals_hi = np.arange(len(idx.ssa_vals)).astype(np.uint8)
    p = str(tmp_path / "wide.bmt.npz")
    idx2.save(p)
    np.testing.assert_array_equal(FMIndex.load(p).ssa_vals_hi,
                                  idx2.ssa_vals_hi)


def test_window_gathers_take_int64_starts(idx):
    from bwamem_tpu_torch.ops.extend import desc_windows
    from bwamem_tpu_torch.ops.refgather import gather_window_fast

    narrow = DeviceFMIndex.from_host(idx, "cpu")
    fm = _wide(narrow)
    lp = int(idx.l_pac)
    starts = torch.tensor([-40, 0, 17, lp - 30, lp, 2 * lp - 50,
                           2 * lp - 10], dtype=torch.int64)
    w = gather_window_fast(fm, starts, 64)
    assert torch.equal(w, gather_window_fast(narrow, starts.to(torch.int32),
                                             64))
    assert (w[0, :40] == 4).all() and (w[-1, 10:] == 4).all()
    reads = torch.from_numpy(np.stack([idx.get_base(np.arange(
        200, 300)).astype(np.int8)] * 3))
    n = len(starts)
    args = (torch.tensor([0, 1, 2] * 3)[:n].to(torch.int32),
            torch.full((n,), 50, dtype=torch.int32),
            torch.full((n,), 40, dtype=torch.int32), starts,
            torch.full((n,), 48, dtype=torch.int32),
            torch.tensor([1, -1] * 4)[:n].to(torch.int8))
    q1, t1 = desc_windows(fm, reads, *args, 64, 64)
    q2, t2 = desc_windows(narrow, reads, *args, 64, 64)
    assert torch.equal(q1, q2) and torch.equal(t1, t2)


def test_fused_step_keeps_int64(idx):
    from bwamem_tpu_torch.models.mem import device_align_step

    narrow = DeviceFMIndex.from_host(idx, "cpu")
    rng = np.random.default_rng(2)
    L = 100
    reads = np.stack([idx.get_base(np.arange(p, p + L)) for p in
                      (0, 1500, 2900, 700)]).astype(np.int32)
    reads[1] = (3 - reads[1])[::-1]
    reads[3, rng.integers(0, L, 3)] = 4
    rt, lt = torch.from_numpy(reads), torch.full((4,), L, dtype=torch.int32)
    a = device_align_step(_wide(narrow), rt, lt)
    b = device_align_step(narrow, rt, lt)
    assert a["rb"].dtype == a["re"].dtype == torch.int64
    assert b["rb"].dtype == torch.int32
    for k in a:
        assert torch.equal(a[k].to(torch.int64), b[k].to(torch.int64)), k
    assert a["has_seed"].all()


@pytest.fixture(scope="module")
def repeats():
    return repeat_index(size=40_000, seed=13)


def test_aligner_sam_wide_equals_narrow(repeats, tmp_path):
    import chip_smoke
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions

    g, idx = repeats
    rng = np.random.default_rng(6)
    names, seqs = [], []
    for i in range(40):
        p = int(rng.integers(0, len(g) - 150))
        r = g[p:p + 150].copy()
        e = rng.random(150) < 0.01
        r[e] = (r[e] + 1) % 4
        if i % 2:
            r = (3 - r)[::-1].copy()
        names.append(f"s{i}")
        seqs.append(r)
    chip_smoke.make_pairs(str(tmp_path), g, 16, 4, victim_every=4)
    from bwamem_tpu_torch.io.fastx import read_fastx

    pe = [r for pair in zip(read_fastx(str(tmp_path / "r1.fq")),
                            read_fastx(str(tmp_path / "r2.fq")))
          for r in pair]
    out = {}
    for tag in ("narrow", "wide"):
        fm = DeviceFMIndex.from_host(idx, "cpu", occ2=False)
        if tag == "wide":
            fm = _wide(fm)
        al = MemAligner(MemOptions(), idx, fm=fm, device="cpu")
        out[tag] = (al.align_batch(names, seqs),
                    al.align_pairs_batch([r.name for r in pe],
                                         [r.seq for r in pe]))
    assert len(out["wide"][0]) >= 40 and len(out["wide"][1]) >= 32
    assert out["wide"] == out["narrow"]
