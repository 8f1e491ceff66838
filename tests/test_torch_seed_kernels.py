"""The seeding kernels (ops/kernels/seed_kernels.py, S1-S4) on the CPU.

  * The lane-group row queries of csrc/fm_index.cuh (S1's walks), each
    lane's part summed over its group as the kernel's shuffles sum it,
    equal the one-thread queries on every BWT row of the index (every row
    offset, every code), on an occ2 row and an occ row, with int32 and
    int64 positions.
  * The early-kill argument that lets S2 (seed_backward) kill lanes only
    within a warp: on the repeat-rich genome of test_torch_seeding.py
    (60 kb, seed 21) with chip_smoke.make_seed_reads' reads,
    ops/seeding._backward_pass with every lane in its own group (no kill
    at all), with the default grouping, and the kernel's host build (its
    warps' lockstep and kill) keep the same seeds after
    _containment_filter, in round 1 and round 2, with occ2, without it
    and forced wide; and the kill does fire there.
  * Mode "mem" (-g) seeds through S1 and S4, mode "fwdmem" (-u 3) and
    bowtie_seed_batch (-u 2/4) through S4, each on the kernels' host
    builds equal to the plain route.
  * The wrappers route CPU tensors to the plain versions and launch
    nothing: every LAUNCHES counter stays 0.
  * smem_seed_batch, with the re-seed rounds on and off and with max_occ
    subsampling, still equals the JAX package's on reads with N bases and
    of length 0, 1 and 19.
  * The kernels' own sources (csrc/seed_forward.cu, seed_backward.cu,
    sa_lookup.cu on csrc/fm_index.cuh), compiled as plain C++ with g++
    (tests/seed_kernels_host.cpp stands in for the launches), run behind
    the wrappers' CUDA route on CPU tensors: every kernel equals its plain
    version by its rule, in every index form, with and without round 3,
    at 32, 160 and 1024 columns, and smem_seed_batch on them equals the
    plain route with one launch of each kernel a call; S3's lane-group
    walk on edge lanes (first-trip deaths, starts on an N, at or past the
    read's end, odd L, no lane); S4's count/scan and lookup kernels
    against _expand_occurrences on SMEMs of size 0, 1, 2 and past
    max_occ, some not kept, in one tile and over many, and on every BWT
    row.
"""
import ctypes
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.index.device import DeviceFMIndex as JaxFM
from bwamem_tpu.ops import seeding as jseed
from bwamem_tpu_torch.index.device import DeviceFMIndex as TorchFM
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import seeding as sd
from bwamem_tpu_torch.ops.kernels import build as kbuild
from bwamem_tpu_torch.ops.kernels import seed_kernels as sk
from tests.test_torch_index import native_lib  # noqa: F401
from tests.test_torch_index import jax_fm_arrays, repeat_index

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.usefixtures("native_lib")

MSL = 19
FIELDS = ("read_id", "qbeg", "qend", "rbeg", "n_occ")
FORMS = ("occ2", "no_occ2", "wide")


@pytest.fixture(scope="module")
def world():
    g, idx = repeat_index(size=60_000, seed=21)
    return (g, idx) + chip_smoke.make_seed_reads(
        g, np.random.default_rng(22), 48, 160)


def _fm(idx, form):
    fm = TorchFM.from_host(idx, "cpu", occ2=form != "no_occ2")
    return dataclasses.replace(fm, wide=True) if form == "wide" else fm


def _round1(fm, reads, lens):
    """Round-1 lanes of smem_seed_batch: (args, kwargs) of the backward
    walk, the lanes' ends and the filter's group."""
    (start, k, s, emit), _ = sk.seed_forward(fm, reads, lens, MSL)
    B, NP = emit.shape
    end = torch.arange(NP, dtype=torch.int32).expand(B, NP)
    idx, (start, end, k, s) = sd._compact(emit, start, end, k, s)
    rid = (idx // NP).to(torch.int32)
    return (rid, start, k, s), {}, end, rid


def _round2(fm, reads, lens):
    """Round-2 lanes of smem_seed_batch (with re-seeding), as _round1."""
    args, _, end, rid = _round1(fm, reads, lens)
    qbeg, k, s = sd._backward_pass(fm, reads, *args)
    keep = sd._containment_filter(qbeg, end, rid, MSL)
    qualify = keep & (end - qbeg >= int(MSL * 1.5 + 0.499)) & (s <= 10)
    _, (lrid, lx, lfloor) = sd._compact(qualify, rid, (qbeg + end) >> 1,
                                        (s + 1).to(k.dtype))
    kb, sb, eb, filled = sd._reseed_forward(fm, reads, lens, lrid, lx,
                                            lfloor, MSL)
    E = kb.shape[1]
    lane = torch.arange(lrid.shape[0], dtype=torch.int32)

    def flat(a):
        return a[:, None].expand(a.shape[0], E)

    _, (rid2, lane2, x2, floor2, k2, s2, end2) = sd._compact(
        filled, flat(lrid), flat(lane), flat(lx), flat(lfloor), kb, sb, eb)
    return (rid2, x2, k2, s2), dict(floor=floor2, group=lane2), end2, lane2


@pytest.mark.parametrize("rnd", [1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_early_kill_keeps_the_same_seeds(world, on_host, form, rnd):
    """_backward_pass with the kill off (each lane its own group) and on
    (the default grouping), and S2's host build (csrc/seed_backward.cu:
    the lanes of a warp in lockstep, killed against the next lane of the
    warp only), keep the same lanes after _containment_filter, with the
    same (qb, k, s): a killed lane
    reached the state of a later lane of its group, so its qb is at or
    above that lane's final qb. The kill fires in both versions."""
    _, idx, reads, lens = world
    fm = _fm(idx, form)
    reads_t, lens_t = torch.from_numpy(reads), torch.from_numpy(lens)
    args, kw, end, grp = (_round1 if rnd == 1 else _round2)(fm, reads_t,
                                                            lens_t)
    P = args[0].shape[0]
    assert P > 100
    killed = sd._backward_pass(fm, reads_t, *args, **kw)
    walked = sd._backward_pass(fm, reads_t, *args,
                               **dict(kw, group=torch.arange(P)))
    host = sk.seed_backward(fm, reads_t, *args, **kw)
    assert (host[0] != walked[0]).any()  # the kernel's kill fired
    keep_w = sd._containment_filter(walked[0], end, grp, MSL)
    assert keep_w.any()
    for out in (killed, host):
        keep = sd._containment_filter(out[0], end, grp, MSL)
        assert torch.equal(keep, keep_w)
        for a, b in zip(out, walked):
            assert torch.equal(a[keep], b[keep_w])
    assert (killed[0] != walked[0]).any()  # the plain version's kill fired


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("kind", ["occ2", "occ"])
def test_lane_group_queries_match_one_thread(world, host_kernels, kind,
                                             wide):
    """S1's row queries in csrc/fm_index.cuh's lane-group form (occ2: its
    lanes' occ2_lane_part summed, then occ2_finish; occ: a lane pair's
    occ_lane_part summed), on the host as the kernel's shuffles sum them,
    equal the one-thread occ2_query and rank1 sums on every BWT$ row of
    the index, so at every row offset (0..127 of an occ2 row, 0..63 of an
    occ row; the sentinel's blocks included) for every code c1 and
    previous code c2."""
    _, idx, _, _ = world
    fm = _fm(idx, "occ2")
    ptrs = sk._fm_ptrs(fm, fm.occ_blocks.device)
    assert host_kernels.lib.host_check_rows(
        ctypes.byref(ptrs), int(fm.seq_len) + 1, int(wide),
        int(kind == "occ2")) == 0


@pytest.mark.parametrize("mode", ["mem", "fwdmem", "bowtie"])
def test_variant_modes_seed_on_the_kernels(world, on_host, mode):
    """Mode "mem" (-g) takes S1 for its forward walk and S4 for its SA
    lookup, mode "fwdmem" (-u 3) and bowtie_seed_batch (-u 2/4) S4; on
    the kernels' host builds each gives the plain route's seeds, and each
    call equals its plain version by its rule."""
    _, idx, reads, lens = world
    fm = _fm(idx, "occ2")
    reads_t, lens_t = torch.from_numpy(reads), torch.from_numpy(lens)
    if mode == "bowtie":
        def seed():
            return sd.bowtie_seed_batch(fm, reads_t, lens_t, 19, 10, True)
    else:
        def seed():
            return sd.smem_seed_batch(fm, reads_t, lens_t,
                                      sd.SeedConfig(mode=mode))
    with chip_smoke.plain_seeding():
        want = seed()
    with chip_smoke.capture_seed_calls() as calls:
        got = seed()
    assert [c[0] for c in calls] == (["seed_forward", "sa_lookup"]
                                     if mode == "mem" else ["sa_lookup"])
    assert {k: v for k, v in sk.LAUNCHES.items() if v} == {
        c[0]: 1 for c in calls}
    assert len(want["rbeg"]) > 0
    for k in FIELDS:
        assert torch.equal(got[k].long(), want[k].long()), k
    for call in calls:
        assert chip_smoke.check_seed_call(mode, call, timed=False)[
            "max_abs_err"] == 0


def test_wrappers_route_cpu_to_plain(world):
    """On CPU tensors each wrapper is its plain version, and nothing
    launches: smem_seed_batch with the re-seed rounds leaves every
    LAUNCHES counter at 0."""
    _, idx, reads, lens = world
    fm = _fm(idx, "occ2")
    reads_t, lens_t = torch.from_numpy(reads), torch.from_numpy(lens)
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    got, r3 = sk.seed_forward(fm, reads_t, lens_t, MSL, (MSL, 20))
    want = sd._forward_pass2(fm, reads_t.int(), lens_t.int(), MSL,
                             strategy=(MSL, 20))
    for a, b in zip(got + r3, want[:4] + want[4]):
        assert torch.equal(a, b)
    args, kw, _, _ = _round2(fm, reads_t, lens_t)
    for a, b in zip(sk.seed_backward(fm, reads_t, *args, **kw),
                    sd._backward_pass(fm, reads_t, *args, **kw)):
        assert torch.equal(a, b)
    smems = _smems(fm, 0)
    got = sk.sa_lookup(fm, *smems, 3)
    want = sd._expand_occurrences(fm, *smems, 3)
    for k in FIELDS:
        assert torch.equal(got[k], want[k]), k
    out = sd.smem_seed_batch(fm, reads_t, lens_t, sd.SeedConfig(reseed=True))
    assert len(out["rbeg"]) > 0
    assert all(v == 0 for v in sk.LAUNCHES.values()), sk.LAUNCHES


def _smems(fm, seed, n=64):
    """n SMEM-shaped rows (rid, qbeg, qend, k, s, keep) on fm's BWT: sizes
    0, 1 and 2 up to past max_occ 500, about one in seven not kept."""
    rng = np.random.default_rng(seed)
    s = rng.choice([0, 1, 1, 1, 2, 3, 4, 7, 40, 600, 1501], n)
    k = rng.integers(0, int(fm.seq_len) + 2 - s)
    qbeg = rng.integers(0, 100, n)
    dt = fmops.idx_dt(fm)
    return (torch.from_numpy(np.sort(rng.integers(0, 20, n))).int(),
            torch.from_numpy(qbeg).int(),
            torch.from_numpy(qbeg + rng.integers(19, 60, n)).int(),
            torch.from_numpy(k).to(dt), torch.from_numpy(s).to(dt),
            torch.from_numpy(rng.random(n) < 0.85))


@pytest.fixture(scope="module")
def edge_world():
    g, idx = repeat_index(size=60_000, seed=23)
    return (idx,) + chip_smoke.make_seed_reads(
        g, np.random.default_rng(24), 56, 160)


@pytest.mark.parametrize("max_occ", [500, 3])
@pytest.mark.parametrize("reseed", [False, True])
def test_seeds_match_jax(edge_world, reseed, max_occ):
    idx, reads, lens = edge_world
    jfm = JaxFM.from_host(idx)
    tfm = TorchFM.from_numpy(jax_fm_arrays(jfm), "cpu")
    cfg = jseed.SeedConfig(reseed=reseed, max_occ=max_occ, cand_pool=512,
                           seed_pool=512, r2_pool=64, r2_cand=512,
                           r3_pool=256, merge_pool=512)
    out = jseed.smem_seed_batch(jfm, jnp.asarray(reads), jnp.asarray(lens),
                                cfg)
    assert not bool(out["overflow"])
    v = np.asarray(out["valid"])
    got = sd.smem_seed_batch(tfm, torch.from_numpy(reads),
                             torch.from_numpy(lens),
                             sd.SeedConfig(reseed=reseed, max_occ=max_occ))
    assert len(got["rbeg"]) == int(v.sum()) > 0
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(out[k])[v].astype(np.int64),
                                      err_msg=k)


# ---- the kernels' sources compiled for the host ----

class _HostLib:
    """The kernels' C entry points, each forwarded to its host build
    (tests/seed_kernels_host.cpp) without the stream argument; S4's with
    sa_tile SMEMs a tile in its place (0: the card's tiling)."""

    sa_tile = 0

    def __init__(self, lib):
        self.lib = lib

    def error_string(self, rc):
        return f"host error {rc}".encode()

    def bm_seed_forward(self, *a):
        return self.lib.host_seed_forward(*a[:-1])

    def bm_seed_reseed_forward(self, *a):
        return self.lib.host_seed_reseed_forward(*a[:-1])

    def bm_seed_backward(self, *a):
        return self.lib.host_seed_backward(*a[:-1])

    def bm_sa_tiles(self, n):
        return self.lib.host_sa_tiles(n, self.sa_tile)

    def bm_sa_count(self, *a):
        return self.lib.host_sa_count(*a[:-1], self.sa_tile)

    def bm_sa_lookup(self, *a):
        return self.lib.host_sa_lookup(*a[:-1], self.sa_tile)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    out = tmp_path_factory.mktemp("seed_host") / "libseed_host.so"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "seed_kernels_host.cpp")
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{kbuild.CSRC}", "-o", str(out), src], check=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fmp = ctypes.POINTER(sk._FMPtrs)
    lib.host_seed_forward.argtypes = [fmp, vp, vp] + [ci] * 8 + [cll] + [
        vp] * 8
    lib.host_seed_reseed_forward.argtypes = (
        [fmp, vp, vp, ci, ci, vp, vp, vp] + [ci] * 4 + [vp] * 4)
    lib.host_seed_backward.argtypes = [fmp, vp, ci, ci] + [vp] * 6 + [
        ci, ci] + [vp] * 3
    lib.host_sa_tiles.argtypes = [cll, cll]
    lib.host_sa_tiles.restype = cll
    lib.host_sa_count.argtypes = [vp, vp, cll, ci, cll, vp, vp, cll]
    lib.host_sa_lookup.argtypes = ([fmp] + [vp] * 5
                                   + [cll, ci, ci, cll, vp, vp, cll]
                                   + [vp] * 5 + [cll])
    lib.host_check_rows.argtypes = [fmp, cll, ci, ci]
    lib.host_check_rows.restype = cll
    return _HostLib(lib)


@pytest.fixture
def on_host(host_kernels, monkeypatch):
    """The wrappers take their CUDA route on CPU tensors, into the host
    build of the kernels."""
    monkeypatch.setattr(sk, "_on_card", lambda x, what: True)
    monkeypatch.setattr(sk, "_stream", lambda dev: 0)
    monkeypatch.setattr(sk, "_load", lambda name: host_kernels)
    for k in sk.LAUNCHES:
        monkeypatch.setitem(sk.LAUNCHES, k, 0)


@pytest.mark.parametrize("L", [32, 160, 1024])
@pytest.mark.parametrize("form", FORMS)
def test_host_kernels_match_plain(world, on_host, form, L):
    """Each kernel (its host build) against its plain version, by the
    rule chip_smoke.py holds the card to, on every call smem_seed_batch
    makes with the re-seed rounds and max_occ subsampling; and the final
    seeds equal the plain route's, with one launch of each kernel."""
    g, idx, _, _ = world
    reads, lens = chip_smoke.make_seed_reads(
        g, np.random.default_rng(L), 12 if L > 500 else 40, L)
    fm = _fm(idx, form)
    reads_t, lens_t = torch.from_numpy(reads), torch.from_numpy(lens)
    cfg = sd.SeedConfig(reseed=True, max_occ=3)
    calls = chip_smoke.seed_route_check(f"{form} {L}", fm, reads_t, lens_t,
                                        cfg)
    assert sk.LAUNCHES == dict(seed_forward=1, seed_backward=2,
                               seed_reseed_forward=1, sa_lookup=1)
    assert [c[0] for c in calls] == ["seed_forward", "seed_backward",
                                     "seed_reseed_forward", "seed_backward",
                                     "sa_lookup"]
    for call in calls:
        rec = chip_smoke.check_seed_call(f"{form} {L}", call, timed=False)
        assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0
    # round 1 alone, and S1 without round 3
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    sd.smem_seed_batch(fm, reads_t, lens_t, sd.SeedConfig())
    assert sk.LAUNCHES == dict(seed_forward=1, seed_backward=1,
                               seed_reseed_forward=0, sa_lookup=1)
    call = ("seed_forward", (fm, reads_t, lens_t, MSL), {})
    assert chip_smoke.check_seed_call("no r3", call, False)[
        "max_abs_err"] == 0


@pytest.mark.parametrize("form", FORMS)
def test_host_reseed_edge_lanes(world, on_host, form):
    """S3's host build (its lane-group walk) equals _reseed_forward on the
    fill mask and every filled entry at an odd L (161), on lanes that die
    on their first trip (a floor above every interval), that start on an
    N, at the read's last base, at its end or past it, or in reads of
    length 0-2; and launches nothing for no lane."""
    g, idx, _, _ = world
    fm = _fm(idx, form)
    reads, lens = chip_smoke.make_seed_reads(g, np.random.default_rng(5),
                                             28, 161)
    rng = np.random.default_rng(6)
    R = 240
    lrid = rng.integers(0, len(lens), R)
    ln = lens[lrid]
    lx = (rng.random(R) * np.maximum(ln, 1)).astype(np.int64)
    lx[0::8] = np.maximum(ln[0::8] - 1, 0)
    lx[1::8] = ln[1::8]
    lx[2::8] = ln[2::8] + 3
    n_at = np.argwhere(reads == 4)
    n_at = n_at[n_at[:, 1] < lens[n_at[:, 0]]]  # N bases inside a read
    pick = n_at[rng.integers(0, len(n_at), len(lrid[3::8]))]
    lrid[3::8], lx[3::8] = pick[:, 0], pick[:, 1]
    ln = lens[lrid]
    floor = rng.choice([1, 1, 2, 3, 5, 1 << 20], R)
    dt = fmops.idx_dt(fm)
    args = (fm, torch.from_numpy(reads).int(), torch.from_numpy(lens),
            torch.from_numpy(lrid).int(), torch.from_numpy(lx).int(),
            torch.from_numpy(floor).to(dt), MSL)
    got = sk.seed_reseed_forward(*args)
    want = sd._reseed_forward(*args)
    assert sk.LAUNCHES["seed_reseed_forward"] == 1
    assert chip_smoke._emitted_err(got, want, 3) == 0
    fill = want[3]
    assert fill.any() and not fill[:, 0].any()
    died = (floor == 1 << 20) & (ln > lx + 2)
    assert fill[torch.from_numpy(died)].sum(1).max() <= 1  # first trip
    none = sk.seed_reseed_forward(*args[:3], *(a[:0] for a in args[3:6]),
                                  MSL)
    assert none[3].shape == (0, 163)
    assert sk.LAUNCHES["seed_reseed_forward"] == 1


def test_host_sa_lookup_every_row(world, on_host):
    """S4's host build equals sa_lookup_batch on every BWT row (an SMEM of
    size 1 at each), narrow and wide."""
    _, idx, _, _ = world
    for form in ("occ2", "wide"):
        fm = _fm(idx, form)
        rows = torch.arange(int(fm.seq_len) + 1)
        n = len(rows)
        one = torch.ones(n, dtype=torch.int32)
        got = sk.sa_lookup(fm, one, one, one + 1, rows, one,
                           torch.ones(n, dtype=torch.bool), 500)
        assert torch.equal(got["rbeg"], fmops.sa_lookup_batch(fm, rows))
        assert torch.equal(got["n_occ"].long(), one.long())


@pytest.mark.parametrize("tile", [None, 8], ids=["one_tile", "tiles_of_8"])
@pytest.mark.parametrize("max_occ", [500, 3])
@pytest.mark.parametrize("form", ["occ2", "wide"])
def test_host_sa_lookup_matches_plain(world, host_kernels, on_host,
                                      monkeypatch, form, max_occ, tile):
    """S4's host build (its count and scan kernel, then its lookup kernel)
    equals _expand_occurrences in every field and in order, on SMEMs of
    size 0, 1, 2 and past max_occ, some not kept; in one tile and, with
    tiles of 8 SMEMs, over many (the owner search across tiles, tiles of
    no occurrence)."""
    _, idx, _, _ = world
    fm = _fm(idx, form)
    if tile:
        monkeypatch.setattr(host_kernels, "sa_tile", tile)
    assert host_kernels.bm_sa_tiles(300) == (38 if tile else 1)
    smems = _smems(fm, 7, n=300)
    want = sd._expand_occurrences(fm, *smems, max_occ)
    got = sk.sa_lookup(fm, *smems, max_occ)
    assert sk.LAUNCHES["sa_lookup"] == 1
    assert len(want["rbeg"]) > 300
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    empty = sk.sa_lookup(fm, *(x[:0] for x in smems), max_occ)
    assert all(len(v) == 0 for v in empty.values())
    none = sk.sa_lookup(fm, *smems[:5], torch.zeros_like(smems[5]), max_occ)
    assert all(len(v) == 0 for v in none.values())


@pytest.mark.parametrize("form", ["occ2", "wide"])
def test_sa_lookup_bound_reads_owning_smems(world, monkeypatch, form):
    """chip_smoke's bound of S4 charges every SMEM its keep byte, but the
    other fields (rid, qbeg, qend, k, s) only to the SMEMs that own an
    occurrence (kept, s above 0): an SMEM that is not kept or empty needs
    no more than its keep byte."""
    _, idx, _, _ = world
    fm = _fm(idx, form)
    smems = _smems(fm, 11, n=300)
    args = (fm,) + smems + (3,)
    want = sd._expand_occurrences(*args)
    seen = {}
    monkeypatch.setattr(chip_smoke, "_bound",
                        lambda nbytes, ops: seen.update(nbytes=nbytes))
    chip_smoke._seed_bound("sa_lookup", args, {}, want)
    s, keep = smems[4].numpy().astype(np.int64), smems[5].numpy()
    owners = int(((s > 0) & keep).sum())
    assert 0 < owners < 300 - 20
    n = len(want["rbeg"])
    dsz = 8 if fm.wide else 4
    steps = int((want["rbeg"].long() % fm.sa_intv).sum())
    vals = fm.ssa_vals.numel() * 4 + (fm.ssa_vals_hi.numel() if fm.wide
                                      else 0)
    tables = (min(n * (4 + fm.wide), vals)
              + min((n + 2 * steps) * 32,
                    fm.occ_blocks.numel() * fm.occ_blocks.element_size()))
    assert seen["nbytes"] == 300 + (owners + n) * (12 + 2 * dsz) + tables


@pytest.mark.parametrize("name", ["seed_forward", "sa_lookup"])
def test_seed_bound_reads_each_table_byte_once(world, name):
    """chip_smoke's bound of S1 and S4 on walks that touch the small index
    many times over: its bytes hold each table byte at most once (the
    repeats come from L2), and every query goes to the operations."""
    g, idx, reads, lens = world
    fm = _fm(idx, "occ2")
    hbm, ops_rate = chip_smoke.HBM_BYTES_PER_S, chip_smoke.INT_OPS_PER_S
    if name == "seed_forward":
        reads_t = torch.from_numpy(np.repeat(reads[2:3], 600, axis=0))
        lens_t = torch.from_numpy(np.repeat(lens[2:3], 600))
        args = (fm, reads_t, lens_t, MSL)
        want = sk.seed_forward(*args)
        planes = want[0]
        trips = int(((lens_t.long() + 2) // 2).sum())
        n_words = 2 * trips * 32
        io = (reads_t.numel() * 4 + lens_t.numel() * 4 + planes[3].numel()
              + int(planes[3].sum()) * 12)
        tables = fm.occ2_blocks.numel() * 4
        touched = 2 * trips * 128
    else:
        rows = torch.arange(int(fm.seq_len) + 1).repeat(20)
        n = len(rows)
        one = torch.ones(n, dtype=torch.int32)
        args = (fm, one, one, one + 1, rows.int(), one,
                torch.ones(n, dtype=torch.bool), 500)
        want = sk.sa_lookup(*args)
        steps = int((want["rbeg"].long() % fm.sa_intv).sum())
        n_words = (n + 2 * steps) * 8
        io = n * (3 * 4 + 2 * 4 + 1) + n * (3 * 4 + 2 * 4)
        tables = (fm.ssa_vals.numel() * 4 + fm.occ_blocks.numel() * 4)
        touched = (len(rows) + 2 * steps) * 32
    assert touched > 4 * tables  # the walks read the tables many times
    b = chip_smoke._seed_bound(name, args, {}, want)
    t_ops = n_words * chip_smoke.OPS_PER_WORD / ops_rate * 1e3
    assert b["bound_ms"] <= max((io + tables) / hbm * 1e3, t_ops) * 1.0001
    assert b["bound_ms"] >= t_ops
