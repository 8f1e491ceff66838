"""The seeding kernels (ops/kernels/seed_kernels.py, S1-S4) on the CPU.

  * The early-kill argument that lets S2 (seed_backward) kill lanes only
    within a warp: on the repeat-rich genome of test_torch_seeding.py
    (60 kb, seed 21) with chip_smoke.make_seed_reads' reads,
    ops/seeding._backward_pass with every lane in its own group (no kill
    at all) keeps the same seeds after _containment_filter as the default
    grouping, in round 1 and round 2, with occ2, without it and forced
    wide; and the kill does fire there.
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
    plain route with one launch of each kernel a call.
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
def test_early_kill_keeps_the_same_seeds(world, form, rnd):
    """_backward_pass with the kill off (each lane its own group) and on
    (the default grouping) keep the same lanes after _containment_filter,
    with the same (qb, k, s): a killed lane reached the state of a later
    lane of its group, so its qb is at or above that lane's final qb."""
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
    keep_k = sd._containment_filter(killed[0], end, grp, MSL)
    keep_w = sd._containment_filter(walked[0], end, grp, MSL)
    assert torch.equal(keep_k, keep_w) and keep_k.any()
    for a, b in zip(killed, walked):
        assert torch.equal(a[keep_k], b[keep_w])
    assert (killed[0] != walked[0]).any()  # the kill fired


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
    rows = torch.arange(0, int(fm.seq_len) + 1, 97)
    assert torch.equal(sk.sa_lookup(fm, rows),
                       fmops.sa_lookup_batch(fm, rows))
    out = sd.smem_seed_batch(fm, reads_t, lens_t, sd.SeedConfig(reseed=True))
    assert len(out["rbeg"]) > 0
    assert all(v == 0 for v in sk.LAUNCHES.values()), sk.LAUNCHES


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
    (tests/seed_kernels_host.cpp) without the stream argument."""

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

    def bm_sa_lookup(self, *a):
        return self.lib.host_sa_lookup(*a[:-1])


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
    lib.host_sa_lookup.argtypes = [fmp, vp, cll, ci, ci, vp]
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


def test_host_sa_lookup_every_row(world, on_host):
    """S4's host build equals sa_lookup_batch on every BWT row, narrow and
    wide."""
    _, idx, _, _ = world
    for form in ("occ2", "wide"):
        fm = _fm(idx, form)
        rows = torch.arange(int(fm.seq_len) + 1)
        assert torch.equal(sk.sa_lookup(fm, rows),
                           fmops.sa_lookup_batch(fm, rows))


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
        args = (fm, rows)
        want = sk.sa_lookup(*args)
        steps = int((want.long() % fm.sa_intv).sum())
        n_words = (len(rows) + 2 * steps) * 8
        io = len(rows) * 8
        tables = (fm.ssa_vals.numel() * 4 + fm.occ_blocks.numel() * 4)
        touched = (len(rows) + 2 * steps) * 32
    assert touched > 4 * tables  # the walks read the tables many times
    b = chip_smoke._seed_bound(name, args, {}, want)
    t_ops = n_words * chip_smoke.OPS_PER_WORD / ops_rate * 1e3
    assert b["bound_ms"] <= max((io + tables) / hbm * 1e3, t_ops) * 1.0001
    assert b["bound_ms"] >= t_ops
