"""chip_smoke.py rehearsed on the CPU at a small size (its phases with the
kernels' plain versions and --device cpu: SE, PE, long reads, --vanilla,
-F, -x pacbio, the seeding variants, fastmap, the 16-bit probe, the fused
step, the mesh, two hosts and the split finalize), plus
its refusal to
run — and to print a result — without a CUDA device or outside the
repository."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tests.test_torch_index import SUBPROCESS_ENV  # noqa: E402
from tests.test_torch_index import native_lib  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("native_lib")


def _check_rec(rec):
    assert {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms")} == dict(
        max_abs_err=0, ms=None, plain_ms=None)
    assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                       "operations")


def test_kernel_phase_on_cpu():
    _check_rec(chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=48, TMAX=96), timed=False))


def test_sw_kernel_phase_on_cpu():
    _check_rec(chip_smoke.sw_kernel_phase(
        "cpu", dict(N=200, QMAX=48, TMAX=96), timed=False))


def test_pacbio_kernel_phase_on_cpu():
    _check_rec(chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=64, TMAX=256, tail=256), timed=False,
        variants=[(False, 0)], scoring=chip_smoke.PACBIO))


@pytest.mark.parametrize("scoring", [None, chip_smoke.PACBIO])
def test_seed_filter_sw_kernel_phase_on_cpu(scoring):
    _check_rec(chip_smoke.sw_kernel_phase(
        "cpu", dict(N=200, QMAX=200, TMAX=200), timed=False,
        variants=[(0, 0)], product=(0, 0), jobs=chip_smoke.make_filter_jobs,
        scoring=scoring, label="seed filter"))


def test_banded_kernel_phase_on_cpu():
    _check_rec(chip_smoke.kernel_phase(
        "cpu", dict(N=200, QMAX=300, TMAX=360), timed=False, kernel="K3",
        variants=[(40, 0), (40, 30)]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world"))
    chip_smoke.make_world(d, genome_len=200_000, n_reads=300, n_pairs=128)
    subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", "index", "-r",
                    "4", os.path.join(d, "ref.fa"), "-p",
                    os.path.join(d, "idx")], check=True, timeout=300,
                   capture_output=True, env=SUBPROCESS_ENV)
    return d


def test_world_and_align_phases_on_cpu(world):
    launches, rate, calls = chip_smoke.align_phase(world, device="cpu",
                                                   chunk_reads=128)
    assert launches == 0 and rate > 0  # CPU tensors never launch K1
    # every K1 call was captured (300 reads, 128 a chunk); the second
    # one's inputs replay exact against the plain version
    assert len(calls) == 3
    rec = chip_smoke.captured_ext("K1", "phase4", calls[1], timed=False)
    assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0


def test_pe_align_phase_on_cpu(world, monkeypatch):
    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    k1, k2, rate, sw_calls = chip_smoke.pe_align_phase(
        world, device="cpu", chunk_pairs=64)
    assert k1 == k2 == 0 and rate > 0  # CPU tensors launch no kernel
    # mate rescue went through K2's wrapper, and its inputs replay exact
    assert sw_calls
    rec = chip_smoke.captured_k2("phase5 rescue", sw_calls[-1], timed=False)
    assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0


@pytest.fixture(scope="module")
def long_runs(world):
    """Phases 6-8 at a tiny size on the world (the CLI appends to
    ./time.log, so they run inside it)."""
    from bwamem_tpu_torch.io.fastx import read_fastx

    contigs = [(r.name, "".join("ACGTN"[c] for c in r.seq))
               for r in read_fastx(os.path.join(world, "ref.fa"))]
    cwd = os.getcwd()
    os.chdir(world)
    try:
        return chip_smoke.long_read_phases(world, contigs, device="cpu",
                                           sizes=(4, 16, 32, 4),
                                           heads=(2, 8, 16, 2))
    finally:
        os.chdir(cwd)


def test_long_read_phases_on_cpu(long_runs):
    """Phases 6-8 at a tiny size, with their SAM checks against a second
    CPU run; CPU tensors launch no kernel."""
    assert set(long_runs) == {"long", "vanilla", "shd", "pacbio"}
    for r in long_runs.values():
        assert r["K1"] == r["K2"] == r["K3"] == 0 and r["reads_per_s"] > 0


@pytest.mark.parametrize("tag,kernel", [
    ("long", "K1"), ("long", "K2"), ("pacbio", "K1"), ("pacbio", "K2"),
    ("vanilla", "K3")])
def test_captured_launches_on_cpu(long_runs, tag, kernel):
    """The phases' captured calls (capture_calls): the seed filter's K2
    calls of phase 6 and -x pacbio, phase 7's K3 calls and the K1 calls
    replay exact against the plain versions, with a bound. On the CPU
    ops/extend.py hands --vanilla's extensions to K1's plain version
    (the card takes K3), so K3 replays those captured K1 calls."""
    calls = long_runs[tag]["k1_calls" if kernel == "K3"
                           else f"{kernel.lower()}_calls"]
    assert calls
    call = chip_smoke._largest(calls)
    rec = (chip_smoke.captured_k2(tag, call, timed=False) if kernel == "K2"
           else chip_smoke.captured_ext(kernel, tag, call, timed=False))
    assert rec["max_abs_err"] == 0 and rec["bound_ms"] > 0
    assert rec["ms"] is None and rec["bound_by"] in ("bytes", "operations")


def test_probe_kernel_phase_on_cpu():
    rec = chip_smoke.probe_kernel_phase("cpu", [(8, 128), (64, 130)],
                                        timed=False)
    _check_rec(rec)
    assert rec["library_ms"] is None and rec["bound_by"] == "bytes"


def test_variant_and_fastmap_phases_on_cpu(world, monkeypatch):
    """Phases 9 and 10 at a tiny size, with their checks against a second
    CPU run; CPU tensors launch no kernel."""
    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    runs = chip_smoke.variant_phases(world, device="cpu", sizes=(48, 16),
                                     heads=(12, 6))
    assert set(runs) == {"u2", "u3", "g", "u4"}
    for r in runs.values():
        assert r["K1"] == r["K2"] == r["K3"] == 0 and r["reads_per_s"] > 0
    assert [c[0] for c in runs["g"]["seed_calls"]] == ["seed_forward",
                                                      "sa_lookup"]
    rate, calls = chip_smoke.fastmap_phase(world, device="cpu", n_head=10)
    assert rate > 0
    assert [c[0] for c in calls] == ["seed_forward", "seed_backward",
                                     "sa_lookup"]


def test_probe_phase_on_cpu(capsys):
    assert chip_smoke.probe_phase("cpu") == 0  # the plain versions
    out = capsys.readouterr().out
    assert out.count("  PASS ") == 6 and "  VERDICT: " in out


def test_new_path_phases_on_cpu(world, long_runs, monkeypatch, capsys):
    """Phases 12-14 at a tiny size on the CPU: the fused step at 150 bp
    and 1 kb (its head and batch checks against a second CPU run), a
    mesh of two CPU shards against one device, the route without the
    native core, the index forced wide, and two hosts as two processes
    that join over Gloo; CPU tensors launch no kernel."""
    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    # the hosts' processes inherit one intra-op thread (see native_lib)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = chip_smoke.new_path_phases(
        world, 0.0, device="cpu", sizes=(48, 2), heads=(16, 1),
        mesh_sizes=((32, 12), (12, 6), 12), host_sizes=(16, 8), n_chips=2)
    assert set(out) == {"step_150", "step_1kb", "mesh", "hosts"}
    for k in ("step_150", "step_1kb", "mesh"):
        assert out[k]["K1"] == out[k]["K3"] == 0
        assert out[k]["reads_per_s"] > 0
    assert set(out["hosts"]) == {"se", "pe"}
    text = capsys.readouterr().out
    assert "mesh of 2 (cpu, cpu)" in text
    assert text.count("two hosts se --device cpu") == 1
    assert "phase 14 took" in text


def test_seeding_phase_on_cpu(world, long_runs, monkeypatch, capsys):
    """Phase 15 at a tiny size on the CPU: the seeding calls captured from
    phase 4 (two chunks of 128 reads), phase 6, the fused step, a -g
    chunk and the second of two fastmap calls replay against the plain
    versions with a bound, smem_seed_batch equals the plain route (also
    on the index without occ2 and forced wide), and the profile runs both
    routes; CPU tensors launch no kernel."""
    from bwamem_tpu_torch.index.device import DeviceFMIndex
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.ops import seeding as sd

    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    seed4 = []
    chip_smoke.align_phase(world, device="cpu", chunk_reads=128,
                           seed_calls=seed4)
    assert [c[0] for c in chip_smoke.warm_chunk(seed4)] == [
        "seed_forward", "seed_backward", "seed_reseed_forward",
        "seed_backward", "sa_lookup"]
    idx = FMIndex.load(os.path.join(world, "idx.bmt"))
    names, seqs = chip_smoke._batch(os.path.join(world, "reads.fq"), 24)
    truth = {n: (int(n.split("_")[1]), int(n.split("_")[2])) for n in names}
    step = chip_smoke.fused_step_phase(
        {"cpu": DeviceFMIndex.from_host(idx, "cpu")}, "150 bp", names, seqs,
        truth, "K1", "K3", (8, 4), "cpu")
    fm = DeviceFMIndex.from_host(idx, "cpu")
    reads, lens = chip_smoke._reads_tensors(seqs[:12], "cpu")
    with chip_smoke.capture_seed_calls() as g_calls:
        sd.smem_seed_batch(fm, reads, lens, sd.SeedConfig(mode="mem"))
    with chip_smoke.capture_seed_calls() as fastmap_calls:
        for _ in range(2):
            sd.smem_seed_batch(fm, reads, lens, sd.SeedConfig())
    out = chip_smoke.seeding_phase(world, seed4,
                                   long_runs["long"]["seed_calls"],
                                   step["seed_calls"], g_calls,
                                   fastmap_calls, device="cpu",
                                   timed=False, chunk_reads=128)
    prof = out.pop("profile")
    assert set(prof) == {"kernels", "plain"}
    assert {label for label, _, _ in out} == {
        "phase 4 warm chunk", "phase 6 1 kb chunk", "fused step 150 bp",
        "phase 4 warm chunk, index without occ2",
        "phase 4 warm chunk, index forced wide", "phase 9 -g chunk",
        "phase 10 fastmap call"}
    assert {name for label, name, _ in out
            if label == "phase 9 -g chunk"} == {"seed_forward", "sa_lookup"}
    for (label, name, _), rec in out.items():
        assert rec["max_abs_err"] == 0 and rec["ms"] is None, (label, name)
        assert rec["bound_ms"] > 0
    assert ("phase 4 warm chunk", "seed_backward", 1) in out
    assert all(v == 0 for c in chip_smoke.SEED_LAUNCHES.values()
               for v in c.values())
    assert "smem_seed_batch on the kernels == the plain route" in \
        capsys.readouterr().out


def test_finalize_phase_on_cpu(world, long_runs, monkeypatch, capsys):
    """Phase 16 at a tiny size on the CPU, the split finalize routed onto
    K5's plain version (the route engages only on a card), on two of its
    cases: the split SAM equals the native finalize's, the jobs are
    counted, and the captured calls replay against the plain version with
    a bound (at 250 bp with a shared-memory capacity that sends their
    tracebacks to global scratch, as 1 kb reads' go on the card); CPU
    tensors launch no kernel."""
    from bwamem_tpu_torch.io.fastx import read_fastx
    from bwamem_tpu_torch.ops.kernels import cigar_kernel
    from bwamem_tpu_torch.pipeline import finalize

    monkeypatch.chdir(world)  # the CLI appends to ./time.log
    monkeypatch.setattr(finalize, "route", lambda aligner, pool, timings=None:
                        finalize.DeviceFinalize(pool.opt, pool.idx, "cpu",
                                                None, timings))
    monkeypatch.setattr(cigar_kernel, "JOB_SMEM_CAP", 4000)
    contigs = [(r.name, "".join("ACGTN"[c] for c in r.seq))
               for r in read_fastx(os.path.join(world, "ref.fa"))]
    cases = {c[0]: c for c in chip_smoke.FINALIZE_CASES}
    tags = ("pe250", "se150 -a")
    out = chip_smoke.finalize_phase(
        world, contigs, device="cpu", cases=[cases[t] for t in tags],
        sizes=dict(pe250=12, se_a=16, pe_a=4),
        replay={"pe250": 12, "se150 -a": 12}, timed=False)
    assert set(out) == {*tags, *("k5 " + t for t in tags)}
    assert out["se150 -a"]["records"] > 16  # -a adds secondaries
    for tag in tags:
        r, rec = out[tag], out["k5 " + tag]
        assert r["K5"] == 0 and r["records"] > 0, tag
        assert r["cigar_jobs"] > 0 and r["cigar_host_jobs"] == 0, tag
        assert rec["max_abs_err"] == 0 and rec["ms"] is None
        assert rec["bound_ms"] > 0 and rec["plain_jobs"] <= rec["jobs"]
    assert out["k5 pe250"]["scratch_jobs"] > 0
    assert capsys.readouterr().out.count("split SAM == native SAM") == 2


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu_or_repo(tmp_path, alone):
    import torch

    if torch.cuda.is_available() and not alone:
        pytest.skip("a GPU is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in SUBPROCESS_ENV.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
