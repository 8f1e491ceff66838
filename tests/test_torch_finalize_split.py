"""The split finalize (pipeline/finalize.py: plan and render in
csrc/finalize_split.cpp, the CIGAR solve on K5's plain version) against the
port's native finalize, SAM byte for byte, and K5's plain DP
(ops/kernels/cigar_kernel.ksw_global_plain) against bm_ksw_global."""
import copy

import numpy as np
import pytest
import torch

from tests.test_torch_index import native_lib  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_lib")


def _mat(a=1, b=4):
    m = np.full((5, 5), -b, np.int8)
    np.fill_diagonal(m, a)
    m[4, :] = -1
    m[:, 4] = -1
    return m


def _ksw_cases(rng):
    """Random (query, target, w): edits at both ends and inside, ties
    (periodic sequences), w = 0, w < |qlen - tlen|, N bases in the query,
    one-base and empty sides."""
    cases = [(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 3),
             (np.zeros(0, np.uint8), np.array([1, 2], np.uint8), 0),
             (np.array([3, 1, 4], np.uint8), np.zeros(0, np.uint8), 2),
             (np.array([2], np.uint8), np.array([2], np.uint8), 0),
             (np.array([2], np.uint8), np.array([1, 0, 2], np.uint8), 0),
             (np.array([0, 1, 2, 3] * 4, np.uint8),
              np.array([0, 1, 2, 3] * 3 + [0, 1], np.uint8), 1)]
    for n in range(160):
        q = rng.integers(0, 4, int(rng.integers(1, 48))).astype(np.uint8)
        t = list(q)
        for _ in range(int(rng.integers(0, 5))):
            op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(t) + 1))
            if op == 0 and p < len(t):
                t[p] = int(rng.integers(0, 4))
            elif op == 1:
                t.insert(p, int(rng.integers(0, 4)))
            elif p < len(t):
                del t[p]
        if n % 5 == 0:   # a gap at an end
            t = list(rng.integers(0, 4, int(rng.integers(1, 4)))) + t
        if n % 7 == 0:
            t = t + list(rng.integers(0, 4, int(rng.integers(1, 4))))
        if n % 3 == 0:
            q[int(rng.integers(0, len(q)))] = 4
        if n % 11 == 0:   # periodic: many tied paths
            q = np.array([1, 3] * int(rng.integers(2, 9)), np.uint8)
            t = [1, 3] * int(rng.integers(1, 9))
        cases.append((q, np.array(t, np.uint8), int(rng.integers(0, 10))))
    return cases


def test_ksw_global_plain_matches_native(native_lib):
    from bwamem_tpu_torch.native import loader
    from bwamem_tpu_torch.ops.kernels.cigar_kernel import ksw_global_plain

    cases = _ksw_cases(np.random.default_rng(7))
    N = len(cases)
    Q = max(len(c[0]) for c in cases)
    T = max(len(c[1]) for c in cases)
    qa = np.full((N, Q), 4, np.int64)
    ta = np.zeros((N, T), np.int64)
    for i, (q, t, _) in enumerate(cases):
        qa[i, :len(q)] = q
        ta[i, :len(t)] = t
    for mat, gaps in ((_mat(), (6, 1, 6, 1)), (_mat(2, 3), (5, 2, 4, 3))):
        sc, cg = ksw_global_plain(
            torch.from_numpy(qa), torch.from_numpy(ta),
            torch.tensor([len(c[0]) for c in cases]),
            torch.tensor([len(c[1]) for c in cases]),
            torch.tensor([c[2] for c in cases]),
            torch.from_numpy(mat.astype(np.int64)), *gaps)
        for i, (q, t, w) in enumerate(cases):
            want = loader.ksw_global_native(native_lib, q, t, mat, *gaps, w)
            assert (int(sc[i]), cg[i]) == want, (i, q, t, w)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 120 kb repeat genome; 40 SE reads of 150 bp, 20 drawn from its 4
    SINE copies (2% apart) and its 6 kb segmental duplication (1% apart)
    so that XA hits abound, 8 with 1% indels; 24 FR pairs of 150 bp.
    Returns the index and the finalize inputs of one chunk of each,
    collected on the CPU."""
    from bwamem_tpu_torch.cli import main
    from bwamem_tpu_torch.index.format import FMIndex
    from bwamem_tpu_torch.pipeline.aligner import MemAligner
    from bwamem_tpu_torch.pipeline.options import MemOptions
    from bwamem_tpu_torch.utils import simgenome as sg

    d = tmp_path_factory.mktemp("fsplit")
    rng = np.random.default_rng(21)
    contigs, layout = sg.make_repeat_genome(
        rng, 120_000, sg.RepeatSpec(sine_copies=4, sine_div=0.02,
                                    segdup_len=6000, tandem_arrays=3),
        n_contigs=2)
    sg.write_fasta(str(d / "ref.fa"), contigs)
    assert main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    idx = FMIndex.load(str(d / "idx") + ".bmt")
    reads = sg.simulate_reads(rng, contigs, 12, sub=0.01)
    reads += sg.simulate_reads(rng, contigs, 8, sub=0.005, ins=0.01,
                               dele=0.01)
    genome = "".join(s for _, s in contigs)   # the contigs cut it in order
    src = layout["segdup"][0][0]
    starts = [p + 75 for p, _ in layout["sine"]] + list(
        range(src + 100, src + 5800, 360))
    for k, p in enumerate(starts):   # over SINE copies and the segdup
        p = min(p, len(genome) - 150)
        r = sg._apply_errors(rng, genome[p:p + 150], 0.01, 0, 0)
        reads.append(sg.SimRead(f"x{k}", r, "I" * len(r), "", p, 0))
    pairs = sg.simulate_pairs(rng, contigs, 24, sub=0.01)
    code = {c: i for i, c in enumerate("ACGTN")}

    def codes(s):
        return np.array([code.get(c, 4) for c in s], np.uint8)

    opt = MemOptions()
    al = MemAligner(opt, idx, device="cpu")
    se = [codes(r.seq) for r in reads]
    pe = [codes(r.seq) for ab in pairs for r in ab]
    return dict(
        idx=idx, opt=opt,
        se=([r.name for r in reads], se, [r.qual for r in reads],
            al.collect_regs_batch(se)),
        pe=([r.name for ab in pairs for r in ab], pe,
            [r.qual for ab in pairs for r in ab], *al.collect_pairs_batch(pe)))


@pytest.mark.parametrize("variant", ["default", "all", "host_route",
                                     "ops_cap"])
@pytest.mark.parametrize("mode", ["se", "pe"])
def test_split_finalize_matches_native(world, native_lib, monkeypatch, mode,
                                       variant):
    """SAM byte for byte; `all`: -a; `host_route`: a capacity that sends the
    jobs whose traceback passes 3,000 bytes to the host; `ops_cap`: room for
    one CIGAR run, so every CIGAR with an indel is solved by the host."""
    from bwamem_tpu_torch.native import loader
    from bwamem_tpu_torch.ops.kernels import cigar_kernel
    from bwamem_tpu_torch.pipeline import finalize
    from bwamem_tpu_torch.pipeline.options import MEM_F_ALL

    opt = copy.copy(world["opt"])
    if variant == "all":
        opt.flag |= MEM_F_ALL
    if variant == "host_route":
        monkeypatch.setattr(cigar_kernel, "TILE_BYTES", 3000)
    if variant == "ops_cap":
        monkeypatch.setattr(cigar_kernel, "OPS_CAP", 1)
    idx = world["idx"]
    fin = finalize.DeviceFinalize(opt, idx, "cpu")
    if mode == "se":
        names, seqs, quals, regs = world["se"]
        want = loader.finalize_se_native(native_lib, opt, idx, names, seqs,
                                         quals, regs, 100)
        got = fin.emit_se(names, seqs, quals, regs, 100)
    else:
        names, seqs, quals, pair_regs, pes = world["pe"]
        want = loader.finalize_pe_native(native_lib, opt, idx, pes, names,
                                         seqs, quals, pair_regs, 50)
        got = fin.emit_pe(names, seqs, quals, pair_regs, pes, 100)
    assert got == want.decode().splitlines()
    st = fin.stats
    assert st["cigar_jobs"] + st["cigar_host_jobs"] >= len(got) // 2
    if variant in ("default", "all"):
        assert st["cigar_host_jobs"] == 0
    else:
        assert st["cigar_host_jobs"] > 0 and st["cigar_jobs"] > 0, st
    if mode == "se" and variant == "default":
        assert sum("XA:Z:" in ln for ln in got) >= 5


def test_route_stays_off_the_cpu_and_the_pool():
    """--device cpu and a forked pool (-t > 1) keep the native finalize."""
    from types import SimpleNamespace

    from bwamem_tpu_torch.pipeline import finalize

    cpu = SimpleNamespace(device=torch.device("cpu"))
    assert finalize.route(cpu, SimpleNamespace(n=1)) is None
    card = SimpleNamespace(device=torch.device("cuda", 0))
    assert finalize.route(card, SimpleNamespace(n=2)) is None
