"""The plain reference: its vectorised DP against a cell-by-cell one, the
tags a CIGAR gives, bwa's TLEN rule, and the control's saturation."""
import numpy as np

from pbtest_helpers import PB  # noqa: F401
from pbcore import reference as R
from pbcore.world import Genome

SC = {"match": 1, "mismatch": 4, "gap_open": 6, "gap_ext": 1, "clip": 5,
      "ambiguous": 1, "min_score": 30}


def slow_best(q, t, sc):
    """Cell by cell: the best over alignments of q (a local piece of it)
    to t of raw score less the clip penalty for each query end left out."""
    L, W = len(q), len(t)
    mat = R.matrix(sc)
    go, ge, clip = sc["gap_open"], sc["gap_ext"], sc["clip"]
    NEG = -10**9
    H = [[NEG] * W for _ in range(L)]
    M = [[NEG] * W for _ in range(L)]
    E = [[NEG] * W for _ in range(L)]
    F = [[NEG] * W for _ in range(L)]
    best = NEG
    for i in range(L):
        for j in range(W):
            s = int(mat[q[i], t[j]])
            start = 0 if i == 0 else -clip
            diag = H[i - 1][j - 1] if i and j else NEG
            M[i][j] = s + max(diag, start)
            F[i][j] = max(H[i - 1][j] - go - ge, F[i - 1][j] - ge) if i \
                else NEG
            G = max(M[i][j], F[i][j])
            E[i][j] = max(max(M[i][j - 1], F[i][j - 1]) - go - ge,
                          E[i][j - 1] - ge) if j else NEG
            H[i][j] = max(G, E[i][j])
            best = max(best, M[i][j] - (clip if i < L - 1 else 0))
    return best


def test_dp_matches_cell_by_cell():
    rng = np.random.default_rng(0)
    for trial in range(30):
        L = int(rng.integers(5, 14))
        W = int(rng.integers(L, L + 10))
        t = rng.integers(0, 4, W).astype(np.uint8)
        q = t[rng.integers(0, W - L + 1):][:L].copy()
        q[rng.random(L) < 0.25] = rng.integers(0, 4)
        if trial % 3 == 0:  # an indel
            q = np.delete(q, rng.integers(1, L - 1))
            q = np.append(q, rng.integers(0, 4)).astype(np.uint8)
        if trial % 5 == 0:
            t[-2:] = R.WALL
        for sc in (SC, {**SC, "clip": 0}):
            got = R.best_penalised(q[None], t[None], sc)[0]
            assert got == slow_best(q, t, sc), (trial, sc["clip"])


def test_control_saturates():
    t = np.zeros((1, 220), np.uint8)
    q = np.zeros((1, 150), np.uint8)
    assert R.best_penalised(q, t, SC)[0] == 150
    assert R.best_penalised(q, t, SC, cell_bits=8)[0] == 127


def _rec(line):
    return R.parse(line.encode())


def test_tags_of_cigar():
    ref = R._LUT[np.frombuffer(b"ACGTACGTAAGGCCTT", np.uint8)]
    # read: ACGT, a mismatch (T for A), CGT, deletion of A, AGGC, an
    # insertion of T, CTT; one soft-clipped base in front
    rec = _rec("r\t0\tc\t1\t60\t1S8M1D4M1I3M\t*\t0\t0\t"
               "GACGTTCGTAGGCTCTT\t" + "I" * 17 + "\tNM:i:3\tMD:Z:4A3^A7\t"
               "AS:i:-1")
    a, nm, md = R.tags_of(rec, ref, SC)
    assert (nm, md) == (3, "4A3^A7")
    assert a == 14 - 4 - 7 - 7  # 14 matches, a mismatch, two gaps of 1
    assert R._soft_ends(rec.cigar) == 1 and R._clips(rec.cigar) == (1, 0)


def test_mate_fields():
    a = _rec("p\t99\tc\t100\t60\t150M\t=\t300\t350\tA\tI")
    b = _rec("p\t147\tc\t300\t60\t150M\t=\t100\t-350\tA\tI")
    assert R.mate_fields_ok(a, b) and R.mate_fields_ok(b, a)
    bad = _rec("p\t99\tc\t100\t60\t150M\t=\t300\t349\tA\tI")
    assert not R.mate_fields_ok(bad, b)
    # an unmapped mate placed at its mapped mate's position
    u = _rec("p\t133\tc\t100\t0\t*\t=\t100\t0\tA\tI")
    m = _rec("p\t73\tc\t100\t60\t150M\t=\t100\t0\tA\tI")
    assert R.mate_fields_ok(u, m) and R.mate_fields_ok(m, u)


def test_judge_counts_a_wrong_record():
    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    genome = Genome(["c"], np.array([0]), np.array([5000]), g)
    src = 1000
    codes = g[src:src + 150].copy()
    seq = bytes(np.frombuffer(b"ACGTN", np.uint8)[codes])
    good = (f"r\t0\tc\t{src + 1}\t60\t150M\t*\t0\t0\t{seq.decode()}\t"
            f"{'I' * 150}\tNM:i:0\tMD:Z:150\tAS:i:150").encode()
    s = R.Sample(codes[None], np.array([0]), np.array([src]),
                 np.array([0], np.int8), np.zeros(1, np.int64), [[good]],
                 "I")
    out = R.judge(genome, s, SC)
    assert out["records_wrong"] == out["tags_wrong"] == 0
    assert out["below_truth"] == out["below_locus_best"] == 0
    moved = good.replace(f"\t{src + 1}\t".encode(), f"\t{src + 3}\t".encode())
    s.lines = [[moved]]
    out = R.judge(genome, s, SC)
    assert out["tags_wrong"] == 1
    s.lines = [[good]]
    ctl = R.judge(genome, s, SC, replace_as=R.control_as(genome, s, SC, 8))
    assert ctl["tags_wrong"] == 1
