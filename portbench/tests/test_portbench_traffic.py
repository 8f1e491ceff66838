"""The traffic generator: the same reads for the same seed and
configuration, fixed read lengths, exact reads where no error is drawn,
and the victims' count."""
import numpy as np

from pbtest_helpers import PB  # noqa: F401  (puts portbench on the path)
from pbcore import simgenome
from pbcore.traffic import Traffic, parse_name
from pbcore.world import Genome


def _genome(n=200_000, seed=3):
    rng = np.random.default_rng(seed)
    contigs, _ = simgenome.make_repeat_genome(rng, n, n_contigs=2)
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    parts = [lut[np.frombuffer(s.encode(), np.uint8)] for _, s in contigs]
    lens = np.array([len(p) for p in parts])
    return Genome([n for n, _ in contigs],
                  np.concatenate([[0], np.cumsum(lens)[:-1]]), lens,
                  np.concatenate(parts))


PE = {"paired": True, "read_len": 150, "insert_mean": 350, "insert_sd": 50,
      "insert_min": 260, "sub_rate": 0.01, "ins_rate": 0.0003,
      "del_rate": 0.0003, "victim_every": 100, "pool_reads": 4000}
SE = {"paired": False, "read_len": 150, "sub_rate": 0.01,
      "ins_rate": 0.0003, "del_rate": 0.0003, "pool_reads": 3000}


def test_same_seed_same_reads():
    g = _genome()
    for t in (PE, SE):
        a = Traffic(t, g, np.random.default_rng([1, 99]))
        b = Traffic(t, g, np.random.default_rng([1, 99]))
        c = Traffic(t, g, np.random.default_rng([1, 100]))
        assert a.records.tobytes() == b.records.tobytes()
        assert a.records.tobytes() != c.records.tobytes()
        assert a.pool.codes.shape == (t["pool_reads"], 150)


def test_genome_is_seeded():
    a = _genome(seed=5).codes
    b = _genome(seed=5).codes
    assert np.array_equal(a, b) and not np.array_equal(a, _genome(seed=6).codes)


def test_error_free_reads_are_the_genome():
    g = _genome()
    t = dict(PE, sub_rate=0.0, ins_rate=0.0, del_rate=0.0, victim_every=0)
    tr = Traffic(t, g, np.random.default_rng(7))
    p = tr.pool
    for k in range(0, 400, 7):
        src = g.codes[g.starts[p.contig[k]] + p.src_lo[k]:][:166]
        want = src[:150] if p.strand[k] == 0 else np.where(
            src < 4, 3 - src, 4)[::-1][:150]
        assert np.array_equal(p.codes[k], want)
    # mates on opposite strands, read 1 on either, insert >= insert_min
    s1, s2 = p.strand[0::2], p.strand[1::2]
    assert (s1 != s2).all() and 0.4 < s1.mean() < 0.6
    lo1, lo2 = p.src_lo[0::2], p.src_lo[1::2]
    fwd, rev = np.where(s1 == 0, lo1, lo2), np.where(s1 == 0, lo2, lo1)
    assert (rev + 166 - fwd >= 260).all()


def test_victims_and_names():
    g = _genome()
    tr = Traffic(PE, g, np.random.default_rng(8))
    v = tr.pool.victim.reshape(-1, 2)
    # one mate, either, of every 100th pair
    assert v.sum() == PE["pool_reads"] // 200
    assert (v.sum(axis=1)[99::100] == 1).all()
    assert v[:, 0].any() and v[:, 1].any()
    tr.set_cycle(12)
    rec = tr.records[5].tobytes()
    assert parse_name(rec[1:13]) == (12, 2)
    assert rec.count(b"\n") == 4 and rec.startswith(b"@c012r0000002\n")


def test_indels_keep_length():
    g = _genome()
    t = dict(SE, ins_rate=0.02, del_rate=0.02)
    tr = Traffic(t, g, np.random.default_rng(9))
    assert tr.pool.codes.shape == (3000, 150)
    assert tr.records.shape[1] == 1 + 12 + 1 + 150 + 3 + 150 + 1
