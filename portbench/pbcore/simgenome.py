"""Repeat-rich genome and read simulator: a frozen copy for the benchmark.

`make_repeat_genome`, `RepeatSpec` and their helpers are copied from
`bwamem_tpu_torch/utils/simgenome.py` at commit
f80e7de54074e885584d5dc903dbbbf2478e9dea (the file as of 6a773b0). The one
change is the reverse complement of a SINE copy, `3 - el[::-1]` in place of
a per-base dict lookup: the same codes from the same draws.

`simulate` is new: simgenome's read model (uniform origin, per-base
substitution, deletion and insertion with one uniform draw a base, FR
pairs with normal insert sizes, read 1 on either strand of the
fragment), vectorised over a whole pool so that a
run can make hundreds of thousands of reads in about a second. Every read
has exactly `read_len` bases: the errors are applied to `read_len + 16`
source bases and the first `read_len` kept.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# the extra source bases a read is cut from, so that deletions never
# leave it short
SLACK = 16


def _rand_codes(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _rand_codes_gc(rng, n, gc_mean=0.41, gc_sd=0.07, gc_block=5_000):
    """Background sequence with isochore-style GC structure: a blockwise
    random-walk GC track drives per-base composition."""
    n_blocks = max(1, (n + gc_block - 1) // gc_block)
    gc = np.empty(n_blocks)
    gc[0] = gc_mean
    for i in range(1, n_blocks):
        gc[i] = gc[i - 1] + rng.normal(0.0, gc_sd * 0.5)
        gc[i] = gc_mean + 0.8 * (gc[i] - gc_mean)
    gc = np.clip(gc, 0.25, 0.65)
    per_base_gc = np.repeat(gc, gc_block)[:n]
    u = rng.random(n)
    is_gc = u < per_base_gc
    second = rng.random(n) < 0.5
    out = np.where(is_gc, np.where(second, 2, 1),  # G or C
                   np.where(second, 3, 0)).astype(np.uint8)  # T or A
    return out


def _mutate(rng, codes, div):
    """Point-mutate a copy of `codes` at rate `div`."""
    out = codes.copy()
    hits = rng.random(len(out)) < div
    out[hits] = (out[hits] + rng.integers(1, 4, hits.sum())) % 4
    return out


@dataclass
class RepeatSpec:
    sine_len: int = 300        # dispersed-family element length
    sine_copies: int = 200     # copies scattered through the genome
    sine_div: float = 0.05     # per-copy divergence from the master
    tandem_unit: int = 50      # tandem-array unit length
    tandem_copies: int = 24    # units per array
    tandem_arrays: int = 8     # number of arrays
    segdup_len: int = 10_000   # one segmental duplication of this size
    segdup_div: float = 0.01
    n_runs: int = 4            # ambiguous-base runs
    n_run_len: int = 200
    gc_mean: float = 0.41      # human-like genome GC; isochore blocks
    gc_sd: float = 0.07
    homopolymers: int = 120    # poly-A/T/G/C runs (length geometric)
    homopolymer_p: float = 0.25  # geometric continue-prob complement
    str_arrays: int = 40       # microsatellites: 1-6 bp unit tandems


def make_repeat_genome(rng, size: int, spec: RepeatSpec | None = None,
                       n_contigs: int = 2):
    """A repeat-rich genome of `size` bases: (contigs, layout), contigs a
    list of (name, seq_str) over ACGTN."""
    spec = spec or RepeatSpec()
    g = _rand_codes_gc(rng, size, spec.gc_mean, spec.gc_sd)
    amb = np.zeros(size, dtype=bool)
    layout = {"sine": [], "tandem": [], "segdup": [], "nrun": [],
              "homopolymer": [], "str": []}

    def place(length):
        return int(rng.integers(0, size - length))

    if spec.segdup_len and size > 4 * spec.segdup_len:
        src = place(spec.segdup_len)
        dst = place(spec.segdup_len)
        g[dst:dst + spec.segdup_len] = _mutate(
            rng, g[src:src + spec.segdup_len], spec.segdup_div)
        layout["segdup"].append((src, dst, spec.segdup_len))

    master = _rand_codes(rng, spec.sine_len)
    for _ in range(spec.sine_copies):
        p = place(spec.sine_len)
        el = _mutate(rng, master, spec.sine_div * rng.random() * 2)
        if rng.random() < 0.5:  # half the copies on the minus strand
            el = (3 - el[::-1]).astype(np.uint8)
        g[p:p + spec.sine_len] = el
        layout["sine"].append((p, spec.sine_len))

    for _ in range(spec.tandem_arrays):
        unit = _rand_codes(rng, spec.tandem_unit)
        arr = np.tile(unit, spec.tandem_copies)
        arr = _mutate(rng, arr, 0.01)
        p = place(len(arr))
        g[p:p + len(arr)] = arr
        layout["tandem"].append((p, len(arr)))

    for _ in range(spec.homopolymers):
        run = 5 + int(rng.geometric(spec.homopolymer_p))
        run = min(run, 40)
        p = place(run)
        g[p:p + run] = rng.integers(0, 4)
        layout["homopolymer"].append((p, run))

    for _ in range(spec.str_arrays):
        unit = _rand_codes(rng, int(rng.integers(1, 7)))
        n_copies = int(rng.integers(8, 60))
        arr = _mutate(rng, np.tile(unit, n_copies), 0.02)
        p = place(len(arr))
        g[p:p + len(arr)] = arr
        layout["str"].append((p, len(arr)))

    for _ in range(spec.n_runs):
        p = place(spec.n_run_len)
        amb[p:p + spec.n_run_len] = True
        layout["nrun"].append((p, spec.n_run_len))

    letters = BASES[g].copy()
    letters[amb] = ord("N")
    seq = letters.tobytes().decode()

    contigs = []
    bounds = np.linspace(0, size, n_contigs + 1).astype(int)
    for i in range(n_contigs):
        contigs.append((f"chr{i + 1}", seq[bounds[i]:bounds[i + 1]]))
    return contigs, layout


def write_fasta(path, contigs, width=70):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")


# --------------------------------------------------------------- reads

@dataclass
class Pool:
    """A pool of reads in the order they are fed. `codes` (n, read_len)
    uint8 over 0..4 in read orientation; for read k its source is the
    forward genome interval [src_lo[k], src_lo[k] + read_len + SLACK) of
    contig `contig[k]`, read on the reverse strand when `strand[k]` is 1.
    Pairs are interleaved (read 2k and 2k+1 are mates)."""
    codes: np.ndarray
    contig: np.ndarray
    src_lo: np.ndarray
    strand: np.ndarray
    victim: np.ndarray   # read made unseedable on purpose
    paired: bool


def _draw_origins(rng, starts, lens, n, span):
    """n (contig, offset) pairs with [offset, offset + span) inside the
    contig, uniform over the bases that can start one."""
    room = np.maximum(np.asarray(lens, np.int64) - span, 0)
    cum = np.cumsum(room)
    g = rng.integers(0, cum[-1], n)
    ci = np.searchsorted(cum, g, side="right")
    off = g - np.concatenate([[0], cum[:-1]])[ci]
    return ci.astype(np.int32), off.astype(np.int64)


def _errors(rng, src, read_len, sub, ins, dele):
    """simgenome's per-base error model on (n, m) source codes in read
    orientation: one uniform a base; below `sub` a substitution (not on
    N), then a deletion, then an insertion after the base of a random
    base. Returns the first read_len output bases of each row."""
    n, m = src.shape
    r = rng.random((n, m))
    subst = (r < sub) & (src < 4)
    out_src = np.where(subst, (src + rng.integers(1, 4, (n, m))) % 4,
                       src).astype(np.uint8)
    counts = np.ones((n, m), np.int64)
    counts[(r >= sub) & (r < sub + dele)] = 0
    counts[(r >= sub + dele) & (r < sub + dele + ins)] = 2
    cum = np.cumsum(counts, axis=1)
    if (cum[:, -1] < read_len).any():
        raise ValueError("too many deletions for the source slack")
    # output base o of row k comes from the first source base whose
    # cumulative count passes o; searchsorted over rows offset apart
    stride = 4 * m
    flat = (cum + (np.arange(n, dtype=np.int64) * stride)[:, None]).ravel()
    q = (np.arange(read_len, dtype=np.int64)[None, :]
         + (np.arange(n, dtype=np.int64) * stride)[:, None])
    j = np.searchsorted(flat, q.ravel(), side="right").reshape(n, read_len)
    j -= (np.arange(n) * m)[:, None]
    rows = np.arange(n)[:, None]
    out = out_src[rows, j]
    inserted = (counts[rows, j] == 2) & (np.arange(read_len)[None, :]
                                         == cum[rows, j] - 1)
    out[inserted] = rng.integers(0, 4, int(inserted.sum()), dtype=np.uint8)
    return out


def _revcomp_codes(a):
    return np.where(a < 4, 3 - a, 4)[..., ::-1].astype(np.uint8)


def simulate(rng, genome, starts, lens, n_reads, t) -> Pool:
    """`n_reads` reads (pairs interleaved when t["paired"]) under traffic
    parameters `t` over the genome codes `genome` (contig i at
    genome[starts[i]:starts[i] + lens[i]])."""
    L = int(t["read_len"])
    m = L + SLACK
    sub, ins, dele = (float(t["sub_rate"]), float(t["ins_rate"]),
                      float(t["del_rate"]))
    paired = bool(t["paired"])
    starts = np.asarray(starts, np.int64)
    idx = np.arange(m, dtype=np.int64)
    if not paired:
        ci, off = _draw_origins(rng, starts, lens, n_reads, m)
        strand = (rng.random(n_reads) < 0.5).astype(np.int8)
        src = genome[(starts[ci] + off)[:, None] + idx[None, :]]
        src = np.where(strand[:, None] == 1, _revcomp_codes(src), src)
        codes = _errors(rng, src, L, sub, ins, dele)
        return Pool(codes, ci, off, strand, np.zeros(n_reads, bool), False)
    n_pairs = n_reads // 2
    isize = np.maximum(int(t["insert_min"]), rng.normal(
        float(t["insert_mean"]), float(t["insert_sd"]), n_pairs)
        .astype(np.int64))
    span = int(isize.max()) + m
    ci, off = _draw_origins(rng, starts, lens, n_pairs, span)
    lo_f = off + m  # room on the left for the reverse read when isize < m
    lo_r = lo_f + isize - m
    base = starts[ci]
    s_f = genome[(base + lo_f)[:, None] + idx[None, :]]
    s_r = _revcomp_codes(genome[(base + lo_r)[:, None] + idx[None, :]])
    # FR pairs from either strand of the fragment: in half of the pairs
    # (drawn) read 1 is the reverse read and read 2 the forward one
    flip = rng.random(n_pairs) < 0.5
    both = np.empty((2 * n_pairs, m), np.uint8)
    both[0::2] = np.where(flip[:, None], s_r, s_f)
    both[1::2] = np.where(flip[:, None], s_f, s_r)
    codes = _errors(rng, both, L, sub, ins, dele)
    victim = np.zeros(2 * n_pairs, bool)
    every = int(t.get("victim_every", 0))
    if every:
        # one mate (drawn) of every `every`-th pair: one substitution every
        # 12 bases, so it holds no 19-base seed of its own locus and only
        # mate rescue can place it there (in a repeat it may still seed a
        # part of itself on another copy)
        vp = np.arange(every - 1, n_pairs, every)
        victim[2 * vp + rng.integers(0, 2, len(vp))] = True
        v = codes[victim]
        col = v[:, ::12]
        v[:, ::12] = np.where(col < 4, (col + 1) % 4, col)
        codes[victim] = v
    contig = np.repeat(ci, 2)
    src_lo = np.empty(2 * n_pairs, np.int64)
    src_lo[0::2] = np.where(flip, lo_r, lo_f)
    src_lo[1::2] = np.where(flip, lo_f, lo_r)
    strand = np.empty(2 * n_pairs, np.int8)
    strand[0::2], strand[1::2] = flip, ~flip
    return Pool(codes, contig, src_lo, strand, victim, True)
