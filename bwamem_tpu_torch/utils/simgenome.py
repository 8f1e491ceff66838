"""Repeat-rich synthetic genome + read simulator.

Uniform-random genomes have essentially no 19-mer repeats, so max_occ
subsampling, seed-pool pressure, XA emission and mapQ ambiguity are never
stressed (the reference's benchmarks run on real E. coli / chr21 / GRCh38,
all repeat-rich).  This module builds genomes with controlled repeat
families — a SINE-like dispersed family, tandem-repeat arrays, a segmental
duplication, and N runs — plus an error-injecting read simulator that
records the truth locus for every read.

Used by the vanilla-bwa concordance harness (tools/concordance.py) and the
repeat-stress tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def _rand_codes(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _rand_codes_gc(rng, n, gc_mean=0.41, gc_sd=0.07, gc_block=5_000):
    """Background sequence with isochore-style GC structure: a blockwise
    random-walk GC track (human-like mean 41%, blocks of a few kb) drives
    per-base composition instead of uniform 25/25/25/25. Real-genome
    stand-in — no real FASTA exists in this offline image (documented in
    CONCORDANCE.md)."""
    n_blocks = max(1, (n + gc_block - 1) // gc_block)
    # AR(1) walk keeps neighboring blocks correlated like real isochores
    gc = np.empty(n_blocks)
    gc[0] = gc_mean
    for i in range(1, n_blocks):
        gc[i] = gc[i - 1] + rng.normal(0.0, gc_sd * 0.5)
        gc[i] = gc_mean + 0.8 * (gc[i] - gc_mean)
    gc = np.clip(gc, 0.25, 0.65)
    per_base_gc = np.repeat(gc, gc_block)[:n]
    u = rng.random(n)
    is_gc = u < per_base_gc
    # split each half 50/50 (ignore weak AT/GC strand skew)
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
    """Build a repeat-rich genome of ~`size` bases.

    Returns (contigs, layout) where contigs is a list of (name, seq_str)
    with seq_str over ACGTN, and layout maps feature names to placements
    (for debugging / diff explanation).
    """
    spec = spec or RepeatSpec()
    g = _rand_codes_gc(rng, size, spec.gc_mean, spec.gc_sd)
    amb = np.zeros(size, dtype=bool)
    layout = {"sine": [], "tandem": [], "segdup": [], "nrun": [],
              "homopolymer": [], "str": []}

    def place(length):
        return int(rng.integers(0, size - length))

    # segmental duplication: copy one block elsewhere at low divergence
    if spec.segdup_len and size > 4 * spec.segdup_len:
        src = place(spec.segdup_len)
        dst = place(spec.segdup_len)
        g[dst:dst + spec.segdup_len] = _mutate(
            rng, g[src:src + spec.segdup_len], spec.segdup_div)
        layout["segdup"].append((src, dst, spec.segdup_len))

    # dispersed SINE-like family
    master = _rand_codes(rng, spec.sine_len)
    for _ in range(spec.sine_copies):
        p = place(spec.sine_len)
        el = _mutate(rng, master, spec.sine_div * rng.random() * 2)
        if rng.random() < 0.5:  # half the copies on the minus strand
            el = np.array([COMP[c] for c in el[::-1]], dtype=np.uint8)
        g[p:p + spec.sine_len] = el
        layout["sine"].append((p, spec.sine_len))

    # tandem arrays
    for _ in range(spec.tandem_arrays):
        unit = _rand_codes(rng, spec.tandem_unit)
        arr = np.tile(unit, spec.tandem_copies)
        arr = _mutate(rng, arr, 0.01)
        p = place(len(arr))
        g[p:p + len(arr)] = arr
        layout["tandem"].append((p, len(arr)))

    # homopolymer runs (sequencer stress + spurious SMEM magnets)
    for _ in range(spec.homopolymers):
        run = 5 + int(rng.geometric(spec.homopolymer_p))
        run = min(run, 40)
        p = place(run)
        g[p:p + run] = rng.integers(0, 4)
        layout["homopolymer"].append((p, run))

    # microsatellites: short-unit (1-6 bp) tandem repeats, slightly noisy
    for _ in range(spec.str_arrays):
        unit = _rand_codes(rng, int(rng.integers(1, 7)))
        n_copies = int(rng.integers(8, 60))
        arr = _mutate(rng, np.tile(unit, n_copies), 0.02)
        p = place(len(arr))
        g[p:p + len(arr)] = arr
        layout["str"].append((p, len(arr)))

    # N runs
    for _ in range(spec.n_runs):
        p = place(spec.n_run_len)
        amb[p:p + spec.n_run_len] = True
        layout["nrun"].append((p, spec.n_run_len))

    letters = BASES[g].copy()
    letters[amb] = ord("N")
    seq = letters.tobytes().decode()

    # split into contigs at clean boundaries
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


_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    _CODE[ord(b)] = i
    _CODE[ord(b.lower())] = i


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def _apply_errors(rng, read: str, sub: float, ins: float, dele: float):
    """Inject substitutions and short indels; returns mutated string."""
    out = []
    for ch in read:
        r = rng.random()
        if ch != "N" and r < sub:
            c = _CODE[ord(ch)]
            out.append("ACGT"[(c + rng.integers(1, 4)) % 4])
        elif r < sub + dele:
            continue
        elif r < sub + dele + ins:
            out.append(ch)
            out.append("ACGT"[rng.integers(0, 4)])
        else:
            out.append(ch)
    return "".join(out)


@dataclass
class SimRead:
    name: str
    seq: str
    qual: str
    contig: str
    pos: int      # 0-based truth position of the fragment start
    strand: int   # 0 = fwd, 1 = rev (read sequence is revcomp of ref)
    mate: "SimRead | None" = None


def simulate_reads(rng, contigs, n, read_len=150, sub=0.005,
                   ins=0.0005, dele=0.0005, prefix="r"):
    """Single-end reads sampled uniformly over all contigs."""
    lens = np.array([len(s) for _, s in contigs])
    probs = lens / lens.sum()
    reads = []
    for i in range(n):
        ci = int(rng.choice(len(contigs), p=probs))
        name, seq = contigs[ci]
        p = int(rng.integers(0, len(seq) - read_len))
        frag = seq[p:p + read_len]
        strand = int(rng.random() < 0.5)
        r = _revcomp(frag) if strand else frag
        r = _apply_errors(rng, r, sub, ins, dele)[:read_len]
        if len(r) < 30:
            continue
        reads.append(SimRead(f"{prefix}{i}", r, "I" * len(r),
                             name, p, strand))
    return reads


def simulate_pairs(rng, contigs, n, read_len=150, isize_mean=350,
                   isize_sd=50, sub=0.005, prefix="p"):
    """FR paired-end reads with ~N(isize_mean, isize_sd) insert sizes."""
    lens = np.array([len(s) for _, s in contigs])
    probs = lens / lens.sum()
    pairs = []
    for i in range(n):
        ci = int(rng.choice(len(contigs), p=probs))
        name, seq = contigs[ci]
        isize = max(read_len + 10,
                    int(rng.normal(isize_mean, isize_sd)))
        if len(seq) <= isize + 2:
            continue
        p = int(rng.integers(0, len(seq) - isize))
        frag = seq[p:p + isize]
        r1 = _apply_errors(rng, frag[:read_len], sub, 0.0003, 0.0003)
        r2 = _apply_errors(rng, _revcomp(frag[-read_len:]),
                           sub, 0.0003, 0.0003)
        a = SimRead(f"{prefix}{i}", r1[:read_len], "I" * min(len(r1), read_len),
                    name, p, 0)
        b = SimRead(f"{prefix}{i}", r2[:read_len], "I" * min(len(r2), read_len),
                    name, p + isize - read_len, 1)
        a.mate, b.mate = b, a
        pairs.append((a, b))
    return pairs


def write_fastq(path, reads):
    with open(path, "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
