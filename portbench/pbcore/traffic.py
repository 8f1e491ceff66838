"""A traffic mix's read pool, drawn from the run's seed, as the FASTQ bytes
the harness feeds and the truth the reference checks against.

Read names are fixed width, `c<cycle:3>r<index:7>`: the pool is fed over
and over, and each pass (cycle) renames its reads, so that every read of
a run has a name of its own. Mates share a name.
"""
from __future__ import annotations

import numpy as np

from . import simgenome

_ASCII = np.frombuffer(b"ACGTN", np.uint8)
NAME_LEN = 12          # c000r0000000
WARM_CYCLE = 999       # the names of the warm-up chunk's reads
MAX_POOL = 10_000_000


def _digits(values, width):
    """(n, width) ASCII digits of the non-negative ints `values`."""
    v = np.asarray(values, np.int64)[:, None]
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)[None, :]
    return (ord("0") + (v // p) % 10).astype(np.uint8)


def parse_name(name: bytes) -> tuple[int, int]:
    """(cycle, pool index) of a read name this module made."""
    return int(name[1:4]), int(name[5:12])


class Traffic:
    """The pool of a run: `pool` (simgenome.Pool), `records` (n, R) uint8
    FASTQ rows with the cycle digits at columns 2-4."""

    def __init__(self, t: dict, genome, seed: int):
        self.spec = t
        n = int(t["pool_reads"])
        if t["paired"] and n % 2:
            raise ValueError("a paired pool holds whole pairs")
        if n > MAX_POOL:
            raise ValueError(f"pool_reads above {MAX_POOL}")
        rng = np.random.default_rng(seed)
        self.pool = simgenome.simulate(rng, genome.codes, genome.starts,
                                       genome.lens, n, t)
        L = self.pool.codes.shape[1]
        self.read_len = L
        qual = ord(str(t.get("qual_char", "I")))
        rec = np.empty((n, 1 + NAME_LEN + 1 + L + 3 + L + 1), np.uint8)
        rec[:, 0] = ord("@")
        rec[:, 1] = ord("c")
        rec[:, 2:5] = ord("0")
        rec[:, 5] = ord("r")
        rec[:, 6:13] = _digits(np.arange(n) // (2 if t["paired"] else 1), 7)
        rec[:, 13] = ord("\n")
        rec[:, 14:14 + L] = _ASCII[self.pool.codes]
        rec[:, 14 + L:17 + L] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 17 + L:17 + 2 * L] = qual
        rec[:, -1] = ord("\n")
        self.records = rec
        self.paired = bool(t["paired"])
        self.qual_char = chr(qual)

    def __len__(self):
        return self.records.shape[0]

    def set_cycle(self, cycle: int) -> None:
        if not 0 <= cycle <= WARM_CYCLE:
            raise ValueError(f"cycle {cycle} has no 3-digit name")
        self.records[:, 2:5] = _digits([cycle], 3)[0]


def chunk_records(chunk_bases: int, read_len: int, paired: bool) -> int:
    """Records in the program's first chunk: reads until their bases reach
    chunk_bases, and an even count for pairs (the port's
    `io.fastx.chunk_records` rule, bwa's bseq_read)."""
    n = -(-chunk_bases // read_len)
    return n + (n % 2 if paired else 0)
