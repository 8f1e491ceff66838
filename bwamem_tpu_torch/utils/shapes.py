"""Static-shape quantization for device launches.

XLA compiles one executable per shape; unbucketed padding recompiles on
almost every batch (the dominant cost in early profiles). All device entry
points round their padded dims to this geometric grid so steady state
reuses a small, finite set of executables. The reference gets the same
effect from fixed compile-time capacities (SEQ_BATCH_SIZE=5000,
MAX_SEQ_LEN, reference: src/bwamem.c:57, GASAL2 README step 3).
"""
from __future__ import annotations


def bucket_len(n: int, minimum: int = 16) -> int:
    """Round a sequence-length dim up to the {2^k, 1.5*2^k} grid."""
    n = max(int(n), minimum)
    p = minimum
    while True:
        if n <= p:
            return p
        if n <= p + (p >> 1):
            return p + (p >> 1)
        p <<= 1


def bucket_count(n: int, minimum: int = 16) -> int:
    """Round a batch dim up to the {2^k, 1.5*2^k} grid (padding lanes are
    masked dead; ~17% worst-case waste beats a recompile)."""
    return bucket_len(n, minimum)


def bucket_read_len(n: int) -> int:
    """Finer grid (multiples of 32 up to 512, then the coarse grid) for
    the SEEDING read-length dim only. The forward scan's serial
    dependent-gather chain is proportional to this dim — the coarse grid
    pads 150 bp reads to 192 (96 pair trips where 151 positions need
    76); this grid pads to 160 (80 trips). Real datasets carry one or
    two read lengths, so the larger executable family stays tiny.
    Extension tiles keep the coarse grid: their padded dims cost
    throughput, not serial latency, and their length spread is wide."""
    n = max(int(n), 32)
    if n <= 512:
        return (n + 31) & ~31
    return bucket_len(n)
