"""DNA encoding utilities.

Base coding follows the BWA convention (reference: src/bntseq.c nst_nt4_table):
A=0, C=1, G=2, T=3, anything else (N, IUPAC ambiguity) = 4.
Complement of base b (b<4) is 3-b.
"""
from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code lookup (255 -> 4 for ambiguous)
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    NT4_TABLE[ord(_ch)] = _code
    NT4_TABLE[ord(_ch.lower())] = _code

CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0,1,2,3,4}."""
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    return NT4_TABLE[seq]


def decode(codes: np.ndarray) -> str:
    return CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a 0..4 coded sequence (4 stays 4)."""
    c = np.asarray(codes)
    out = np.where(c < 4, 3 - c, c).astype(np.uint8)
    return out[::-1]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes, 16 bases per uint32, base i at bits (30 - 2*(i%16)).

    Big-endian-within-word ordering so that unpacking is a right shift by
    (30 - 2*pos); mirrors the lane-friendly layout used by the occ blocks.
    Length is zero-padded to a multiple of 16 (pad base = 0/A; callers must
    bound indexing by the true length).
    """
    c = np.asarray(codes, dtype=np.uint32)
    if np.any(c > 3):
        raise ValueError("pack_2bit requires codes in 0..3")
    n = len(c)
    npad = (-n) % 16
    if npad:
        c = np.concatenate([c, np.zeros(npad, dtype=np.uint32)])
    c = c.reshape(-1, 16)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(c << shifts, axis=1).astype(np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    w = np.asarray(words, dtype=np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))[None, :]
    out = ((w[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)
    return out[:n]
