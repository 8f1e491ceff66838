"""Offline FMD-index construction.

Pipeline (mirrors `bwa index` capability, reference bwa_index/bwtindex.c:288
bwa_idx_build, rebuilt from first principles):

  FASTA -> forward codes (N -> seeded-random base, amb runs recorded)
        -> T = fwd || revcomp(fwd)
        -> suffix array (native SA-IS or NumPy doubling)
        -> BWT (+ primary), occ checkpoint blocks
        -> text-position sampled SA (bitmap + rank checkpoints)
        -> FMIndex (.npz)
"""
from __future__ import annotations

import numpy as np

from ..utils.dna import encode, pack_2bit
from .format import Annotation, FMIndex, OCC_BLOCK_BASES, SSA_BLOCK_ROWS
from .suffix_array import suffix_array

# slice length for the streamed build passes in build_index_from_codes
# (tests shrink it to exercise the chunk-boundary logic at toy sizes)
_BUILD_CHUNK = 1 << 27


def read_fasta(path: str) -> list[tuple[str, np.ndarray, str]]:
    """Parse FASTA into [(name, codes, description)] with codes 0..4."""
    from ..io.fastx import open_maybe_gzip

    out: list = []
    name = None
    anno = ""
    chunks: list[bytes] = []
    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, encode(b"".join(chunks)), anno))
                parts = line[1:].split(None, 1)
                name = parts[0].decode()
                anno = parts[1].decode() if len(parts) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        out.append((name, encode(b"".join(chunks)), anno))
    return out


def _amb_runs(codes: np.ndarray, offset: int) -> list[tuple[int, int]]:
    amb = codes >= 4
    if not amb.any():
        return []
    d = np.diff(amb.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if amb[0]:
        starts = np.concatenate([[0], starts])
    if amb[-1]:
        ends = np.concatenate([ends, [len(codes)]])
    return [(int(offset + s), int(e - s)) for s, e in zip(starts, ends)]


def build_index(
    fasta_path: str,
    sa_intv: int = 4,
    rng_seed: int = 11,
) -> FMIndex:
    seqs = read_fasta(fasta_path)
    if not seqs:
        raise ValueError(f"no sequences in {fasta_path}")
    names, lengths, offsets, ambs, annos = [], [], [], [], []
    parts = []
    off = 0
    rng = np.random.default_rng(rng_seed)
    for name, codes, anno in seqs:
        names.append(name)
        annos.append(anno)
        lengths.append(len(codes))
        offsets.append(off)
        ambs.extend(_amb_runs(codes, off))
        amb_mask = codes >= 4
        if amb_mask.any():
            codes = codes.copy()
            codes[amb_mask] = rng.integers(0, 4, amb_mask.sum(), dtype=np.uint8)
        parts.append(codes)
        off += len(codes)
    fwd = np.concatenate(parts).astype(np.uint8)
    ann = Annotation(names=names, lengths=lengths, offsets=offsets,
                     ambs=ambs, annos=annos)
    return build_index_from_codes(fwd, ann, sa_intv=sa_intv)


def build_index_from_codes(
    fwd: np.ndarray, ann: Annotation, sa_intv: int = 4
) -> FMIndex:
    """Build from an unambiguous 0..3 coded forward genome."""
    fwd = np.asarray(fwd, dtype=np.uint8)
    if fwd.max(initial=0) > 3:
        raise ValueError("forward genome must be unambiguous (0..3)")
    l_pac = len(fwd)
    if 2 * l_pac + 1 >= 2**33:
        raise ValueError(
            "genomes with 2*l_pac >= 2^33 exceed the split-word scheme "
            "(uint32 low + upper bits); not supported")
    T = np.concatenate([fwd, (3 - fwd)[::-1]]).astype(np.uint8)
    seq_len = len(T)

    sa = suffix_array(T)  # seq_len rows, sentinel row excluded
    # Conceptual SA over T$ : row 0 is the sentinel suffix (value seq_len).
    primary = int(np.flatnonzero(sa == 0)[0]) + 1

    # Everything below streams over `sa` in bounded slices: at human
    # scale (2*l_pac ~ 6.2e9) whole-array fancy indexing would
    # materialize multiple ~50 GB int64 temporaries next to the 50 GB
    # suffix array itself (BASELINE configs 3/4; the reference's build
    # has the same pass structure via bwt_cal_sa, bwa_index/bwt.c:63).
    CH = _BUILD_CHUNK  # rows/slice: <= ~1.1 GB of int64 temp per pass

    # BWT over T$ with the sentinel row removed (bwa convention).
    # BWT$[r] = T[SA$[r]-1]; at r=0, SA$[0]=seq_len -> T[seq_len-1].
    bwt_full = np.empty(seq_len + 1, dtype=np.uint8)
    bwt_full[0] = T[seq_len - 1]
    for lo in range(0, seq_len, CH):
        v = sa[lo : lo + CH].astype(np.int64, copy=True)
        v -= 1
        v[v < 0] = seq_len - 1  # value at primary row is bogus ($)
        bwt_full[1 + lo : 1 + lo + len(v)] = T[v]
    B = np.delete(bwt_full, primary)

    counts = np.bincount(B, minlength=4)[:4]
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(counts)

    # occ checkpoint blocks; one extra terminal block so that queries at
    # row seq_len(+1) stay in range when seq_len is a multiple of the
    # block size (occ4 may be evaluated at interval end = seq_len + 1)
    n_blocks = (seq_len + OCC_BLOCK_BASES - 1) // OCC_BLOCK_BASES + 1
    Bp = np.zeros(n_blocks * OCC_BLOCK_BASES, dtype=np.uint8)
    Bp[:seq_len] = B
    occ_blocks = np.empty((n_blocks, 8), dtype=np.uint32)
    # counts before each block; padding bases (code 0) in the last block are
    # harmless because queries never exceed seq_len.
    run = np.zeros(4, dtype=np.int64)
    CHB = CH // OCC_BLOCK_BASES
    for blo in range(0, n_blocks, CHB):
        bhi = min(blo + CHB, n_blocks)
        blk = Bp[blo * OCC_BLOCK_BASES : bhi * OCC_BLOCK_BASES].reshape(
            bhi - blo, OCC_BLOCK_BASES)
        per_block = (blk[:, :, None] == np.arange(4)[None, None, :]).sum(
            axis=1).astype(np.int64)
        cum = np.zeros((bhi - blo, 4), dtype=np.int64)
        cum[1:] = np.cumsum(per_block, axis=0)[:-1]
        occ_blocks[blo:bhi, :4] = (cum + run).astype(np.uint32)
        occ_blocks[blo:bhi, 4:] = pack_2bit(blk.reshape(-1)).reshape(
            bhi - blo, 4)
        run += per_block.sum(axis=0)
    # keep the final partial block's padding (code 0) out of the terminal
    # row: store true totals there, as the reference's trailing occ entry
    # does (bwa_index/bwtindex.c:186-188) — the row is only ever queried
    # when seq_len is a block multiple, in which case it already is
    occ_blocks[-1, :4] = counts.astype(np.uint32)

    # text-position sampled SA over the (seq_len+1)-row conceptual SA
    # (row 0 = sentinel suffix, value seq_len), streamed in slices
    n_sblocks = (seq_len + 1 + SSA_BLOCK_ROWS - 1) // SSA_BLOCK_ROWS
    bits = np.zeros(n_sblocks * SSA_BLOCK_ROWS, dtype=bool)
    bits[0] = (seq_len % sa_intv) == 0
    n_sampled = int(bits[0])
    for lo in range(0, seq_len, CH):
        v = sa[lo : lo + CH]
        m = (v % sa_intv) == 0
        bits[1 + lo : 1 + lo + len(v)] = m
        n_sampled += int(m.sum())
    # split SA values: uint32 low words + uint8 upper bits (the reference
    # packs upper bits the same way for >4G-position genomes,
    # bwa_index/bwt.c:88-148; uint8 covers seq_len < 2^40)
    ssa_vals = np.empty(n_sampled, dtype=np.uint32)
    ssa_vals_hi = np.empty(n_sampled, dtype=np.uint8)
    if bits[0]:
        ssa_vals[0] = seq_len & 0xFFFFFFFF
        ssa_vals_hi[0] = seq_len >> 32
    w = int(bits[0])
    for lo in range(0, seq_len, CH):
        v = sa[lo : lo + CH]
        sel = v[bits[1 + lo : 1 + lo + len(v)]]
        ssa_vals[w : w + len(sel)] = (sel & 0xFFFFFFFF).astype(np.uint32)
        ssa_vals_hi[w : w + len(sel)] = (sel >> 32).astype(np.uint8)
        w += len(sel)
    assert w == n_sampled
    bits = bits.reshape(n_sblocks, SSA_BLOCK_ROWS)
    per_block_rank = bits.sum(axis=1).astype(np.int64)
    rank_before = np.zeros(n_sblocks, dtype=np.int64)
    rank_before[1:] = np.cumsum(per_block_rank)[:-1]
    # little-endian 64-bit bitmap per block, as two uint32 words
    # (packbits keeps the temp at n_sblocks*8 bytes — the old
    # broadcast-multiply built a 32x-wider uint64 plane)
    packed = np.packbits(bits, axis=1, bitorder="little")
    words = np.ascontiguousarray(packed).view(np.uint32)
    ssa_blocks = np.empty((n_sblocks, 4), dtype=np.uint32)
    ssa_blocks[:, 0] = rank_before.astype(np.uint32)
    ssa_blocks[:, 1] = words[:, 0]
    ssa_blocks[:, 2] = words[:, 1]
    ssa_blocks[:, 3] = 0

    assert seq_len < (1 << 33), "genomes above 2^33 doubled bases unsupported"

    return FMIndex(
        l_pac=l_pac,
        seq_len=seq_len,
        primary=primary,
        sa_intv=sa_intv,
        L2=L2,
        occ_blocks=occ_blocks,
        ssa_blocks=ssa_blocks,
        ssa_vals=ssa_vals,
        ssa_vals_hi=ssa_vals_hi,
        pac_words=pack_2bit(fwd),
        ann=ann,
    )
