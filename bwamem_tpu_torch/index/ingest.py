"""Ingest a reference-format index (`bwa index` output) into FMIndex.

Reads the file set produced by the reference's two-pass build
(reference: build_index.sh — `bwa index -s sa` at OCC_INTV_SHIFT=7 for
P.sa, then `-s bwt` at shift 6 for the GPU-layout P.bwt):

  P.ann / P.amb  bntseq text metadata (reference: bwa_index/bntseq.c
                 bns_dump/bns_restore)
  P.pac          2-bit packed forward genome, base l at byte l>>2 bits
                 (~l&3)<<1 (reference: bwa_index/bntseq.h _get_pac)
  P.bwt          primary u64, L2[1..4] u64, then per 64 BWT symbols:
                 4 x u32 cumulative-before counts + up to 4 x u32 data
                 words (16 symbols each, first symbol in the top bits),
                 and a trailing 4 x u32 total-count entry (reference:
                 bwa_index/bwtindex.c:174-198 bwt_bwtupdate_core_occ_32,
                 bwa_index/bwt.c:461-470 bwt_dump_bwt)
  P.sa           primary u64, L2 skip, sa_intv u64, seq_len u64,
                 uint32 low words of SA at rows isa % sa_intv == 0
                 (entries 1..n_sa-1; row 0 is the sentinel, stored -1),
                 then pack_size u8 + packed upper-bits words (reference:
                 bwa_index/bwt.c:63-148 bwt_cal_sa, :472-487 bwt_dump_sa)

The occ/data interleave of P.bwt is EXACTLY this framework's 32-byte occ
row (index/format.py OCC_BLOCK_BASES=64 was chosen to mirror the GPU
fetch unit), so the BWT ingest is a reshape. The suffix array needs real
work: the reference samples by ROW (isa % intv == 0) while this
framework samples by TEXT POSITION (sa % intv == 0) to bound the TPU LF
walk — so ingest recovers the full SA with the O(seq_len) inverse-Psi
walk (the same walk bwt_cal_sa used to build P.sa, bwa_index/bwt.c:
121-148) and re-samples, cross-checking every reference sample on the
way. A mismatch means a corrupt/incompatible file set and raises.
"""
from __future__ import annotations

import struct

import numpy as np

from ..utils.dna import pack_2bit
from .format import Annotation, FMIndex, OCC_BLOCK_BASES, SSA_BLOCK_ROWS


def read_ann_amb(prefix: str) -> tuple[Annotation, int]:
    """Parse P.ann + P.amb (text formats, bntseq.c bns_dump)."""
    with open(prefix + ".ann") as f:
        first = f.readline().split()
        l_pac, n_seqs = int(first[0]), int(first[1])
        names, lengths, offsets, annos = [], [], [], []
        for _ in range(n_seqs):
            head = f.readline().split(None, 2)
            names.append(head[1])
            anno = head[2].strip() if len(head) > 2 else ""
            annos.append("" if anno == "(null)" else anno)
            off_len = f.readline().split()
            offsets.append(int(off_len[0]))
            lengths.append(int(off_len[1]))
    ambs: list[tuple[int, int]] = []
    with open(prefix + ".amb") as f:
        head = f.readline().split()
        n_holes = int(head[2])
        for _ in range(n_holes):
            rec = f.readline().split()
            ambs.append((int(rec[0]), int(rec[1])))
    ann = Annotation(names=names, lengths=lengths, offsets=offsets,
                     ambs=ambs, annos=annos)
    return ann, l_pac


def read_pac(prefix: str, l_pac: int) -> np.ndarray:
    """Forward genome codes 0..3 from the 2-bit P.pac."""
    raw = np.fromfile(prefix + ".pac", dtype=np.uint8,
                      count=(l_pac + 3) // 4)
    shifts = np.array([6, 4, 2, 0], np.uint8)  # base l at (~l&3)<<1
    codes = (raw[:, None] >> shifts[None, :]) & 3
    return codes.reshape(-1)[:l_pac].astype(np.uint8)


def read_bwt(prefix: str):
    """P.bwt -> (primary, L2[5] int64, occ_blocks (n,8) u32, bwt codes)."""
    with open(prefix + ".bwt", "rb") as f:
        raw = f.read()
    primary, = struct.unpack("<Q", raw[:8])
    L2 = np.zeros(5, np.int64)
    L2[1:] = struct.unpack("<4Q", raw[8:40])
    seq_len = int(L2[4])
    words = np.frombuffer(raw, dtype="<u4", offset=40)

    nb = (seq_len + OCC_BLOCK_BASES - 1) // OCC_BLOCK_BASES
    occ_blocks = np.zeros((nb + 1, 8), np.uint32)
    pos = 0
    for b in range(nb):
        occ_blocks[b, :4] = words[pos:pos + 4]
        pos += 4
        rem = min(OCC_BLOCK_BASES, seq_len - b * OCC_BLOCK_BASES)
        ndata = (rem + 15) // 16
        occ_blocks[b, 4:4 + ndata] = words[pos:pos + ndata]
        pos += ndata
    occ_blocks[nb, :4] = words[pos:pos + 4]  # trailing total counts
    pos += 4
    if pos > len(words):
        raise ValueError(f"{prefix}.bwt truncated: need {pos} payload "
                         f"words, file has {len(words)}")

    # decode the $-removed BWT string (validated against occ rows below)
    data = occ_blocks[:nb, 4:].reshape(-1)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))
    codes = ((data[:, None] >> shifts[None, :]) & 3).reshape(-1)
    bwt = codes[:seq_len].astype(np.uint8)

    # occ rows must equal cumulative counts of the decoded string
    cnt = np.zeros((nb + 1, 4), np.int64)
    blk = np.zeros(nb * OCC_BLOCK_BASES, np.uint8)
    blk[:seq_len] = bwt
    per = (blk.reshape(nb, OCC_BLOCK_BASES)[:, :, None]
           == np.arange(4)[None, None, :]).sum(axis=1)
    # padding bases decode as code 0; the final partial block's file
    # counts exclude them
    if seq_len % OCC_BLOCK_BASES:
        per[nb - 1, 0] -= OCC_BLOCK_BASES - seq_len % OCC_BLOCK_BASES
    cnt[1:] = np.cumsum(per, axis=0)
    if not (occ_blocks[:, :4] == cnt.astype(np.uint32)).all():
        raise ValueError(f"{prefix}.bwt occ rows disagree with its own "
                         "BWT data (wrong OCC_INTERVAL layout?)")
    return primary, L2, occ_blocks, bwt


def read_sa(prefix: str):
    """P.sa -> (sa_intv, seq_len, values int64[n_sa]) where values[i] is
    SA[i * sa_intv] over the conceptual (seq_len+1)-row SA (row 0 is the
    sentinel; the file stores -1 there, semantically seq_len)."""
    with open(prefix + ".sa", "rb") as f:
        raw = f.read()
    primary, = struct.unpack("<Q", raw[:8])
    sa_intv, seq_len = struct.unpack("<2Q", raw[40:56])
    n_sa = (seq_len + sa_intv) // sa_intv
    low = np.frombuffer(raw, dtype="<u4", offset=56, count=n_sa - 1)
    off = 56 + 4 * (n_sa - 1)
    pack_size = raw[off]
    nbw = pack_size * n_sa // 32 + 1
    bits = np.frombuffer(raw, dtype="<u4", offset=off + 1, count=nbw)
    vals = np.empty(n_sa, np.int64)
    vals[0] = seq_len
    idx = np.arange(1, n_sa, dtype=np.int64)
    if pack_size and int(seq_len) >> 32:
        pack_div = 32 // pack_size
        shift = (idx % pack_div) * pack_size
        mask = (1 << pack_size) - 1
        hi = (bits[(idx // pack_div).astype(np.int64)] >> shift) & mask
        vals[1:] = low.astype(np.int64) | (hi.astype(np.int64) << 32)
    else:
        vals[1:] = low.astype(np.int64)
    return int(primary), int(sa_intv), int(seq_len), vals


def full_sa_from_bwt(bwt: np.ndarray, L2: np.ndarray, primary: int,
                     ref_intv: int = 0,
                     ref_vals: np.ndarray | None = None) -> np.ndarray:
    """Recover the full conceptual SA (seq_len+1 rows) by the inverse-Psi
    walk (reference: bwa_index/bwt.c:121-148 — sa decrements from
    seq_len as isa walks invPsi from row 0). When ref_vals is given,
    every row isa % ref_intv == 0 is cross-checked against it."""
    seq_len = len(bwt)
    # LF(row of B position p) = 1 + L2[c] + (#c in B[0..p-1]); +1 for the
    # sentinel at conceptual row 0
    order = np.argsort(bwt, kind="stable").astype(np.int64)
    lf = np.empty(seq_len, np.int64)
    lf[order] = np.arange(1, seq_len + 1, dtype=np.int64)
    sa_full = np.empty(seq_len + 1, np.int64)
    isa = 0
    check = ref_vals if ref_vals is not None else None
    for sa in range(seq_len, -1, -1):
        sa_full[isa] = sa
        if check is not None and isa % ref_intv == 0:
            want = int(check[isa // ref_intv])
            got = sa if isa else seq_len  # row 0 stores seq_len
            if want != got:
                raise ValueError(
                    f"P.sa cross-check failed at row {isa}: file says "
                    f"{want}, walk says {got}")
        if sa == 0:
            break
        # invPsi: step to the row of the previous text position
        isa = 0 if isa == primary else int(lf[isa - (isa > primary)])
    return sa_full


def load_reference_index(prefix: str, sa_intv: int = 4,
                         verify: bool = True) -> FMIndex:
    """Load a reference two-pass index (P.ann/.amb/.pac/.bwt/.sa) as an
    FMIndex usable everywhere a natively-built index is."""
    ann, l_pac = read_ann_amb(prefix)
    fwd = read_pac(prefix, l_pac)
    primary, L2, occ_blocks, bwt = read_bwt(prefix)
    seq_len = int(L2[4])
    if seq_len != 2 * l_pac:
        raise ValueError(f"{prefix}.bwt seq_len {seq_len} != 2*l_pac "
                         f"{2 * l_pac}")
    sa_primary, ref_intv, sa_seq_len, ref_vals = read_sa(prefix)
    if sa_primary != primary or sa_seq_len != seq_len:
        raise ValueError(f"{prefix}.sa does not match {prefix}.bwt "
                         "(primary/seq_len disagree)")
    sa_full = full_sa_from_bwt(
        bwt, L2, primary, ref_intv, ref_vals if verify else None)

    # re-sample by text position (this framework's scheme) — same code
    # shape as build.py:140-165
    sampled = (sa_full % sa_intv) == 0
    n_sblocks = (seq_len + 1 + SSA_BLOCK_ROWS - 1) // SSA_BLOCK_ROWS
    bits = np.zeros(n_sblocks * SSA_BLOCK_ROWS, dtype=bool)
    bits[:seq_len + 1] = sampled
    bits = bits.reshape(n_sblocks, SSA_BLOCK_ROWS)
    rank_before = np.zeros(n_sblocks, np.int64)
    rank_before[1:] = np.cumsum(bits.sum(axis=1))[:-1]
    w = (1 << np.arange(32, dtype=np.uint64))
    ssa_blocks = np.empty((n_sblocks, 4), np.uint32)
    ssa_blocks[:, 0] = rank_before.astype(np.uint32)
    ssa_blocks[:, 1] = (bits[:, :32].astype(np.uint64) * w).sum(axis=1)
    ssa_blocks[:, 2] = (bits[:, 32:].astype(np.uint64) * w).sum(axis=1)
    ssa_blocks[:, 3] = 0
    sampled_vals = sa_full[sampled]

    return FMIndex(
        l_pac=l_pac,
        seq_len=seq_len,
        primary=primary,
        sa_intv=sa_intv,
        L2=L2,
        occ_blocks=occ_blocks,
        ssa_blocks=ssa_blocks,
        ssa_vals=(sampled_vals & 0xFFFFFFFF).astype(np.uint32),
        ssa_vals_hi=(sampled_vals >> 32).astype(np.uint8),
        pac_words=pack_2bit(fwd),
        ann=ann,
    )
