"""On-disk / in-memory FMD-index format, designed for TPU gathers.

Differences from the reference's two-pass sed-patched format (reference:
build_index.sh, bwa_index/bwtindex.c:151-198, SURVEY §2.2) — we keep the
*ideas* (checkpoint-interleaved occ, sampled SA) but define one consistent
layout:

  * occ_blocks: (n_blocks, 8) uint32 — per 64 BWT symbols one row
      [occ_A, occ_C, occ_G, occ_T, data0, data1, data2, data3]
    where occ_* are cumulative counts BEFORE the block and data words pack
    16 bases each (2 bits, base p at bits 30-2*(p%16)). One row = 32 bytes,
    fetched with a single gather (mirrors the GPU's two-uint4 unit,
    reference: seed_gen.cu:42-48,110-111).
  * Sampled suffix array by TEXT POSITION (SA value % sa_intv == 0), not by
    row index as the reference does (bwa_index/bwt.c:63-148): this bounds
    the LF walk to < sa_intv steps, which a TPU fixed-trip loop needs.
      ssa_blocks: (n_sblocks, 4) uint32 — per 64 rows
        [rank_before, bits_lo(rows 0..31), bits_hi(rows 32..63), pad]
      ssa_vals: uint32 SA values of sampled rows, in row order.
    Row r is sampled iff bit (r%64) is set in its block bitmap; its value is
    ssa_vals[rank_before + popcount(bits below r)].
  * pac_words: 2-bit packed FORWARD genome (16 bases/uint32) for reference
    window fetching (equivalent of bns_get_seq, reference src/bntseq.h:126).

The BWT is over T = forward || reverse-complement(forward), length
seq_len = 2*l_pac, single terminal sentinel (excluded from the stored BWT;
`primary` is the sentinel's row in the (seq_len+1)-row conceptual SA, as in
bwa). Ambiguous bases are replaced by seeded-random ACGT in pac/BWT and
recorded in `ambs` (reference: bns_fasta2bntseq behavior).

Positions/rows are 64-bit on device (XLA x64; rows up to 2^33 supported —
human fwd+rev ~6.2 Gbp). Sampled SA values are stored split: uint32 low
words + uint8 upper bits (the reference's packed-upper-bits scheme,
bwa_index/bwt.c:88-116).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

OCC_BLOCK_BASES = 64  # BWT symbols per occ checkpoint row
SSA_BLOCK_ROWS = 64   # SA rows per sampled-SA bitmap row


@dataclass
class Annotation:
    """Reference metadata (equivalent of bntseq .ann/.amb)."""

    names: list[str]
    lengths: list[int]   # per-sequence lengths
    offsets: list[int]   # per-sequence start offsets in the forward pac
    ambs: list[tuple[int, int]] = field(default_factory=list)  # (offset, len) N runs
    is_alt: list[bool] = field(default_factory=list)  # ALT contig flags
    #   (reference: bns->anns[i].is_alt, read from <prefix>.alt)
    annos: list[str] = field(default_factory=list)  # FASTA descriptions
    #   (reference: bns->anns[i].anno, emitted in XR:Z under -V)

    def anno_of(self, rid: int) -> str:
        return self.annos[rid] if self.annos else ""

    def alt_of(self, rid: int) -> bool:
        return bool(self.is_alt[rid]) if self.is_alt else False

    def pos_to_rid(self, pos: int) -> int:
        """Forward-strand position -> reference id; -1 if out of range.

        Equivalent of bns_pos2rid (reference: src/bntseq.h:130).
        """
        if pos < 0 or pos >= self.offsets[-1] + self.lengths[-1]:
            return -1
        lo, hi = 0, len(self.offsets)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.offsets[mid] <= pos:
                lo = mid
            else:
                hi = mid
        return lo


@dataclass
class FMIndex:
    l_pac: int
    seq_len: int          # 2 * l_pac
    primary: int          # sentinel row in the (seq_len+1)-row SA
    sa_intv: int
    L2: np.ndarray        # int64[5]: L2[0]=0, L2[c+1]=L2[c]+count(c) over BWT
    occ_blocks: np.ndarray   # (n_blocks, 8) uint32
    ssa_blocks: np.ndarray   # (n_sblocks, 4) uint32
    ssa_vals: np.ndarray     # (n_sampled,) uint32 low words
    pac_words: np.ndarray    # (ceil(l_pac/16),) uint32
    ann: Annotation
    ssa_vals_hi: np.ndarray | None = None  # (n_sampled,) uint8 bits >= 32

    # ---------- host-side reference fetching ----------

    def get_base(self, pos) -> np.ndarray:
        """Base code at forward-strand position(s) `pos` (0..3)."""
        pos = np.asarray(pos)
        w = self.pac_words[pos >> 4]
        return ((w >> (30 - 2 * (pos & 15))) & 3).astype(np.uint8)

    def fetch_seq(self, beg: int, end: int, mid: int | None = None) -> tuple[int, int, np.ndarray]:
        """Fetch [beg, end) in DOUBLED coordinates (rev strand for
        pos >= l_pac), clipped at the strand boundary of `mid` the way
        bns_fetch_seq does (reference: src/bntseq.c bns_fetch_seq).

        Returns (beg, end, seq) after clipping."""
        if beg > end:
            raise ValueError("beg > end")
        lp = self.l_pac
        if mid is None:
            mid = (beg + end) // 2
        if mid < lp:
            end = min(end, lp)
        else:
            beg = max(beg, lp)
        beg = max(beg, 0)
        end = min(end, 2 * lp)
        if end <= beg:
            return beg, end, np.empty(0, dtype=np.uint8)
        if end <= lp:
            pos = np.arange(beg, end)
            return beg, end, self.get_base(pos)
        # reverse strand: position p maps to forward 2*lp-1-p, complemented
        pos = 2 * lp - 1 - np.arange(beg, end)
        return beg, end, (3 - self.get_base(pos)).astype(np.uint8)

    def fetch_bounds_rid(self, beg: int, end: int,
                         mid: int) -> tuple[int, int, int]:
        """The clipping half of fetch_seq_rid WITHOUT materializing the
        bases: (beg, end, rid) after rid-boundary + strand clipping.
        Callers that gather the window on-device (descriptor-driven mate
        rescue) only need the bounds — per-job base extraction was the
        dominant host cost of the rescue build loop."""
        lp = self.l_pac
        is_rev = mid >= lp
        fpos = (2 * lp - 1 - mid) if is_rev else mid
        rid = self.ann.pos_to_rid(fpos)
        if rid < 0:
            return beg, beg, rid
        far_beg = self.ann.offsets[rid]
        far_end = far_beg + self.ann.lengths[rid]
        if is_rev:
            far_beg, far_end = 2 * lp - far_end, 2 * lp - far_beg
        beg = max(beg, far_beg)
        end = min(end, far_end)
        # fetch_seq's strand clip (bns_fetch_seq clips at the boundary
        # of mid's strand)
        if mid < lp:
            end = min(end, lp)
        else:
            beg = max(beg, lp)
        beg = max(beg, 0)
        end = min(end, 2 * lp)
        if end < beg:
            end = beg
        return beg, end, rid

    def fetch_seq_rid(self, beg: int, end: int,
                      mid: int) -> tuple[int, int, np.ndarray, int]:
        """bns_fetch_seq equivalent (reference: src/bntseq.c bns_fetch_seq):
        like fetch_seq but also clips [beg, end) to the boundaries of the
        reference sequence containing `mid` and returns its rid."""
        lp = self.l_pac
        is_rev = mid >= lp
        fpos = (2 * lp - 1 - mid) if is_rev else mid
        rid = self.ann.pos_to_rid(fpos)
        if rid < 0:
            return beg, beg, np.empty(0, dtype=np.uint8), rid
        far_beg = self.ann.offsets[rid]
        far_end = far_beg + self.ann.lengths[rid]
        if is_rev:
            far_beg, far_end = 2 * lp - far_end, 2 * lp - far_beg
        beg = max(beg, far_beg)
        end = min(end, far_end)
        b, e, seq = self.fetch_seq(beg, end, mid=mid)
        return b, e, seq, rid

    # ---------- save / load ----------

    def save(self, path: str) -> None:
        meta = dict(
            l_pac=self.l_pac, seq_len=self.seq_len, primary=self.primary,
            sa_intv=self.sa_intv,
            names=self.ann.names, lengths=self.ann.lengths,
            offsets=self.ann.offsets, ambs=self.ann.ambs,
            annos=self.ann.annos,
            version=1,
        )
        np.savez(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            L2=self.L2,
            occ_blocks=self.occ_blocks,
            ssa_blocks=self.ssa_blocks,
            ssa_vals=self.ssa_vals,
            ssa_vals_hi=(self.ssa_vals_hi if self.ssa_vals_hi is not None
                         else np.zeros(len(self.ssa_vals), np.uint8)),
            pac_words=self.pac_words,
        )

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        if not path.endswith(".npz"):
            path = path + ".npz"
        import os

        alt_names: set = set()
        alt_path = path[: -len(".bmt.npz")] + ".alt" \
            if path.endswith(".bmt.npz") else path + ".alt"
        if os.path.exists(alt_path):
            # bwa convention: the .alt file is SAM-ish; the first token of
            # each non-header line names an ALT contig (bns_restore)
            with open(alt_path) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("@"):
                        alt_names.add(line.split()[0])
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            ann = Annotation(
                names=list(meta["names"]),
                lengths=list(meta["lengths"]),
                offsets=list(meta["offsets"]),
                ambs=[tuple(a) for a in meta["ambs"]],
                is_alt=[n in alt_names for n in meta["names"]],
                annos=list(meta.get("annos", [])),
            )
            return cls(
                l_pac=int(meta["l_pac"]),
                seq_len=int(meta["seq_len"]),
                primary=int(meta["primary"]),
                sa_intv=int(meta["sa_intv"]),
                L2=z["L2"],
                occ_blocks=z["occ_blocks"],
                ssa_blocks=z["ssa_blocks"],
                ssa_vals=z["ssa_vals"],
                ssa_vals_hi=(z["ssa_vals_hi"] if "ssa_vals_hi" in z
                             else np.zeros(len(z["ssa_vals"]), np.uint8)),
                pac_words=z["pac_words"],
                ann=ann,
            )
