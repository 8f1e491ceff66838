"""Device-resident FMD index (a dataclass of torch tensors) + transfer from
the host format.

Same fields and dtypes as the JAX twin (bwamem_tpu/index/device.py): the
uint32 host tables are reinterpreted bit for bit as int32; L2 and the
position scalars are int64. `build_occ2_host` is the JAX package's numpy
builder, copied as is.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .format import FMIndex

# occ2 (dinucleotide) table is built only for genomes small enough that the
# 128 B/64-row table fits comfortably next to everything else in device
# memory (~2 B/base). Wide (>2^31-row) genomes keep the single-step walk.
OCC2_MAX_SEQ_LEN = 1 << 30


def _unpack_bwt(occ_blocks: np.ndarray, seq_len: int) -> np.ndarray:
    """Sentinel-free BWT codes (0..3) from the packed occ table."""
    words = occ_blocks[:, 4:].reshape(-1).astype(np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))[None, :]
    bases = ((words[:, None] >> shifts) & 3).astype(np.uint8)
    return bases.reshape(-1)[:seq_len]


def _pack_4bit_u32(codes: np.ndarray) -> np.ndarray:
    """Pack 0..15 codes, 8/word, code p at bits 28-4*(p%8) (pad = 0)."""
    n_words = (len(codes) + 7) // 8
    padded = np.zeros(n_words * 8, np.uint32)
    padded[: len(codes)] = codes
    shifts = (28 - 4 * np.arange(8, dtype=np.uint32))[None, :]
    return (padded.reshape(n_words, 8) << shifts).sum(
        axis=1, dtype=np.uint32)


OCC2_BLOCK_BASES = 128  # BWT rows per pair-table checkpoint row


def build_occ2_host(idx: FMIndex):
    """Dinucleotide (pair) checkpoint table: per 128 BWT rows one 32-word
    row
      [0:16]  occ2 checkpoint counts of pair code d = prev*4 + cur
      [16:32] packed 4-BIT PAIR CODES (prev*4 + cur), 8 rows/word —
              one nibble holds both the BWT char (low 2 bits) and the
              previous text char (high 2 bits), so pair rank AND
              single-code rank come from the same match chain
    plus scalars: start2 (16,) first row of each 2-base prefix block,
    (sa1_j, sa1_pair) identifying the single row whose previous char is
    the sentinel (its packed BWT2 slot holds a bogus 0 that pair-rank
    queries must discount; single-code ranks derived from the pair
    counts must add it back).

    Single-code occ is recovered as sum_prev occ2[prev*4+cur] (+ the sa1
    correction), so this one table serves both the 2-step and 1-step
    queries at 1 byte/base. It halves the trip count of the forward SMEM
    walk.
    """
    n = idx.seq_len
    primary = idx.primary
    L2 = idx.L2.astype(np.int64)
    B = _unpack_bwt(idx.occ_blocks, n)

    # rank of each row's own char among earlier rows (sentinel-free)
    rank_own = np.empty(n, np.int64)
    for c in range(4):
        m = B == c
        rank_own[m] = np.arange(m.sum(), dtype=np.int64)
    # LF in BWT$ space: row of suffix one position earlier
    lf = L2[B] + 1 + rank_own
    # BWT2: previous text char = BWT[LF(row)]; LF(row)==primary means the
    # previous char is the sentinel (exactly one such row: SA$[row] == 1)
    sa1 = lf == primary
    lf_j = lf - (lf > primary)
    B2 = B[np.clip(lf_j, 0, n - 1)]
    B2[sa1] = 0  # bogus; discounted via (sa1_j, sa1_pair)
    (sa1_j,) = np.flatnonzero(sa1)
    pair = (B2.astype(np.int64) << 2) | B
    sa1_pair = int(pair[sa1_j])

    nb = OCC2_BLOCK_BASES
    n_blocks = (n + nb - 1) // nb + 1  # terminal block for end queries
    pair_pad = np.full(n_blocks * nb, 16, np.int64)
    pair_pad[:n] = pair
    pair_pad[sa1_j] = 16  # true counts exclude the bogus pair
    one_hot = (pair_pad.reshape(n_blocks, nb)[:, :, None]
               == np.arange(16)[None, None, :])
    per_block = one_hot.sum(axis=1).astype(np.int64)
    cum = np.zeros((n_blocks, 16), np.int64)
    cum[1:] = np.cumsum(per_block, axis=0)[:-1]

    occ2 = np.zeros((n_blocks, 32), np.uint32)
    occ2[:, :16] = cum.astype(np.uint32)
    nib_pad = np.zeros(n_blocks * nb, np.uint8)
    nib_pad[:n] = pair  # incl. the bogus (0, cur) nibble at sa1_j
    occ2[:, 16:32] = _pack_4bit_u32(nib_pad).reshape(n_blocks, 16)

    # start2[d]: first BWT$ row whose suffix begins with the 2-base
    # prefix d = c1*4+c2 (rows [start2[d], start2[d+1]) modulo the
    # interleaved 1-base-only suffixes, which sort before their block)
    total = per_block.sum(axis=0)  # global pair counts == text dinucs
    t_last = int(B[0])  # BWT$[0] = T[n-1]
    start2 = np.empty(16, np.int64)
    for c1 in range(4):
        base = L2[c1] + 1 + (1 if t_last == c1 else 0)
        for c2 in range(4):
            start2[c1 * 4 + c2] = base
            base += total[c1 * 4 + c2]
    # full bi-intervals of every 2-base pattern (the 2-step forward
    # walk's restart path): pattern (b1,b2) has k = start2[b1*4+b2],
    # s = total[b1*4+b2], and l = the k of its reverse complement
    d = np.arange(16)
    rc = ((3 - (d & 3)) << 2) | (3 - (d >> 2))
    pat2 = np.stack([start2, start2[rc], total])  # (3, 16) int64
    return occ2, start2, pat2, int(sa1_j), sa1_pair


# fields that are plain Python values, not tensors
_STATIC = ("sa_intv", "wide", "has_occ2")


@dataclass(frozen=True)
class DeviceFMIndex:
    occ_blocks: torch.Tensor    # (n_blocks + n_sblocks, 8) int32 —
    #   rows [0, n_occ): occ checkpoints + packed bases;
    #   rows [n_occ, ..): sampled-SA bitmap blocks padded to width 8
    L2: torch.Tensor            # (5,) int64 (counts can exceed 2^31)
    n_occ_blocks: torch.Tensor  # () int32 — offset of the SSA rows
    ssa_vals: torch.Tensor      # (n_sampled,) int32 (uint32 low words)
    ssa_vals_hi: torch.Tensor   # (n_sampled,) uint8 (bits >= 32)
    pac_words: torch.Tensor     # (ceil(l_pac/16),) int32
    primary: torch.Tensor       # () int64
    seq_len: torch.Tensor       # () int64
    l_pac: torch.Tensor         # () int64
    # dinucleotide (2-step) FM tables — empty placeholders when disabled;
    # 32-word rows per 128 BWT rows (see build_occ2_host)
    occ2_blocks: torch.Tensor   # (n2, 32) int32
    occ2_start: torch.Tensor    # (16,) int64 — start2 table
    occ2_pat: torch.Tensor      # (3, 16) int64 — 2-mer (k, l, s)
    sa1_scalars: torch.Tensor   # (2,) int32 — (sa1_j, sa1_pair)
    sa_intv: int = 8
    # rows/positions are int64 only when the genome needs >31 bits
    wide: bool = False
    # switch for the 2-step (dinucleotide) forward walk
    has_occ2: bool = False

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "DeviceFMIndex":
        """Build from a dict of numpy arrays keyed by field name (the three
        static fields as Python scalars) — e.g. the JAX twin's state
        carried across as np.asarray(field)."""
        kw = {}
        for f in fields(cls):
            v = arrays[f.name]
            if f.name in _STATIC:
                kw[f.name] = type(f.default)(np.asarray(v).item())
            else:
                kw[f.name] = torch.from_numpy(np.array(v)).to(device)
        return cls(**kw)

    def to_numpy(self) -> dict:
        """Inverse of from_numpy."""
        return {f.name: (getattr(self, f.name) if f.name in _STATIC
                         else getattr(self, f.name).cpu().numpy())
                for f in fields(self)}

    @classmethod
    def from_host(cls, idx: FMIndex, device,
                  occ2: bool | None = None) -> "DeviceFMIndex":
        occ = idx.occ_blocks.view(np.int32)
        ssa = idx.ssa_blocks.view(np.int32)
        ssa8 = np.zeros((ssa.shape[0], 8), np.int32)
        ssa8[:, : ssa.shape[1]] = ssa
        hi = (idx.ssa_vals_hi if idx.ssa_vals_hi is not None
              else np.zeros(len(idx.ssa_vals), np.uint8))
        if occ2 is None:
            occ2 = idx.seq_len <= OCC2_MAX_SEQ_LEN
        if occ2:
            o2, start2, pat2, sa1_j, sa1_pair = build_occ2_host(idx)
            arrays = dict(occ2_blocks=o2.view(np.int32),
                          occ2_start=start2, occ2_pat=pat2,
                          sa1_scalars=np.asarray([sa1_j, sa1_pair],
                                                 np.int32))
        else:
            arrays = dict(occ2_blocks=np.zeros((0, 32), np.int32),
                          occ2_start=np.zeros((16,), np.int64),
                          occ2_pat=np.zeros((3, 16), np.int64),
                          sa1_scalars=np.zeros((2,), np.int32))
        arrays.update(
            occ_blocks=np.concatenate([occ, ssa8], axis=0),
            L2=idx.L2.astype(np.int64),
            n_occ_blocks=np.asarray(occ.shape[0], np.int32),
            ssa_vals=idx.ssa_vals.view(np.int32),
            ssa_vals_hi=np.asarray(hi, np.uint8),
            pac_words=idx.pac_words.view(np.int32),
            primary=np.asarray(idx.primary, np.int64),
            seq_len=np.asarray(idx.seq_len, np.int64),
            l_pac=np.asarray(idx.l_pac, np.int64),
            sa_intv=int(idx.sa_intv),
            wide=bool(idx.seq_len + 2 >= (1 << 31)),
            has_occ2=bool(occ2),
        )
        return cls.from_numpy(arrays, device)
