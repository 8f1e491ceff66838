"""Batched FM-index primitives on torch tensors: bi-interval extension
(one and two bases) and SA lookup — the subset of bwamem_tpu/ops/fm.py the
SMEM seeding path reaches.

Word arithmetic: the tables hold uint32 words stored as int32. Torch has
no popcount and only partial uint32 support, so every packed word is
widened to int64 and masked to its low 32 bits (`_u32`) before shifts,
and bits are counted with a SWAR popcount. Row/position dtype follows the
JAX twin: int32 on narrow indexes, int64 when `fm.wide`.
"""
from __future__ import annotations

import torch

from ..index.device import DeviceFMIndex

M32 = 0xFFFFFFFF
_M1 = 0x55555555
_NIB = 0x11111111
# occ2 pair-table layout (build_occ2_host: 128 rows/block, pair counts at
# cols 0..15, packed 4-bit pair codes at cols 16..31)
_O2_SHIFT = 7
_O2_MASK = 127
_O2_DATA = 16


def idx_dt(fm: DeviceFMIndex) -> torch.dtype:
    """Row/position dtype for this index: int64 only when needed."""
    return torch.int64 if fm.wide else torch.int32


def _prim(fm):
    return fm.primary.to(idx_dt(fm))


def _L2(fm):
    return fm.L2.to(idx_dt(fm))


def _u32(x):
    """uint32 bits of an int32 tensor as non-negative int64 values."""
    return x.to(torch.int64) & M32


def _not32(x):
    return ~x & M32


def popcount32(x):
    """Set bits of each int64 value in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & _M1)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _prefix_mask(r_w):
    """Mask keeping the top 2*r_w bits of a word, r_w in [0, 16]."""
    sh = (32 - 2 * r_w).clamp(0, 31).to(torch.int64)
    m = (M32 << sh) & M32
    return torch.where(r_w <= 0, torch.zeros_like(m), m)


def _word_masks(r):
    """(P, 4) prefix masks of the 4 packed data words of an occ row: word w
    keeps its first clip(r - 16w, 0, 16) bases."""
    w = torch.arange(4, device=r.device, dtype=torch.int32)[None, :]
    return _prefix_mask((r[:, None] - 16 * w).clamp(0, 16))


def _occ_rows(fm, i):
    """Occ rows + in-block offsets for BWT$ rows i."""
    j = i - (i > _prim(fm)).to(i.dtype)
    rows = fm.occ_blocks[(j >> 6).long()]
    return rows, (j & 63).to(torch.int32)


def _rank1(rows, r, c, dt):
    """Count of code c among the first r bases of each occ row, plus the
    row's checkpoint count of c. rows: (P, 8) int32; r, c: (P,)."""
    u = _u32(rows[:, 4:8])
    pat = (c.to(torch.int64) * _M1)[:, None]
    y = _not32(u ^ pat)
    bits = y & (y >> 1) & _M1 & _word_masks(r)
    pc = popcount32(bits).sum(dim=1)
    base = _u32(rows.gather(1, c.long()[:, None])[:, 0])
    return (base + pc).to(dt)


def _rank4(rows, r, dt):
    """Counts of all 4 codes among the first r bases (+ checkpoints).
    Returns (P, 4)."""
    u = _u32(rows[:, 4:8])[:, None, :]                       # (P, 1, 4)
    pats = (torch.arange(4, device=rows.device, dtype=torch.int64)
            * _M1)[None, :, None]
    y = _not32(u ^ pats)
    bits = y & (y >> 1) & _M1 & _word_masks(r)[:, None, :]
    pc = popcount32(bits).sum(dim=2)
    return (_u32(rows[:, :4]) + pc).to(dt)


def backward_ext_ks_batch(fm: DeviceFMIndex, k, s, c):
    """Backward extension of the k-side interval (prepend base c) over
    (P,) intervals. Returns (k', s')."""
    dt = idx_dt(fm)
    k = k.to(dt)
    s = s.to(dt)
    P = k.shape[0]
    rows, r = _occ_rows(fm, torch.cat([k, k + s]))
    c2 = torch.cat([c, c]).to(torch.int32)
    occ = _rank1(rows, r, c2, dt)
    ok, ol = occ[:P], occ[P:]
    l2c = _L2(fm)[c.long()]
    return l2c + 1 + ok, ol - ok


def forward_ext4_batch(fm: DeviceFMIndex, k, l, s):
    """All four forward extensions (append base b) of (P,) bi-intervals.
    Returns (k4, l4, s4), each (P, 4), index = appended base."""
    dt = idx_dt(fm)
    k = k.to(dt)
    l = l.to(dt)
    s = s.to(dt)
    P = k.shape[0]
    rows, r = _occ_rows(fm, torch.cat([l, l + s]))
    R = _rank4(rows, r, dt)
    ok, ol = R[:P], R[P:]
    cnt = ol - ok                                  # (P, 4) per prepended c
    prim = _prim(fm)
    cnt_sent = ((l <= prim) & (prim < l + s)).to(dt)
    bk4 = _L2(fm)[:4][None, :] + 1 + ok
    # suffix[c] = sum of cnt over codes > c
    suffix = cnt.flip(1).cumsum(1).flip(1).to(dt) - cnt
    bl4 = k[:, None] + cnt_sent[:, None] + suffix
    return bl4.flip(1), bk4.flip(1), cnt.flip(1)


def _nib_masks(r):
    """(P, 16) 4-bit-granular prefix masks of the occ2 data words: word w
    keeps its first clip(r - 8w, 0, 8) nibbles."""
    w = torch.arange(16, device=r.device, dtype=torch.int32)[None, :]
    q = (r[:, None] - 8 * w).clamp(0, 8)
    sh = (32 - 4 * q).clamp(0, 31).to(torch.int64)
    pm = (M32 << sh) & M32
    return torch.where(q <= 0, torch.zeros_like(pm), pm)


def _rank4p(fm, data, counts, r, j, dt):
    """All-4-code single ranks from occ2 pair rows: checkpoint = per-cur
    sums of the 16 pair counts, in-block = low-2-bit nibble matches (the
    4th code's in-block count is r minus the other three). Returns
    ((P, 4) ranks incl. the sentinel-row add-back, (P, 4) in-block
    counts)."""
    pm = _nib_masks(r)
    pcs = []
    for c in range(3):
        y = _not32(data ^ (c * _NIB))
        low2 = y & (y >> 1) & _NIB & pm
        pcs.append(popcount32(low2).sum(dim=1))
    pcs.append(r.to(torch.int64) - pcs[0] - pcs[1] - pcs[2])
    pcs = torch.stack(pcs, dim=1)                             # (P, 4)
    bases = counts.view(-1, 4, 4).sum(dim=1)                  # by cur code
    sa1_j = fm.sa1_scalars[0].to(j.dtype)
    sa1_c = (fm.sa1_scalars[1] & 3).long()
    back_blk = (sa1_j >> _O2_SHIFT) < (j >> _O2_SHIFT)        # (P,)
    four = torch.arange(4, device=r.device)[None, :]
    back = (four == sa1_c) & back_blk[:, None]
    return (bases + pcs + back.to(torch.int64)).to(dt), pcs


def _pair4(fm, data, counts, r, j, c1, pc1_inblk, dt):
    """Pair counts (prev=c', cur=c1) for all four c' from occ2 rows
    (bogus sentinel pair discounted). Returns (P, 4)."""
    pm = _nib_masks(r)
    yc = _not32(data ^ (c1.to(torch.int64) * _NIB)[:, None])
    low2 = yc & (yc >> 1) & _NIB & pm
    sa1_j = fm.sa1_scalars[0].to(j.dtype)
    sa1_pair = fm.sa1_scalars[1].long()
    in_blk = (((j >> _O2_SHIFT) == (sa1_j >> _O2_SHIFT))
              & ((sa1_j & _O2_MASK).to(torch.int32) < r))
    pcs = []
    for cp in range(3):
        yh = _not32(data ^ ((cp << 2) * _NIB))
        all4 = low2 & (yh >> 2) & (yh >> 3)
        pcs.append(popcount32(all4).sum(dim=1))
    pcs.append(pc1_inblk - pcs[0] - pcs[1] - pcs[2])
    cp4 = torch.arange(4, device=r.device)[None, :]
    d = (cp4 << 2) | c1.long()[:, None]                       # (P, 4)
    base = counts.gather(1, d)
    bogus = (d == sa1_pair) & in_blk[:, None]
    return (base + torch.stack(pcs, dim=1) - bogus.to(torch.int64)).to(dt)


def _sel(m, c):
    """m[i, c[i]] for (P, 4) m and (P,) codes."""
    return m.gather(1, c.long()[:, None])[:, 0]


def forward_ext2_batch(fm: DeviceFMIndex, k, l, s, b1, b2):
    """TWO forward extensions (append b1 then b2) from ONE occ2 row gather
    at rows (l, l+s): the second step's 4-way counts are the pair counts
    (prev=c', cur=3-b1) of the same rows. Returns ((k1, l1, s1),
    (k2, l2, s2)), the bi-intervals after one and after both appends."""
    dt = idx_dt(fm)
    P = k.shape[0]
    k = k.to(dt)
    l = l.to(dt)
    s = s.to(dt)
    c1 = 3 - b1.to(torch.int32).clamp(0, 3)
    c2 = 3 - b2.to(torch.int32).clamp(0, 3)
    i2 = torch.cat([l, l + s])
    prim = _prim(fm)
    j = i2 - (i2 > prim).to(dt)
    rows = fm.occ2_blocks[(j >> _O2_SHIFT).long()]
    counts = _u32(rows[:, :16])
    data = _u32(rows[:, 16:])
    r = (j & _O2_MASK).to(torch.int32)
    c1d = torch.cat([c1, c1])
    R4, pcs_raw = _rank4p(fm, data, counts, r, j, dt)          # (2P, 4)
    pc1_inblk = _sel(pcs_raw, c1d)
    P4 = _pair4(fm, data, counts, r, j, c1d, pc1_inblk, dt)    # (2P, 4)
    R4lo, R4hi = R4[:P], R4[P:]
    P4lo, P4hi = P4[:P], P4[P:]
    d4 = R4hi - R4lo
    pd4 = P4hi - P4lo

    four = torch.arange(4, device=k.device, dtype=torch.int32)[None, :]

    def suffsum(m, c):
        return torch.where(four > c[:, None], m, 0).sum(dim=1).to(dt)

    L2c = _L2(fm)
    s1 = _sel(d4, c1)
    l1 = L2c[c1.long()] + 1 + _sel(R4lo, c1)
    sent1 = ((l <= prim) & (prim < l + s)).to(dt)
    k1 = k + sent1 + suffsum(d4, c1)

    s2 = _sel(pd4, c2)
    d12 = (c2 << 2) | c1
    l2 = fm.occ2_start.to(dt)[d12.long()] + _sel(P4lo, c2)
    # sentinel membership of the intermediate interval: the one row whose
    # previous char is the sentinel lies in [l, l+s) and carries cur c1
    sa1_j = fm.sa1_scalars[0].to(dt)
    r1row = sa1_j + (sa1_j >= prim).to(dt)
    sent2 = ((l <= r1row) & (r1row < l + s)
             & ((fm.sa1_scalars[1] & 3).to(torch.int32) == c1)).to(dt)
    k2 = k1 + sent2 + suffsum(pd4, c2)
    return (k1, l1, s1), (k2, l2, s2)


def _ssa_bits(ssa_row, off):
    """(is_sampled_bit, rank_before_row) from a padded SSA bitmap row
    [rank_before, bits_lo, bits_hi, ...]."""
    rank0 = ssa_row[:, 0].to(torch.int64)
    lo = _u32(ssa_row[:, 1])
    hi = _u32(ssa_row[:, 2])
    off = off.to(torch.int64)
    word = torch.where(off < 32, lo, hi)
    bit = (word >> (off & 31)) & 1
    below_lo = torch.where(off >= 32, lo, lo & ((1 << off.clamp(0, 31)) - 1))
    below_hi = torch.where(
        off > 32, hi & ((1 << (off - 32).clamp(0, 31)) - 1),
        torch.zeros_like(hi))
    rank = rank0 + popcount32(below_lo) + popcount32(below_hi)
    return bit, rank


def _ssa_combine(fm: DeviceFMIndex, rank, step):
    """Sampled-SA value: uint32 low word + uint8 upper bits + walk steps."""
    dt = idx_dt(fm)
    lo = _u32(fm.ssa_vals[rank])
    if fm.wide:
        lo = (fm.ssa_vals_hi[rank].to(torch.int64) << 32) | lo
    return (lo + step).to(dt)


def sa_lookup_batch(fm: DeviceFMIndex, rows):
    """Batched SA$ lookup over (P,) rows: an LF walk of at most sa_intv
    steps to a text-position-sampled row (the index samples by text
    position, so one is always reached)."""
    P = rows.shape[0]
    dt = idx_dt(fm)
    r = rows.to(dt)
    prim = _prim(fm)
    L2c = _L2(fm)
    rank_hit = torch.zeros(P, dtype=torch.int64, device=r.device)
    step_hit = torch.zeros(P, dtype=torch.int64, device=r.device)
    done = torch.zeros(P, dtype=torch.bool, device=r.device)
    for step in range(fm.sa_intv):
        ssa_row = fm.occ_blocks[(fm.n_occ_blocks + (r >> 6)).long()]
        bit, rank = _ssa_bits(ssa_row, r & 63)
        hit = (bit == 1) & ~done
        rank_hit = torch.where(hit, rank, rank_hit)
        step_hit = torch.where(hit, step, step_hit)
        done = done | hit
        # LF: BWT char of row r, then its rank
        occ_row, rr = _occ_rows(fm, r)
        w = _u32(occ_row.gather(1, (4 + (rr >> 4)).long()[:, None])[:, 0])
        c = ((w >> (30 - 2 * (rr & 15)).to(torch.int64)) & 3).to(torch.int32)
        dest = L2c[c.long()] + 1 + _rank1(occ_row, rr, c, dt)
        dest = torch.where(r == prim, torch.zeros_like(dest), dest)
        r = torch.where(done, r, dest)
    return _ssa_combine(fm, rank_hit, step_hit)
