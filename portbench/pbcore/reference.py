"""The plain reference that decides `correct`: NumPy only, and nothing of
the program. It starts from the genome FASTA and the reads the harness
made, and judges the SAM records the timed window produced for a sample
of reads drawn from the run's seed.

Numbers it reads (each held to a limit of its own in the cell's traffic
file, `limits`):

- `records_wrong`: sampled reads whose primary record is missing or
  doubled, or does not give back the read (SEQ, QUAL and the pair flags
  0x1/0x40/0x80).
- `tags_wrong`: mapped records of sampled reads (primary and
  supplementary) whose AS, NM or MD disagree with their POS and CIGAR on
  the genome under the configuration's scoring.
- `below_locus_best`: mapped primaries below the best alignment of the
  read in a window around its reported locus, by the reference's own
  affine-gap DP, on both of bwa's rules: the clip-penalised score (AS
  less the clipping penalty for each soft-clipped end, which seed
  extension maximises) and the raw local score (which mate rescue's
  local Smith-Waterman maximises). A record below on both counts.
- `below_truth`: the same against the locus the read was simulated from
  (an unmapped primary counts where the best raw score there reaches the
  minimum score `-T`). Seeding misses, lost rescues and wrong extensions
  show here.
- `mate_fields_wrong` (pairs): records whose RNEXT, PNEXT, TLEN, 0x20 or
  0x8 disagree with their mate's record (bwa's mem_aln2sam rules).
- `rescue_missed` (pairs with unseedable mates): of every unseedable mate
  the window produced, those whose primary record is wrong, or unmapped,
  or below the best at their origin as for `below_truth`: what mate
  rescue alone has to place.

Reads whose windows touch an N of the genome are not judged (`skipped`):
the index replaces N with random bases that only the program knows.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

NEG = -(1 << 28)
WALL = 5            # target code outside the contig
PAD = 24            # window slack on each side of a locus
_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")
_COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)
_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i


@dataclass
class Rec:
    flag: int
    rname: bytes
    pos: int             # 1-based, 0 when unmapped without a mate's place
    cigar: list          # [(len, op)]
    rnext: bytes
    pnext: int
    tlen: int
    seq: bytes
    qual: bytes
    tags: dict


def parse(line: bytes) -> Rec:
    f = line.rstrip(b"\n").split(b"\t")
    tags = {}
    for t in f[11:]:
        k, _, v = t.split(b":", 2)
        tags[k.decode()] = v
    cig = [] if f[5] == b"*" else [(int(n), op[0]) for n, op
                                    in _CIGAR.findall(f[5])]
    return Rec(int(f[1]), f[2], int(f[3]), cig, f[6], int(f[7]), int(f[8]),
               f[9], f[10], tags)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[::-1]]


def matrix(sc: dict) -> np.ndarray:
    """6 x 6 score matrix over query x target codes (4 = N, 5 = wall)."""
    m = np.full((6, 6), -int(sc["mismatch"]), np.int32)
    m[np.arange(4), np.arange(4)] = int(sc["match"])
    m[4, :] = m[:, 4] = -int(sc["ambiguous"])
    m[:, WALL] = NEG
    return m


def best_penalised(q: np.ndarray, t: np.ndarray, sc: dict,
                   cell_bits: int | None = None) -> np.ndarray:
    """For each row: the best over local alignments of query q[k] (whole
    query, codes 0..4) to target t[k] (codes 0..5) of raw score less the
    clipping penalty for each query end left out, with affine gaps (a gap
    of l bases costs gap_open + l * gap_ext). Row by row over the query,
    vectorised over reads and target columns; the run of deletions along
    a row is a prefix maximum. With `cell_bits`, every cell saturates to
    that many signed bits (the control)."""
    n, L = q.shape
    W = t.shape[1]
    mat = matrix(sc)
    go, ge, clip = int(sc["gap_open"]), int(sc["gap_ext"]), int(sc["clip"])
    lo, hi = ((-(1 << (cell_bits - 1)), (1 << (cell_bits - 1)) - 1)
              if cell_bits else (NEG, -NEG))
    ramp = ge * np.arange(W, dtype=np.int64)[None, :]
    neg_col = np.full((n, 1), NEG, np.int64)
    h_prev = np.full((n, W), NEG, np.int64)
    f_prev = np.full((n, W), NEG, np.int64)
    best = np.full(n, NEG, np.int64)
    for i in range(L):
        s = mat[q[:, i][:, None], t].astype(np.int64)
        diag = np.concatenate([neg_col, h_prev[:, :-1]], axis=1)
        hm = s + np.maximum(diag, 0 if i == 0 else -clip)
        f = np.maximum(h_prev - go - ge, f_prev - ge)
        g = np.maximum(hm, f)
        if cell_bits:
            hm = np.clip(hm, lo, hi)
            g = np.clip(g, lo, hi)
            f = np.clip(f, lo, hi)
        run = np.maximum.accumulate(g + ramp, axis=1)
        e = np.concatenate([neg_col, run[:, :-1]], axis=1) - go - ramp
        h = np.maximum(g, e)
        if cell_bits:
            h = np.clip(h, lo, hi)
        best = np.maximum(best, hm.max(axis=1) - (clip if i < L - 1 else 0))
        h_prev, f_prev = h, f
    if cell_bits:
        best = np.clip(best, lo, hi)
    return best


def windows(genome, contig: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """(n, W) target codes of [lo, hi) in each contig (WALL outside it)
    and whether a window holds an N."""
    w = int((hi - lo).max())
    k = lo[:, None] + np.arange(w)[None, :]
    inside = (k >= 0) & (k < genome.lens[contig][:, None]) & (
        k < hi[:, None])
    gpos = np.clip(k, 0, genome.lens[contig][:, None] - 1) + \
        genome.starts[contig][:, None]
    t = np.where(inside, genome.codes[gpos], WALL).astype(np.uint8)
    has_n = ((t == 4) & inside).any(axis=1)
    return t, has_n


def _ref_span(cigar) -> int:
    return sum(n for n, op in cigar if op in b"MD=XN")


def _clips(cigar) -> tuple[int, int]:
    a = cigar[0][0] if cigar and cigar[0][1] in b"SH" else 0
    b = cigar[-1][0] if len(cigar) > 1 and cigar[-1][1] in b"SH" else 0
    return a, b


def _soft_ends(cigar) -> int:
    return int(bool(cigar) and cigar[0][1] == ord("S")) + int(
        len(cigar) > 1 and cigar[-1][1] == ord("S"))


def tags_of(rec: Rec, ref: np.ndarray, sc: dict):
    """(AS, NM, MD) that POS and CIGAR give on ref (the aligned span's
    codes), bwa's bwa_gen_cigar2 rules; None when the span holds an N."""
    if (ref >= 4).any():
        return None
    query = _LUT[np.frombuffer(rec.seq, np.uint8)]
    x = y = u = 0
    md, nm, score = [], 0, 0
    a, b = int(sc["match"]), int(sc["mismatch"])
    go, ge = int(sc["gap_open"]), int(sc["gap_ext"])
    for n, op in rec.cigar:
        if op == ord("M"):
            qs, rs = query[x:x + n], ref[y:y + n]
            diff = np.flatnonzero(qs != rs)
            amb = (qs[diff] >= 4).sum()
            score += a * (n - len(diff)) - b * (len(diff) - amb) - amb
            last = -1
            for d in diff:
                md.append(f"{u + d - last - 1}{'ACGTN'[rs[d]]}")
                u, last = 0, d
            u += n - 1 - last
            nm += len(diff)
            x += n
            y += n
        elif op == ord("I"):
            nm += n
            score -= go + ge * n
            x += n
        elif op == ord("D"):
            md.append(f"{u}^" + "".join("ACGTN"[c] for c in ref[y:y + n]))
            u = 0
            nm += n
            score -= go + ge * n
            y += n
        elif op == ord("S"):
            x += n
    md.append(str(u))
    return score, nm, "".join(md)


def _tlen(r: Rec, m: Rec) -> int:
    """bwa mem_aln2sam's TLEN of r against its mate m."""
    p0 = r.pos - 1 + (_ref_span(r.cigar) - 1 if r.flag & 16 else 0)
    p1 = m.pos - 1 + (_ref_span(m.cigar) - 1 if m.flag & 16 else 0)
    return -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))


def mate_fields_ok(r: Rec, m: Rec) -> bool:
    if bool(r.flag & 0x20) != bool(m.flag & 0x10):
        return False
    if bool(r.flag & 0x8) != bool(m.flag & 0x4):
        return False
    if m.rname == b"*":
        return r.rnext == b"*" and r.pnext == 0 and r.tlen == 0
    if r.rnext != (b"=" if m.rname == r.rname else m.rname):
        return False
    if r.pnext != m.pos:
        return False
    mapped_both = not (r.flag & 4) and not (m.flag & 4)
    if mapped_both and r.rname == m.rname:
        return r.tlen == _tlen(r, m)
    return r.tlen == 0


@dataclass
class Sample:
    """The judged reads: for each, its codes in read orientation, its
    truth (contig, source interval, strand), and its SAM lines."""
    codes: np.ndarray
    contig: np.ndarray
    src_lo: np.ndarray
    strand: np.ndarray
    mate: np.ndarray      # 0 for SE, 1 / 2 for read 1 / 2 of a pair
    lines: list           # list[list[bytes]] per read
    qual_char: str


def judge(genome, s: Sample, sc: dict, replace_as=None,
          pairs: bool = True) -> dict:
    """The readings of a sample. `replace_as` serves the control: it sets
    each mapped primary's AS before anything is judged. With `pairs`, a
    paired sample holds whole pairs in mate order and their mate fields
    are judged."""
    n, L = s.codes.shape
    out = dict(checked=n, records_wrong=0, tags_wrong=0, below_locus_best=0,
               below_truth=0, skipped=0)
    prim: list[Rec | None] = []
    recs_of = []
    for k in range(n):
        recs = [parse(x) for x in s.lines[k]]
        ps = [r for r in recs if not r.flag & 0x900]
        p = ps[0] if len(ps) == 1 else None
        if p is not None:
            fwd = s.codes[k] if not p.flag & 16 else revcomp(s.codes[k])
            qual = s.qual_char.encode() * L
            want = (0x1 | (0x40 if s.mate[k] == 1 else 0x80)) if s.mate[k] \
                else 0
            if (p.seq != bytes(np.frombuffer(b"ACGTN", np.uint8)[fwd])
                    or p.qual != qual or (p.flag & 0xC1) != want):
                p = None
        if p is None:
            out["records_wrong"] += 1
        prim.append(p)
        recs_of.append(recs)
    if replace_as is not None:
        replace_as(prim)
    for k in range(n):
        for r in recs_of[k]:
            p = prim[k]
            if r.flag & 4 or p is None:
                continue
            ci = genome.names.index(r.rname.decode())
            a = genome.starts[ci] + r.pos - 1
            ref = genome.codes[a:a + _ref_span(r.cigar)]
            got = tags_of(r, ref, sc)
            if got is None:
                continue
            as_, nm, md = got
            if (int(r.tags.get("AS", b"-1")) != as_
                    or int(r.tags.get("NM", b"-1")) != nm
                    or r.tags.get("MD", b"").decode() != md):
                out["tags_wrong"] += 1
    # the DP windows: the simulated origin of every read, and the
    # reported locus of every mapped primary
    m = L + 16
    t_lo = s.src_lo - PAD
    t_hi = s.src_lo + m + PAD
    tt, tn = windows(genome, s.contig, t_lo, t_hi)
    tq = np.where(s.strand[:, None] == 1,
                  np.stack([revcomp(c) for c in s.codes]), s.codes)
    local = {**sc, "clip": 0}
    truth = best_penalised(tq, tt, sc)
    truth_raw = best_penalised(tq, tt, local)
    mapped = [k for k in range(n) if prim[k] is not None
              and not prim[k].flag & 4]
    loc = np.full(n, NEG, np.int64)
    loc_raw = np.full(n, NEG, np.int64)
    ln = np.zeros(n, bool)
    if mapped:
        ci = np.array([genome.names.index(prim[k].rname.decode())
                       for k in mapped])
        lo = np.array([prim[k].pos - 1 - _clips(prim[k].cigar)[0] - PAD
                       for k in mapped])
        hi = np.array([prim[k].pos - 1 + _ref_span(prim[k].cigar)
                       + _clips(prim[k].cigar)[1] + PAD for k in mapped])
        lt, lnn = windows(genome, ci, lo, hi)
        lq = np.stack([s.codes[k] if not prim[k].flag & 16
                       else revcomp(s.codes[k]) for k in mapped])
        loc[mapped] = best_penalised(lq, lt, sc)
        loc_raw[mapped] = best_penalised(lq, lt, local)
        ln[mapped] = lnn
    t_min = int(sc["min_score"])
    examples: list[str] = []
    for k in range(n):
        p = prim[k]
        if p is None:
            continue
        if tn[k] or ln[k]:
            out["skipped"] += 1
            continue
        if p.flag & 4:
            out["below_truth"] += int(truth_raw[k] >= t_min)
            if truth_raw[k] >= t_min and len(examples) < 8:
                examples.append(f"read {k} mate {int(s.mate[k])} unmapped; "
                                f"truth best {int(truth_raw[k])}")
            continue
        raw = int(p.tags["AS"])
        pen = raw - int(sc["clip"]) * _soft_ends(p.cigar)
        below = (loc[k] > pen and loc_raw[k] > raw,
                 truth[k] > pen and truth_raw[k] > raw)
        out["below_locus_best"] += int(below[0])
        out["below_truth"] += int(below[1])
        if any(below) and len(examples) < 8:
            examples.append(
                f"read {k} mate {int(s.mate[k])} truth {genome.names[s.contig[k]]}"
                f":{int(s.src_lo[k]) + 1}{'+-'[int(s.strand[k])]} best "
                f"{int(truth[k])}/{int(truth_raw[k])} locus best "
                f"{int(loc[k])}/{int(loc_raw[k])} program {pen}/{raw}: "
                + s.lines[k][0][:60].decode(errors="replace").replace(
                    "\t", " ") + " "
                + " ".join(f"{a}:{b.decode()[:40]}" for a, b in p.tags.items()))
    if pairs and s.mate.any():
        bad = 0
        for k in range(0, n, 2):
            a, b = prim[k], prim[k + 1]
            if a is None or b is None:
                continue
            bad += (not mate_fields_ok(a, b)) + (not mate_fields_ok(b, a))
        out["mate_fields_wrong"] = bad
    out["examples"] = examples
    return out


def rescue_missed(genome, s: Sample, sc: dict) -> tuple[int, dict]:
    """(`rescue_missed`, the readings it comes from) of a sample of
    unseedable mates, without their mates."""
    r = judge(genome, s, sc, pairs=False)
    return r["records_wrong"] + r["below_truth"], r


def control_as(genome, s: Sample, sc: dict, bits: int):
    """The control's replace_as: each mapped primary's AS becomes the
    reference DP's best at its locus on cells of `bits` bits, with the
    clipping penalty of the record's clipped ends added back."""
    n = s.codes.shape[0]

    def put(prim):
        mapped = [k for k in range(n) if prim[k] is not None
                  and not prim[k].flag & 4]
        if not mapped:
            return
        ci = np.array([genome.names.index(prim[k].rname.decode())
                       for k in mapped])
        lo = np.array([prim[k].pos - 1 - _clips(prim[k].cigar)[0] - PAD
                       for k in mapped])
        hi = np.array([prim[k].pos - 1 + _ref_span(prim[k].cigar)
                       + _clips(prim[k].cigar)[1] + PAD for k in mapped])
        lt, _ = windows(genome, ci, lo, hi)
        lq = np.stack([s.codes[k] if not prim[k].flag & 16
                       else revcomp(s.codes[k]) for k in mapped])
        low = best_penalised(lq, lt, sc, bits)
        for k, v in zip(mapped, low):
            prim[k].tags["AS"] = str(int(v) + int(sc["clip"])
                                     * _soft_ends(prim[k].cigar)).encode()
    return put
