"""Shifted-Hamming-Distance seed pre-filter (-F), in torch.

Port of bwamem_tpu/ops/shd.py (reference: src/vector_filter.cpp:294-370
bit_vec_filter_m128_sse1; gated by -F via mem_shd_flt_chained_seeds,
src/bwamem.c:809-969). The reference packs 128 bases into two 1-bit
planes and ANDs XOR masks across read/ref shifts of 0..max_error,
bridging short zero-runs ("speculative removal"). Here the (batch,
window) plane is a bool tensor, shifts are column slices, and the whole
filter is a handful of elementwise ops and one reduction over every flank
window of a chunk at once. It has no hand-written kernel: the JAX package
leaves it to XLA, and plain torch ops are its counterpart.

Semantics: a position participates only when both windows cover it
(pos < len); shifted terms additionally require pos >= shift. A window
pair passes when the AND-accumulated, zero-run-bridged mismatch mask has
<= max_error set positions.
"""
from __future__ import annotations

import torch


def _shift(x, k):
    """x shifted so position i sees x[i + k]; out of range reads False."""
    if k == 0:
        return x
    out = torch.zeros_like(x)
    if k > 0:
        out[:, :-k] = x[:, k:]
    else:
        out[:, -k:] = x[:, :k]
    return out


def _bridge_false_zeros(d, m):
    """Flip 0-runs of length <= 2 that are flanked by 1s (the reference's
    flip_false_zero, src/vector_filter.cpp:224-292), within mask m."""
    one_l = _shift(d, -1)                  # d[i-1]
    b1 = one_l & _shift(d, 1)              # 1 0 1
    b2 = one_l & _shift(d, 2)              # 1 0 0 1 -> covers d[i], d[i+1]
    b2 = b2 | _shift(b2, -1)
    return d | ((b1 | b2) & m)


def shd_filter_batch(read_w, ref_w, lens, max_error: int = 7):
    """read_w, ref_w: (N, W) integer base codes (0..3; 4/N treated as A,
    as the reference's converter does for non-ACGT bytes); lens: (N,)
    shared valid length. Returns (N,) bool pass flags."""
    N, W = read_w.shape
    read_w = read_w.to(torch.int32)
    ref_w = ref_w.to(torch.int32)
    r0, r1 = (read_w & 1).bool(), ((read_w >> 1) & 1).bool()
    f0, f1 = (ref_w & 1).bool(), ((ref_w >> 1) & 1).bool()
    pos = torch.arange(W, device=read_w.device)[None, :]
    valid = pos < lens.to(read_w.device)[:, None]

    def diff(a0, a1, b0, b1, shift):
        """(a shifted right by `shift`) vs b: position i compares
        a[i-shift] with b[i]."""
        a0, a1 = _shift(a0, -shift), _shift(a1, -shift)
        d = (a0 ^ b0) | (a1 ^ b1)
        m = valid if not shift else valid & (pos >= shift)
        return d & m, m

    acc, m0 = diff(r0, r1, f0, f1, 0)
    acc = _bridge_false_zeros(acc, m0)
    for j in range(1, max_error + 1):
        d, m = diff(r0, r1, f0, f1, j)          # read shifted right
        acc = acc & _bridge_false_zeros(d, m)
        d, m = diff(f0, f1, r0, r1, j)          # ref shifted right
        acc = acc & _bridge_false_zeros(d, m)
    return acc.sum(dim=1) <= max_error
