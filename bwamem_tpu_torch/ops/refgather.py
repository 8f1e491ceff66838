"""Device-side window gathers from packed 2-bit word tables (the packed
genome, or reads packed on the fly).

Positions in doubled (fwd+rev) coordinates index pac_words; reverse-strand
positions map to complemented forward bases. Words are uint32 values held
in int64 tensors (see ops/fm.py).
"""
from __future__ import annotations

import torch

from ..index.device import DeviceFMIndex
from .fm import M32, _u32, idx_dt


def _extract_words_ascending(words, f0, length: int):
    """Base codes of windows [f0, f0+length) over a packed 2-bit word
    table `words` (int64 values < 2^32; base j of word w at bit shift
    30 - 2*(j & 15)). Out-of-range positions yield garbage — callers
    mask."""
    N = f0.shape[0]
    W = length // 16 + 2
    w0 = f0 >> 4
    a0 = (f0 & 15).to(torch.int64)
    widx = (w0[:, None] + torch.arange(W, device=f0.device)[None, :]).clamp(
        0, words.shape[0] - 1)
    w = words[widx]                                           # (N, W)
    sh = (2 * a0)[:, None]
    lo = (w << sh) & M32
    hi = torch.where(sh > 0, w >> (32 - sh).clamp(max=31),
                     torch.zeros_like(w))
    comb = lo | torch.cat([hi[:, 1:], torch.zeros_like(hi[:, :1])], dim=1)
    rep = comb.repeat_interleave(16, dim=1)[:, :length]       # (N, length)
    t = torch.arange(length, device=f0.device, dtype=torch.int64)[None, :]
    return ((rep >> (30 - 2 * (t & 15))) & 3).to(torch.int32)


def pack_codes_2bit(codes):
    """Pack (B, L) codes into the extractor's word layout. Returns
    (words, nplane): (B, ceil(L/16)) int64 words each — 2-bit base codes
    (N/pad packed as 0) and a parallel 2-bit N/pad-flag plane."""
    B, L = codes.shape
    Wr = -(-L // 16)
    c = torch.full((B, Wr * 16), 4, dtype=torch.int64, device=codes.device)
    c[:, :L] = codes
    is_n = (c >= 4) | (c < 0)
    sh = (30 - 2 * torch.arange(16, device=codes.device,
                                dtype=torch.int64))[None, None, :]
    b2 = torch.where(is_n, 0, c).view(B, Wr, 16)
    words = (b2 << sh).sum(dim=2)
    nplane = (is_n.to(torch.int64).view(B, Wr, 16) << sh).sum(dim=2)
    return words, nplane


def gather_window_fast(fm: DeviceFMIndex, start, length: int):
    """Ascending doubled-coordinate windows [start, start+length) with
    per-position strand mapping, built from two contiguous pac fetches
    (forward part + complemented reverse part). Positions outside
    [0, 2*l_pac) -> 4."""
    dt = idx_dt(fm)
    lp = fm.l_pac.to(dt)
    start = start.to(dt)
    words = _u32(fm.pac_words)
    offs = torch.arange(length, device=start.device, dtype=dt)[None, :]
    pos = start[:, None] + offs
    fwd = _extract_words_ascending(words, start, length)
    # reverse part: positions p >= l_pac read fpos = 2lp-1-p, which is an
    # ascending pac run when traversed from the window's END
    r0 = (2 * lp - length) - start
    rev = 3 - _extract_words_ascending(words, r0, length).flip(1)
    out = torch.where(pos < lp, fwd, rev)
    valid = (pos >= 0) & (pos < 2 * lp)
    return torch.where(valid, out, 4)
