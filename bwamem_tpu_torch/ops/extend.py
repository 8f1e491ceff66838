"""Batched seed extension — ksw_extend2 semantics (the contract of the
reference's decoy_cpu_align -> ksw_extend2): one-sided affine-gap
extension seeded with h0, reporting the best local cell, the best
to-query-end cell and max_off. The DP itself is the dense kernel in
ops/kernels/extend_kernel.py or, for a band narrower than the query, the
banded kernel in ops/kernels/extend_banded.py; this module holds their
parameters, the dispatch, the descriptor window gathers that feed them
and the local-vs-end choice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.device import DeviceFMIndex
from .kernels import extend_banded, extend_kernel
from .refgather import (_extract_words_ascending, gather_window_fast,
                        pack_codes_2bit)


@dataclass(frozen=True)
class ExtendParams:
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    w: int = 300          # band width (fork default)
    zdrop: int = 0        # fork default: disabled
    end_bonus: int = 5    # = pen_clip (used in the w clamp)
    opt_ext: bool = True  # apply the band inside the DP loop
    max_mat: int = 1      # match score a / max matrix entry (w clamp)


def make_score_matrix(a: int = 1, b: int = 4) -> np.ndarray:
    """5x5 matrix: +a match, -b mismatch, -1 vs N
    (equivalent of bwa_fill_scmat, reference src/bwa.c:99)."""
    mat = np.full((5, 5), -b, dtype=np.int32)
    np.fill_diagonal(mat, a)
    mat[4, :] = -1
    mat[:, 4] = -1
    return mat


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def extend_batch_auto(query, target, qlen, tlen, h0, mat, params):
    """Extension dispatch. CUDA tensors take the banded kernel K3 by the
    JAX twin's rule (bwamem_tpu/ops/extend.py extend_batch_auto): opt_ext
    with a band window round128(2w+3) narrower than the dense row
    round128(QMAX+1) — long reads under --vanilla — as long as the window
    fits K3 (at most 1024 lanes, w <= 509) and the query its shared
    memory (QMAX <= extend_banded.qmax_limit(w)); everything else takes the
    dense kernel K1, which applies the same band as a mask. CPU tensors
    run the dense plain version, as the JAX package's CPU path runs its
    lax twin; both give the same result."""
    wp_band = extend_banded.window_lanes(params.w)
    if (query.is_cuda and params.opt_ext
            and wp_band < _round128(query.shape[1] + 1)
            and wp_band <= extend_banded.WP_LIMIT
            and query.shape[1] <= extend_banded.qmax_limit(params.w)):
        return extend_banded.extend_batch_banded(query, target, qlen, tlen,
                                                 h0, mat, params)
    return extend_kernel.extend_batch(query, target, qlen, tlen, h0, mat,
                                      params)


def end_choice(score, qle, tle, gscore, gtle, qlen, pen_clip):
    """Local-vs-to-query-end selection (reference: src/bwamem.c:1887-1901).
    Returns (score, qle, tle)."""
    take_local = (gscore <= 0) | (gscore <= score - pen_clip)
    return (torch.where(take_local, score, gscore),
            torch.where(take_local, qle, qlen),
            torch.where(take_local, tle, gtle))


def desc_windows(fm: DeviceFMIndex, reads_dev, j_read, j_qstart, j_qlen,
                 j_tstart, j_tlen, j_dir, qmax: int, tmax: int):
    """Q/T windows of job descriptors: query base i =
    reads_dev[j_read, j_qstart + j_dir*i] and target base i =
    pac_doubled[j_tstart + j_dir*i] (reverse strand complemented), 4
    past each length. A descending (j_dir = -1, left-extension) window is
    the column flip of the ascending window that ends at the start point.
    Returns int8 (N, qmax) and (N, tmax)."""
    B, L = reads_dev.shape
    dev = reads_dev.device
    dirp = (j_dir > 0)[:, None]
    arq = torch.arange(qmax, device=dev)[None, :]
    q_words, q_nplane = pack_codes_2bit(reads_dev)
    Wr = q_words.shape[1]
    q0 = torch.where(j_dir > 0, j_qstart, j_qstart - (qmax - 1))
    # windows stay within one read row for all VALID columns (job
    # construction); the rest is masked to 4
    qf0 = j_read.to(torch.int64) * (Wr * 16) + q0
    Qa = _extract_words_ascending(q_words.reshape(-1), qf0, qmax)
    Qn = _extract_words_ascending(q_nplane.reshape(-1), qf0, qmax)
    Qa = torch.where(Qn > 0, 4, Qa)
    Q = torch.where(dirp, Qa, Qa.flip(1))
    Q = torch.where(arq < j_qlen[:, None], Q, 4)
    art = torch.arange(tmax, device=dev)[None, :]
    t0 = torch.where(j_dir > 0, j_tstart, j_tstart - (tmax - 1))
    Ta = gather_window_fast(fm, t0, tmax)
    T = torch.where(dirp, Ta, Ta.flip(1))
    T = torch.where(art < j_tlen[:, None], T, 4)
    return Q.to(torch.int8).contiguous(), T.to(torch.int8).contiguous()


def extend_choose_desc(fm: DeviceFMIndex, reads_dev, j_read, j_qstart,
                       j_qlen, j_tstart, j_tlen, j_dir, h0, mat,
                       params: ExtendParams, pen_clip: int, qmax: int,
                       tmax: int):
    """Extension fed by JOB DESCRIPTORS (read, qstart, qlen, tstart, tlen,
    dir) instead of materialized Q/T tiles: the windows are gathered on
    the device from the uploaded reads and the packed genome, extended,
    and end_choice applied. Returns a stacked (3, N) int32 tensor
    (score, qle, tle)."""
    Q, T = desc_windows(fm, reads_dev, j_read, j_qstart, j_qlen, j_tstart,
                        j_tlen, j_dir, qmax, tmax)
    out = extend_batch_auto(Q, T, j_qlen, j_tlen, h0, mat, params)
    sc, qe, te = end_choice(out["score"], out["qle"], out["tle"],
                            out["gscore"], out["gtle"], j_qlen, pen_clip)
    return torch.stack([sc, qe, te])
