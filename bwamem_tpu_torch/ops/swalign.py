"""Batched local Smith-Waterman with start positions — ksw_align2
semantics (reference: src/ksw.c:355-612), used by paired-end mate rescue
(reference: src/bwamem_pair.c:119-188 mem_matesw). The DP is the kernel
in ops/kernels/swalign_kernel.py; this module keeps the JAX twin's entry
points (bwamem_tpu/ops/swalign.py) and the descriptor-fed rescue launch.

Semantics (matching ksw_align2 observable behavior):
  * best = max over all cells of the local affine-gap score;
  * (te, qe) = 0-based coordinates of the best cell; ties: earliest target
    row wins, earliest query column within the row;
  * score2 = best row-max >= minsc at a target row outside the window
    te +- ceil(score / max_match) (the KSW_XSUBO second-best rule);
  * (tb, qb) from a reverse pass over the reversed prefixes.
"""
from __future__ import annotations

import torch

from ..index.device import DeviceFMIndex
from .extend import make_score_matrix
from .kernels import swalign_kernel
from .refgather import gather_window_fast

SW_KEYS = ("score", "qb", "qe", "tb", "te", "score2")


def sw_align_batch_stacked(query, target, qlen, tlen, mat, minsc,
                           o_del: int, e_del: int, o_ins: int, e_ins: int,
                           max_mat: int = 1):
    """Batched ksw_align2 with the outputs stacked as one (6, N) int32
    tensor in SW_KEYS order: score, qb, qe, tb, te (ends inclusive,
    0-based; -1s when score == 0) and score2 (0 when no qualifying
    second-best). `minsc` is the per-job KSW_XSUBO threshold."""
    return swalign_kernel.sw_align_batch(query, target, qlen, tlen, minsc,
                                         mat, o_del, e_del, o_ins, e_ins,
                                         max_mat)


def sw_align_batch(query, target, qlen, tlen, mat, minsc,
                   o_del: int, e_del: int, o_ins: int, e_ins: int,
                   max_mat: int = 1) -> dict:
    """sw_align_batch_stacked as a dict of (N,) int32 tensors."""
    out = sw_align_batch_stacked(query, target, qlen, tlen, mat, minsc,
                                 o_del, e_del, o_ins, e_ins, max_mat)
    return dict(zip(SW_KEYS, out))


def sw_rescue_desc_stacked(fm: DeviceFMIndex, query, qlen, rb, tlen, minsc,
                           a: int, b: int, o_del: int, e_del: int,
                           o_ins: int, e_ins: int, tmax: int,
                           rev_skip: int = 0):
    """Mate-rescue SW fed by TARGET DESCRIPTORS: each job's reference
    window [rb, rb+tlen) is gathered on the device from the packed genome
    (ops/refgather.gather_window_fast), then the local SW runs with the
    bwa matrix of (a, b). query is the (N, QMAX) int8 tile of oriented
    mate sequences. Returns the (6, N) stacked result in SW_KEYS order."""
    target = gather_window_fast(fm, rb, tmax).to(torch.int8)
    mat = torch.from_numpy(make_score_matrix(a, b)).to(query.device)
    return swalign_kernel.sw_align_batch(query, target, qlen, tlen, minsc,
                                         mat, o_del, e_del, o_ins, e_ins, a,
                                         rev_skip)
