"""The fused device step: one batch of reads from seeds to merged
alignment coordinates, all on the device of the reads.

Port of bwamem_tpu/models/mem.py. The JAX step is one jitted program:

  reads -> batched SMEM seeding -> each read's best seed -> reference
  window gathers -> one two-sided batched ksw-extend launch -> merged
  coordinates and scores.

It is the "direct extension" fast path (a single best seed a read); the
full pipeline in pipeline/aligner.py puts host chaining and filtering
between the two device stages for BWA-parity output. Here the same
stages are plain functions on torch tensors: seeding through
ops/seeding.smem_seed_batch, windows through ops/refgather, and the
extension through ops/extend.extend_batch_auto, which on a CUDA device
launches K1 (the dense kernel) or, when the band window is narrower than
the row (long reads), K3 (the banded kernel). parallel/sharded.py maps
this step over the devices of a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..index.device import DeviceFMIndex
from ..ops import fm as fmops
from ..ops.extend import (ExtendParams, end_choice, extend_batch_auto,
                          make_score_matrix)
from ..ops.refgather import gather_window_fast
from ..ops.seeding import SeedConfig, smem_seed_batch


@dataclass(frozen=True)
class AlignStepConfig:
    seed: SeedConfig = SeedConfig()
    ext: ExtendParams = ExtendParams()
    a: int = 1
    b: int = 4
    pen_clip: int = 5
    pad: int = 32   # extra reference bases beyond the unseeded read span


def best_seed(read_id, slen, n_reads: int):
    """Each read's best seed: the longest, ties to the first in seed
    order (the JAX step's segment max of slen * P + (P - 1 - slot) over
    its pool of P slots, whose valid seeds are the port's, in the same
    order). A segment max of the length, then a segment min of the index
    among the longest, so no product can overflow. Returns (has_seed,
    best): (n_reads,) bool, and the index of the best seed (0 where a
    read has none)."""
    dev = slen.device
    rid = read_id.to(torch.int64)
    longest = torch.full((n_reads,), -1, dtype=slen.dtype, device=dev)
    longest = longest.scatter_reduce(0, rid, slen, "amax")
    n = slen.shape[0]
    top = slen == longest[rid]
    first = torch.full((n_reads,), n, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(
        0, rid[top], torch.arange(n, device=dev)[top], "amin")
    has_seed = first < n
    return has_seed, torch.where(has_seed, first, 0)


def device_align_step(fm: DeviceFMIndex, reads, lens,
                      cfg: AlignStepConfig = AlignStepConfig()):
    """reads: (B, L) int codes (4 = N or padding); lens: (B,); fm on the
    device of reads. Returns a dict of (B,) tensors: score (-1 without a
    seed), qb, qe, rb, re (doubled coordinates, in fmops.idx_dt(fm)),
    has_seed; and n_seeds, a 0-d int64 tensor: the batch's seeds. The
    JAX step seeds on fixed pools with no retry and counts at most its
    pool (min(total, pool size)); the port compacts exactly, so n_seeds
    is the untruncated count."""
    B, L = reads.shape
    dev = reads.device
    reads = reads.to(torch.int32)
    lens = lens.to(torch.int32)
    dt = fmops.idx_dt(fm)
    seeds = smem_seed_batch(fm, reads, lens, cfg.seed)
    slen = seeds["qend"] - seeds["qbeg"]
    has_seed, best = best_seed(seeds["read_id"], slen, B)
    if seeds["qbeg"].numel() == 0:
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        qbeg, qend, rbeg = zero, zero, zero.to(dt)
    else:
        qbeg = torch.where(has_seed, seeds["qbeg"][best], 0)
        qend = torch.where(has_seed, seeds["qend"][best], 0)
        rbeg = torch.where(has_seed, seeds["rbeg"][best].to(dt), 0)
    seedlen = qend - qbeg

    # left extension: reversed query prefix vs reversed reference window
    PAD = cfg.pad
    TL = L + PAD  # target window length a side
    lq_len = torch.where(has_seed, qbeg, 0)
    lt_len = torch.minimum(rbeg, (lq_len + PAD).to(dt))
    # reversed windows: element j = position (start - 1 - j)
    offs = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    lq = torch.gather(reads, 1, (qbeg[:, None] - 1 - offs).clamp(0, L - 1)
                      .to(torch.int64))
    lq = torch.where(offs < lq_len[:, None], lq, 4)
    lt_offs = torch.arange(TL, dtype=dt, device=dev)[None, :]
    # descending window [rbeg-1 .. rbeg-TL] = ascending window flipped
    lt = gather_window_fast(fm, rbeg - TL, TL).flip(1)
    lt = torch.where(lt_offs < lt_len[:, None], lt, 4)

    # right extension: query suffix vs forward reference window
    rq_len = torch.where(has_seed, lens - qend, 0)
    rq = torch.gather(reads, 1, (qend[:, None] + offs).clamp(0, L - 1)
                      .to(torch.int64))
    rq = torch.where(offs < rq_len[:, None], rq, 4)
    rt_end_cap = 2 * fm.l_pac.to(dt)
    rt_len = torch.minimum((rq_len + PAD).to(dt),
                           rt_end_cap - (rbeg + seedlen))
    rt = gather_window_fast(fm, rbeg + seedlen, TL)
    rt = torch.where(lt_offs < rt_len[:, None], rt, 4)

    mat = torch.as_tensor(make_score_matrix(cfg.a, cfg.b), device=dev)
    h0 = torch.clamp(seedlen * cfg.a, min=1)

    # one extension launch for both sides
    q2 = torch.cat([lq, rq]).to(torch.int8).contiguous()
    t2 = torch.cat([lt, rt]).to(torch.int8).contiguous()
    ql2 = torch.cat([lq_len, rq_len]).to(torch.int32).contiguous()
    tl2 = torch.cat([lt_len, rt_len]).to(torch.int32).contiguous()
    h02 = torch.cat([h0, h0]).to(torch.int32).contiguous()
    out = extend_batch_auto(q2, t2, ql2, tl2, h02, mat, cfg.ext)
    sc2, qe2, te2 = end_choice(out["score"], out["qle"], out["tle"],
                               out["gscore"], out["gtle"], ql2,
                               cfg.pen_clip)
    lsc, rsc = sc2[:B], sc2[B:]
    lqe, rqe = qe2[:B], qe2[B:]
    lte, rte = te2[:B], te2[B:]

    left, right = lq_len > 0, rq_len > 0
    score = (torch.where(left, lsc, 0) + torch.where(right, rsc, 0)
             - torch.where(left & right, seedlen * cfg.a, 0))
    score = torch.where(~left & ~right, seedlen * cfg.a, score)
    score = torch.where(has_seed, score, -1)
    lqe = torch.where(left, lqe, 0)
    lte = torch.where(left, lte, 0)
    rqe = torch.where(right, rqe, 0)
    rte = torch.where(right, rte, 0)
    return dict(
        score=score,
        qb=qbeg - lqe,
        qe=qend + rqe,
        rb=rbeg - lte,
        re=rbeg + seedlen + rte,
        has_seed=has_seed,
        n_seeds=torch.tensor(seeds["qbeg"].shape[0], dtype=torch.int64,
                             device=dev),
    )
