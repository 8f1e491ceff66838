"""Batched seeding on torch tensors: SMEMs (with and without vanilla bwa's
re-seed rounds 2 and 3), all MEMs (-g), forward-only MEMs (-u 3) and
fixed-length seeds (-u 2/4).

Port of bwamem_tpu/ops/seeding.py:smem_seed_batch and bowtie_seed_batch.
Same stages, same output order:

  round 1, forward: one pass over read positions (two per trip on occ2
    indexes); a candidate (segment start, end, interval before the step)
    is emitted whenever the interval size changes (mode "fwdmem": only
    when the walk dies, one base per trip on every index). On occ2
    indexes the round-3 LAST-like automaton rides the same trips.
  compaction: emitted candidates in (read, end) order.
  round 1, backward: every candidate extended maximally to the left
    (not in mode "fwdmem"); in mode "mem" with the JAX walk's staged
    lane compaction, which decides each lane's early-kill neighbour.
  filter: mode "smem" keeps a candidate iff its qbeg is strictly below
    every later-ending candidate's qbeg within the same read; mode "mem"
    drops only adjacent duplicates; mode "fwdmem" keeps every segment of
    at least min_seed_len.
  round 2 (mode "smem" only): split re-seed of long low-occurrence SMEMs
    from their midpoint (forward walks with a floor, then the same
    backward walk).
  merge: the three rounds' survivors sorted stably by (read, qbeg, qend).
  occurrence expansion: per-seed subsampling (max_occ), then SA lookups.

Mode "smem" runs its walks as hand-written CUDA kernels on a CUDA tensor
(kernels/seed_kernels: S1 the round-1 forward walk with round 3 in the
same launch, S2 the backward walks of rounds 1 and 2, S3 the round-2
re-seed walks, S4 the SA lookup); the walk functions here are their
plain versions, which a CPU tensor runs. Mode "mem" takes S1 for its
forward walk, and every mode and bowtie_seed_batch S4 for the SA lookup;
the rest of modes "mem" and "fwdmem" and of bowtie_seed_batch runs on
torch ops on either device.

Torch has dynamic shapes, so every compaction is exact (nonzero on the
emission mask, which keeps order). The JAX package's fixed pools, their
overflow retry and learned sizes exist only for XLA's static shapes and
are left out; its converged result is the untruncated one computed here.
Its staged lane compaction of the round-1 backward walk changes which
lane a lane is compared with in the early kill, and mode "mem" keeps
what the kill froze, so there the port follows the same schedule on the
width of the JAX pool (cand_pool slots a read, `pool_reads` reads), grown
as the JAX overflow retry grows it when the round-1 candidates overflow
it (grown_cand_pool); where the retry would end at the pools' caps still
overflowing, the JAX aligner splits the batch (pool_spills), and the
port's aligner splits it too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..index.device import DeviceFMIndex
from . import fm as fmops
from .kernels import seed_kernels

BIG = 0x3FFFFFFF
# the JAX aligner's largest pools of the two that mode "mem" fills
# (bwamem_tpu/pipeline/poolstore.py POOL_CAPS): round-1 candidates and
# expanded seeds, in slots a read; past them it splits the batch
POOL_CAPS = {"cand_pool": 4096, "seed_pool": 4096}
# how many walk trips run between checks of the all-dead exit (each check
# is one device->host sync)
_EXIT_CHECK = 4


@dataclass(frozen=True)
class SeedConfig:
    min_seed_len: int = 19
    # the JAX pool's candidate slots per read; with the read count it
    # sets the width on which the round-1 backward walk's compaction
    # schedule (r1_schedule, mode "mem") acts
    cand_pool: int = 32
    # the JAX pool's expanded-seed slots per read: with cand_pool, where
    # the JAX aligner splits a mode "mem" batch (pool_spills)
    seed_pool: int = 4
    max_occ: int = 500     # subsample SMEMs above this occurrence count
    mode: str = "smem"     # "smem" | "mem" (-g: keep nested MEMs) |
    #                        "fwdmem" (-u 3: forward-only MEMs)
    # vanilla bwa's 2nd/3rd seeding rounds (bwa_index/bwamem.c:114-162),
    # run in mode "smem" only
    reseed: bool = False
    split_factor: float = 1.5
    split_width: int = 10
    max_mem_intv: int = 20
    # (trip, divisor) points of the round-1 walk's lane compaction
    r1_schedule: tuple = ((6, 2), (12, 4), (16, 8))


def _compact(mask, *fields):
    """Order-preserving compaction of flat fields by mask."""
    idx = mask.reshape(-1).nonzero().squeeze(1)
    return idx, tuple(f.reshape(-1)[idx] for f in fields)


def _init1(fm, b):
    """Bi-interval (k, l, s) of the single base b (restart)."""
    L2c = fmops._L2(fm)
    bc = b.clamp(0, 3).long()
    ik = L2c[bc] + 1
    il = L2c[3 - bc] + 1
    is_ = L2c[bc + 1] - (ik - 1)
    return ik, il, is_


def _forward_pass(fm, reads, lens, min_seed_len, emit_mode="shrink"):
    """Round-1 forward pass, one base per trip (indexes without occ2, and
    mode "fwdmem" on every index). reads: (B, L) int32 codes (pad/amb =
    4). Returns (start, k, s, emit), each (B, L+1), the candidate of
    column i ending at i.

    emit_mode "shrink": emit on every interval-size change (candidates
    for the backward pass). "segment": emit only when the walk dies
    (forward-only MEMs, one maximal segment per restart; reference
    src/bwt.c:719-769 bwt_fwd_mem)."""
    B, L = reads.shape
    dev = reads.device
    dt = fmops.idx_dt(fm)
    reads_pad = torch.cat(
        [reads, torch.full((B, 1), 4, dtype=torch.int32, device=dev)], 1)
    k = torch.zeros(B, dtype=dt, device=dev)
    l = torch.zeros_like(k)
    s = torch.zeros_like(k)
    seg = torch.zeros(B, dtype=torch.int32, device=dev)
    cands = []
    for i in range(L + 1):
        base = reads_pad[:, i]
        valid = (i < lens) & (base < 4)
        active = s > 0
        k4, l4, s4 = fmops.forward_ext4_batch(fm, k, l, s)
        bc = base.clamp(0, 3)
        okk, okl = fmops._sel(k4, bc), fmops._sel(l4, bc)
        oks = torch.where(valid, fmops._sel(s4, bc), 0)
        if emit_mode == "segment":
            emit = active & (oks == 0) & (i - seg >= min_seed_len)
        else:
            emit = active & (oks != s) & (i >= min_seed_len)
        cands.append((seg, k, s, emit))
        ext = valid & active & (oks > 0)
        restart = valid & ~ext
        ik, il, is_ = _init1(fm, base)
        zero = torch.zeros_like(k)
        k = torch.where(ext, okk, torch.where(restart, ik, zero))
        l = torch.where(ext, okl, torch.where(restart, il, zero))
        s = torch.where(ext, oks, torch.where(restart, is_, zero))
        seg = torch.where(ext, seg, i)
    return tuple(torch.stack(c, dim=1) for c in zip(*cands))


def _seed_strategy_pass(fm, reads, lens, min_len: int, max_intv: int):
    """Vanilla round-3 LAST-like seeding as one forward pass (indexes
    without occ2; bwa_index/bwt.c:434-455 under bwamem.c:144-158): a walk
    from x emits ONE seed [x, i+1) at the first position where the
    interval drops below max_intv with match length > min_len, then
    restarts at i+1. Returns (x, k, s, emit), each (B, L); column i's
    seed ends at i + 1."""
    B, L = reads.shape
    dev = reads.device
    dt = fmops.idx_dt(fm)
    x = torch.zeros(B, dtype=torch.int32, device=dev)
    k = torch.zeros(B, dtype=dt, device=dev)
    l = torch.zeros_like(k)
    s = torch.zeros_like(k)
    cands = []
    for i in range(L):
        b = reads[:, i]
        bc = b.clamp(0, 3)
        validb = (i < lens) & (b < 4)
        walking = validb & (x < i)
        k4, l4, s4 = fmops.forward_ext4_batch(fm, k, l, s)
        kn, ln, sn = (fmops._sel(a, bc) for a in (k4, l4, s4))
        emit = walking & (sn < max_intv) & (i - x >= min_len)
        cands.append((x, kn, sn, emit))
        start = validb & (x == i)
        ik, il, is_ = _init1(fm, b)
        cont = walking & ~emit
        zero = torch.zeros_like(k)
        k = torch.where(cont, kn, torch.where(start, ik, zero))
        l = torch.where(cont, ln, torch.where(start, il, zero))
        s = torch.where(cont, sn, torch.where(start, is_, zero))
        x = torch.where(~validb | emit, i + 1, x)
    return tuple(torch.stack(c, dim=1) for c in zip(*cands))


def _forward_pass2(fm, reads, lens, min_seed_len, strategy=None):
    """Round-1 forward pass over the occ2 pair table: each trip appends a
    base PAIR with one fused row gather (fm.forward_ext2_batch) and emits
    both positions' candidates; restarts mid-pair re-enter through the
    2-mer bi-interval table. Emissions equal _forward_pass's.

    strategy=(min_len, max_intv) also runs the round-3 automaton
    (_seed_strategy_pass semantics) inside the same trips. Returns the
    four round-1 planes (B, NP) plus, with a strategy, (x3, k3, s3, emit3)
    planes (B, L)."""
    B, L = reads.shape
    dev = reads.device
    T2 = (L + 2) // 2  # trips; positions covered: 0 .. 2*T2-1 >= L+1
    NP = 2 * T2
    reads_pad = torch.cat(
        [reads, torch.full((B, NP - L), 4, dtype=torch.int32, device=dev)], 1)
    dt = fmops.idx_dt(fm)
    pat = fm.occ2_pat.to(dt)

    k = torch.zeros(B, dtype=dt, device=dev)
    l = torch.zeros_like(k)
    s = torch.zeros_like(k)
    seg = torch.zeros(B, dtype=torch.int32, device=dev)
    x3 = torch.zeros(B, dtype=torch.int32, device=dev)
    k3 = torch.zeros_like(k)
    l3 = torch.zeros_like(k)
    s3 = torch.zeros_like(k)
    zero = torch.zeros_like(k)
    c1, c3 = [], []

    def pick(cond, a, cond2, b):
        return torch.where(cond, a, torch.where(cond2, b, zero))

    for it in range(T2):
        i = 2 * it
        b1 = reads_pad[:, i]
        b2 = reads_pad[:, i + 1]
        valid1 = (i < lens) & (b1 < 4)
        valid2 = (i + 1 < lens) & (b2 < 4)
        active = s > 0
        (k1, l1, s1), (k2, l2, s2) = fmops.forward_ext2_batch(
            fm, k, l, s, b1, b2)
        if strategy is not None:
            (k31, l31, s31), (k32, l32, s32) = fmops.forward_ext2_batch(
                fm, k3, l3, s3, b1, b2)

        # ---- sub-step A (position i) ----
        s1v = torch.where(valid1, s1, zero)
        emitA = active & (s1v != s) & (i >= min_seed_len)
        c1.append((seg, k, s, emitA))
        ext1 = valid1 & active & (s1 > 0)
        restart1 = valid1 & ~ext1
        ik1, il1, is1 = _init1(fm, b1)
        kA = pick(ext1, k1, restart1, ik1)
        lA = pick(ext1, l1, restart1, il1)
        sA = pick(ext1, s1, restart1, is1)
        segA = torch.where(ext1, seg, i)

        # ---- sub-step B (position i+1) ----
        # three sources: pair path (ext1), 2-mer table (restart1), dead
        d12 = (b1.clamp(0, 3) * 4 + b2.clamp(0, 3)).long()
        pk, pl, ps = pat[0][d12], pat[1][d12], pat[2][d12]
        sB = pick(ext1, s2, restart1, ps)
        kB = pick(ext1, k2, restart1, pk)
        lB = pick(ext1, l2, restart1, pl)
        activeB = sA > 0
        sBv = torch.where(valid2, sB, zero)
        emitB = activeB & (sBv != sA) & (i + 1 >= min_seed_len)
        c1.append((segA, kA, sA, emitB))
        ext2 = valid2 & activeB & (sB > 0)
        restart2 = valid2 & ~ext2
        ik2, il2, is2 = _init1(fm, b2)
        k = pick(ext2, kB, restart2, ik2)
        l = pick(ext2, lB, restart2, il2)
        s = pick(ext2, sB, restart2, is2)
        seg = torch.where(ext2, segA, i + 1)
        if strategy is None:
            continue

        # ---- round-3 automaton, both sub-steps ----
        min_len3, max_intv3 = strategy
        walkA = valid1 & (x3 < i)
        emit3A = walkA & (s31 < max_intv3) & (i - x3 >= min_len3)
        c3.append((x3, k31, s31, emit3A))
        startA = valid1 & (x3 == i)
        contA3 = walkA & ~emit3A
        k3A = pick(contA3, k31, startA, ik1)
        l3A = pick(contA3, l31, startA, il1)
        s3A = pick(contA3, s31, startA, is1)
        x3A = torch.where(~valid1 | emit3A, i + 1, x3)
        # sub-step B: pair path for contA3 lanes, 2-mer table for lanes
        # that started at i, fresh start at i+1
        k3B = pick(contA3, k32, startA, pk)
        l3B = pick(contA3, l32, startA, pl)
        s3B = pick(contA3, s32, startA, ps)
        walkB = valid2 & (x3A < i + 1)
        emit3B = walkB & (s3B < max_intv3) & (i + 1 - x3A >= min_len3)
        c3.append((x3A, k3B, s3B, emit3B))
        startB = valid2 & (x3A == i + 1)
        contB3 = walkB & ~emit3B
        k3 = pick(contB3, k3B, startB, ik2)
        l3 = pick(contB3, l3B, startB, il2)
        s3 = pick(contB3, s3B, startB, is2)
        x3 = torch.where(~valid2 | emit3B, i + 2, x3A)

    planes = tuple(torch.stack(c, dim=1) for c in zip(*c1))
    if strategy is None:
        return planes
    r3 = tuple(torch.stack(c, dim=1)[:, :L] for c in zip(*c3))
    return planes + (r3,)


def _backward_pass(fm, reads, rid, qbeg, k, s, floor=None, group=None,
                   text_walk=False, schedule=(), pool_width: int = 0):
    """Extend each candidate maximally to the left (the FM walk, k-side
    interval only). Flat (P,) lanes in (group, end) order.

    floor: optional (P,) minimum interval size to keep extending
    (bwt_smem1a's min_intv; default 1). group: optional (P,) segment key
    of the contained-walker early kill (defaults to rid).

    Early kill: when a lane reaches the same (qb, k, s) as its neighbour
    in the same group, it is contained and stops walking — the
    containment filter drops it either way. Mode "mem" keeps such a lane
    where it stopped, so the kill is part of its output, as in the JAX
    package. text_walk: lanes at s == 1 are never killed and walk on to
    their true left end, which is where the JAX package's text walk (on
    for read buckets of 384 bp or more) takes them.

    A lane's neighbour is the next lane, unless `schedule` compacts the
    lanes (mode "mem"): the JAX walk's staged compaction on a pool of
    `pool_width` lanes (bwamem_tpu/ops/seeding.py _backward_pass). With a
    pool of 4096 lanes or more, at each (t, d) with t <= min(16, L), after
    t trips: if max(W // d, 256) < W (W: the current set's width) and the
    lanes still walking there fit in it, they become the new set of that
    width, and from then on a lane's neighbour is the next lane of the
    set. Lanes that the JAX walk has handed to its text walk (s == 1)
    have left the set. No lane moves: only the neighbour changes."""
    B, L = reads.shape
    P = qbeg.shape[0]
    dev = qbeg.device
    reads_flat = reads.reshape(-1)
    floor = torch.ones_like(s) if floor is None else floor.to(s.dtype)
    group = rid if group is None else group
    lane = torch.arange(P, device=dev)
    nxt = (lane + 1).clamp(max=max(P - 1, 0))
    has_nxt = lane < P - 1
    same_grp = has_nxt & (group[nxt] == group)
    qb, kk, ss = qbeg.clone(), k.clone(), s.clone()
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    sched = [(int(t), int(d)) for t, d in schedule
             if 0 < t <= min(16, L) and d > 1] if pool_width >= 4096 else []
    W = pool_width

    for it in range(L):
        while sched and sched[0][0] == it:
            d = sched.pop(0)[1]
            cap = max(W // d, 256)
            walking = ~done
            if text_walk:
                walking &= ss != 1
            if cap >= W or int(walking.sum()) > cap:
                continue
            W = cap
            idx = walking.nonzero().squeeze(1)
            nxt = lane.clone()
            nxt[idx[:-1]] = idx[1:]
            has_nxt = torch.zeros(P, dtype=torch.bool, device=dev)
            has_nxt[idx[:-1]] = True
            same_grp = has_nxt & (group[nxt] == group)
        if it % _EXIT_CHECK == 0 and bool(done.all()):
            break
        j = qb - 1
        base = reads_flat[(rid.long() * L + j).clamp(0, B * L - 1)]
        can = ~done & (j >= 0) & (base < 4)
        kq = torch.where(can, kk, 0)
        sq = torch.where(can, ss, 1)
        nk, ns = fmops.backward_ext_ks_batch(
            fm, kq, sq, torch.where(can, base.clamp(0, 3), 0))
        ok = can & (ns >= floor)
        qb = torch.where(ok, j, qb)
        kk = torch.where(ok, nk, kk)
        ss = torch.where(ok, ns, ss)
        same = (same_grp & (qb[nxt] == qb) & (ss[nxt] == ss)
                & (kk[nxt] == kk))
        if text_walk:
            same &= ss != 1
        done = ~ok | same
    return qb, kk, ss


def _segmented_suffix_min(v, seg):
    """For each i: min(v[j] for j > i in i's run of equal seg), BIG if
    none. v, seg: (P,) ints."""
    P = v.shape[0]
    if P == 0:
        return v
    vr = v.flip(0).to(torch.int64)
    sr = seg.flip(0)
    run = torch.cat([torch.zeros(1, dtype=torch.int64, device=v.device),
                     (sr[1:] != sr[:-1]).to(torch.int64)]).cumsum(0)
    # runs later in the reversed order carry smaller offsets, so a running
    # min never reaches back across a run boundary
    off = (run[-1] - run) << 32
    inc = ((vr + off).cummin(0).values - off).flip(0)
    big = torch.full((1,), BIG, dtype=torch.int64, device=v.device)
    nxt_v = torch.cat([inc[1:], big])
    nxt_same = torch.cat([seg[1:] == seg[:-1],
                          torch.zeros(1, dtype=torch.bool, device=v.device)])
    return torch.where(nxt_same, nxt_v, BIG)


def _containment_filter(qbeg, qend, grp, min_seed_len):
    keep = qbeg.to(torch.int64) < _segmented_suffix_min(qbeg, grp)
    return keep & ((qend - qbeg) >= min_seed_len)


def _dup_filter(qbeg, qend, rid, s, min_seed_len):
    """Mode "mem" (-g): keep nested MEMs; drop only a candidate whose next
    one has the same (read, qbeg) and the same interval size (reference:
    filter_seed_intervals_gpu_mem, seed_gen.cu:783-812). Candidates are in
    (read, end) order."""
    P = qbeg.shape[0]
    dup = torch.zeros(P, dtype=torch.bool, device=qbeg.device)
    if P > 1:
        dup[:-1] = ((rid[1:] == rid[:-1]) & (qbeg[1:] == qbeg[:-1])
                    & (s[1:] == s[:-1]))
    return ~dup & ((qend - qbeg) >= min_seed_len)


def _reseed_forward(fm, reads, lens, lrid, lx, lfloor, min_seed_len: int):
    """Round-2 split re-seed forward walks (vanilla bwt_smem1a's forward
    loop with min_intv = parent occ + 1 from the parent SMEM's midpoint,
    bwa_index/bwamem.c:133-141, bwa_index/bwt.c:381-394).

    One lane per qualifying parent SMEM. Each trip appends one base (two
    on occ2 indexes) and records a candidate (k/s before the step, end =
    current position) whenever the interval size changes — including the
    end-of-walk push at read end, N bases and below-floor death.
    Emissions are trip-indexed: column j of the (R, L+2) planes holds the
    emission of relative offset j. Returns (kb, sb, eb, filled)."""
    R = lrid.shape[0]
    B, L = reads.shape
    dev = reads.device
    dt = fmops.idx_dt(fm)
    reads_flat = reads.reshape(-1)
    lens_l = lens[lrid.long()]
    b0 = reads_flat[(lrid.long() * L + lx).clamp(0, B * L - 1)]
    k, l, s = _init1(fm, b0)
    alive = (b0 < 4) & (lx < lens_l)
    T = L + 2  # columns indexed by relative trip offset j in [1, L+1]
    lfloor = lfloor.to(dt)
    kb = torch.zeros((R, T), dtype=dt, device=dev)
    sb = torch.zeros((R, T), dtype=dt, device=dev)
    eb = torch.zeros((R, T), dtype=torch.int32, device=dev)
    fill = torch.zeros((R, T), dtype=torch.bool, device=dev)
    zero = torch.zeros_like(k)

    def fetch(i):
        b = reads_flat[(lrid.long() * L + i).clamp(0, B * L - 1)]
        return torch.where(i < lens_l, b, 4)

    def push(j, emit, kv, sv, ev):
        kb[:, j] = torch.where(emit, kv, zero)
        sb[:, j] = torch.where(emit, sv, zero)
        eb[:, j] = torch.where(emit, ev, 0)
        fill[:, j] = emit

    j = 1
    trip = 0
    while j <= L:
        if trip % _EXIT_CHECK == 0 and not bool(alive.any()):
            break
        trip += 1
        if fm.has_occ2:
            i1 = lx + j
            i2 = i1 + 1
            b1 = fetch(i1)
            b2 = fetch(i2)
            v1 = (i1 < lens_l) & (b1 < 4)
            v2 = (i2 < lens_l) & (b2 < 4)
            (k1, l1, s1), (k2, l2, s2) = fmops.forward_ext2_batch(
                fm, k, l, s, b1.clamp(0, 3), b2.clamp(0, 3))
            # sub-step 1 (position i1): emit against the pre-pair state
            s1n = torch.where(v1 & alive, s1, zero)
            emit1 = alive & (s1n != s) & (i1 >= min_seed_len)
            push(j, emit1, k, s, i1)
            alive1 = alive & v1 & (s1n >= lfloor)
            # sub-step 2 (position i2): lanes that survived sub-step 1
            s2n = torch.where(v2 & alive1, s2, zero)
            emit2 = alive1 & (s2n != s1n) & (i2 >= min_seed_len)
            push(j + 1, emit2, k1, s1n, i2)
            alive2 = alive1 & v2 & (s2n >= lfloor)
            # freeze-on-death: a lane dead at sub-step 1 keeps the
            # pre-pair state; dead at sub-step 2 keeps the one-append one
            k = torch.where(alive2, k2, torch.where(alive1, k1, k))
            l = torch.where(alive2, l2, torch.where(alive1, l1, l))
            s = torch.where(alive2, s2n, torch.where(alive1, s1n, s))
            alive = alive2
            j += 2
        else:
            i = lx + j
            b = fetch(i)
            validb = (i < lens_l) & (b < 4)
            k4, l4, s4 = fmops.forward_ext4_batch(fm, k, l, s)
            bc = b.clamp(0, 3)
            kn, ln = fmops._sel(k4, bc), fmops._sel(l4, bc)
            sn = torch.where(validb & alive, fmops._sel(s4, bc), zero)
            emit = alive & (sn != s) & (i >= min_seed_len)
            push(j, emit, k, s, i)
            alive2 = alive & validb & (sn >= lfloor)
            k = torch.where(alive2, kn, k)
            l = torch.where(alive2, ln, l)
            s = torch.where(alive2, sn, s)
            alive = alive2
            j += 1
    return kb, sb, eb, fill


def _expand_occurrences(fm, rid, qbeg, qend, k, s, keep, max_occ):
    """Per-SMEM occurrence list: subsample with step s // max_occ when
    s > max_occ (at most max_occ entries, the mem_chain rule,
    src/bwamem.c:426-431), then resolve each row's text position with an
    SA walk (fm.sa_lookup_batch). Seeds come out in (candidate, SA rank)
    order. The plain version of S4 (kernels/seed_kernels.sa_lookup), which
    the seeding calls."""
    s_v = torch.where(keep, s, 0).to(torch.int64)
    step = torch.where(s_v > max_occ, s_v // max_occ, 1)
    count = torch.where(s_v > 0, (s_v + step - 1) // step, 0)
    count = count.clamp(max=max_occ)
    cand = torch.repeat_interleave(
        torch.arange(count.shape[0], device=s.device), count)
    first = count.cumsum(0) - count
    off = torch.arange(cand.shape[0], device=s.device) - first[cand]
    rows = k[cand].to(torch.int64) + off * step[cand]
    rbeg = fmops.sa_lookup_batch(fm, rows)
    return dict(read_id=rid[cand].to(torch.int32),
                qbeg=qbeg[cand].to(torch.int32),
                qend=qend[cand].to(torch.int32), rbeg=rbeg, n_occ=s[cand])


def smem_seed_batch(fm: DeviceFMIndex, reads, lens,
                    cfg: SeedConfig = SeedConfig(),
                    pool_reads: int | None = None):
    """End-to-end batched seeding in cfg.mode.

    reads: (B, L) int codes (amb/pad = 4); lens: (B,) int. pool_reads:
    the read count the JAX package sizes its candidate pool for (its
    aligner pads a batch to bucket_count(B)); B by default. Returns flat
    seed arrays sorted by (read, qend, SA rank) — or, with the re-seed
    rounds (cfg.reseed in mode "smem"), by (read, qbeg, qend, SA rank):
    read_id, qbeg, qend, rbeg (doubled coordinates), n_occ; and two
    ints: cand_pool, the candidate slots a read of the pool the mode
    "mem" walk compacted on (cfg.cand_pool, or the JAX overflow retry's
    grown_cand_pool when the round-1 candidates overflow it), and c_need,
    the round-1 candidates' count."""
    if cfg.mode not in ("smem", "mem", "fwdmem"):
        raise ValueError(f"unknown seeding mode {cfg.mode!r}")
    reads = reads.to(torch.int32)
    lens = lens.to(torch.int32)
    B, L = reads.shape
    dev = reads.device
    dt = fmops.idx_dt(fm)
    reseed = cfg.reseed and cfg.mode == "smem"
    r3_planes = None
    if cfg.mode == "fwdmem":
        start, k, s, emit = _forward_pass(fm, reads, lens, cfg.min_seed_len,
                                          emit_mode="segment")
    else:
        # S1: round 3 rides the round-1 walk's launch
        (start, k, s, emit), r3_planes = seed_kernels.seed_forward(
            fm, reads, lens, cfg.min_seed_len,
            strategy=((cfg.min_seed_len, cfg.max_mem_intv)
                      if reseed and cfg.max_mem_intv > 0 else None))
    NP = emit.shape[1]
    end = torch.arange(NP, dtype=torch.int32, device=dev).expand(B, NP)
    idx, (start, end, k, s) = _compact(emit, start, end, k, s)
    rid = (idx // NP).to(torch.int32)
    c_need = idx.shape[0]
    cand_pool = cfg.cand_pool
    if cfg.mode == "mem":
        cand_pool = grown_cand_pool(c_need, pool_reads or B, cand_pool)
    if cfg.mode == "fwdmem":
        # forward-only MEMs: no left extension, the segments are disjoint
        qbeg = start
        keep = end - qbeg >= cfg.min_seed_len
    else:
        # the text walk changes no SMEM (killed lanes are dropped either
        # way), so only mode "mem" needs it
        if cfg.mode == "mem":
            qbeg, k, s = _backward_pass(
                fm, reads, rid, start, k, s, text_walk=L >= 384,
                schedule=cfg.r1_schedule,
                pool_width=(pool_reads or B) * cand_pool)
            keep = _dup_filter(qbeg, end, rid, s, cfg.min_seed_len)
        else:
            qbeg, k, s = seed_kernels.seed_backward(fm, reads, rid, start,
                                                    k, s)
            keep = _containment_filter(qbeg, end, rid, cfg.min_seed_len)
    if reseed:
        # ---- round 2: split re-seed of long low-occ SMEMs ----
        split_len = int(cfg.min_seed_len * cfg.split_factor + 0.499)
        qualify = keep & (end - qbeg >= split_len) & (s <= cfg.split_width)
        _, (lrid, lx, lfloor) = _compact(
            qualify, rid, (qbeg + end) >> 1, (s + 1).to(dt))
        kb, sb, eb, filled = seed_kernels.seed_reseed_forward(
            fm, reads, lens, lrid, lx, lfloor, cfg.min_seed_len)
        E = kb.shape[1]
        lane = torch.arange(lrid.shape[0], dtype=torch.int32, device=dev)

        def flat(a):
            return a[:, None].expand(a.shape[0], E)

        _, (rid2, lane2, x2, floor2, k2, s2, end2) = _compact(
            filled, flat(lrid), flat(lane), flat(lx), flat(lfloor), kb, sb,
            eb)
        qb2, k2, s2 = seed_kernels.seed_backward(
            fm, reads, rid2, x2, k2, s2, floor=floor2, group=lane2)
        keep2 = _containment_filter(qb2, end2, lane2, cfg.min_seed_len)
        parts = [(rid2, qb2, end2, k2, s2, keep2)]
        # ---- round 3: LAST-like forward seeds (S1's round-3 planes) ----
        if r3_planes is not None:
            x3p, k3p, s3p, emit3 = r3_planes
            L3 = emit3.shape[1]
            idx3, (qb3, k3, s3) = _compact(emit3, x3p, k3p, s3p)
            rid3 = (idx3 // L3).to(torch.int32)
            end3 = (idx3 % L3 + 1).to(torch.int32)
            parts.append((rid3, qb3, end3, k3, s3, s3 > 0))
        # ---- merge + vanilla (qbeg, qend) interval sort ----
        r1 = (rid, qbeg, end, k, s, keep)
        cols = [torch.cat([c.to(r1[i].dtype) for c in col])
                for i, col in enumerate(zip(r1, *parts))]
        _, (rid, qbeg, end, k, s) = _compact(cols[5], *cols[:5])
        # the JAX twin's key width switch (int32 keys when they fit)
        if B * (L + 2) * (L + 2) <= (1 << 30) + (1 << 29):
            kdt = torch.int32
        else:
            kdt = torch.int64
        span = L + 2
        key = ((rid.to(kdt) * span + qbeg.clamp(0, L + 1).to(kdt)) * span
               + end.clamp(0, L + 1).to(kdt))
        perm = torch.argsort(key, stable=True)
        rid, qbeg, end, k, s = (a[perm] for a in (rid, qbeg, end, k, s))
        keep = torch.ones_like(rid, dtype=torch.bool)
    out = seed_kernels.sa_lookup(fm, rid, qbeg, end, k, s, keep,
                                 cfg.max_occ)
    out["cand_pool"] = cand_pool
    out["c_need"] = c_need
    return out


def grown_cand_pool(c_need: int, pool_reads: int, cand_pool: int) -> int:
    """The cand_pool the JAX aligner seeds with after its round-1
    candidates (c_need of them) overflow its pool of pool_reads x
    cand_pool slots (bwamem_tpu/pipeline/aligner.py's overflow retry):
    m = ceil(c_need / pool) > 1 grows cand_pool by the power of two
    2^bit_length(max(m - 1, 1)), at most to POOL_CAPS["cand_pool"].
    c_need does not depend on the pool, so the grown pool holds every
    candidate and a second retry never grows it again; at the cap the
    JAX aligner splits the batch instead (pool_spills)."""
    cap = POOL_CAPS["cand_pool"]
    slots = pool_reads * cand_pool
    m = -(-c_need // slots) if slots > 0 else 1
    if m <= 1 or cand_pool >= cap:
        return cand_pool
    return min(cand_pool << max(m - 1, 1).bit_length(), cap)


def pool_spills(c_need: int, n_seeds: int, pool_reads: int,
                cand_pool: int, seed_pool: int) -> bool:
    """Whether the JAX aligner's retry loop ends with a pool at its cap
    still overflowing on a mode "mem" batch of pool_reads reads, so that
    it halves the batch (bwamem_tpu/pipeline/aligner.py's spill path):
    the retry grows each overflowing pool up to its cap, so it ends with
    c_need round-1 candidates beyond pool_reads x max(cand_pool, cap) or
    n_seeds expanded seeds beyond pool_reads x max(seed_pool, cap) (a
    pool that starts above its cap does not grow). n_seeds is counted on
    the final cand_pool, as the loop's last round counts it."""
    return (c_need > pool_reads * max(cand_pool, POOL_CAPS["cand_pool"])
            or n_seeds > pool_reads * max(seed_pool,
                                          POOL_CAPS["seed_pool"]))


def bowtie_seed_batch(fm: DeviceFMIndex, reads, lens, seed_len: int,
                      stride: int, inexact: bool, max_occ: int = 500,
                      ktab=None, ktab_k: int = 0):
    """Fixed-length exact (or <= 1-mismatch) seeds at a start stride: the
    -u 2 / -u 4 seed types (port of bwamem_tpu/ops/seeding.py:
    bowtie_seed_batch; reference src/bwt.c:593-718 bwt_bowtie_seed and
    bwt_bowtie_seed_inexact).

    Every (mismatch position, base) branch is one lane of the (start,
    candidate) plane: C = 3 * seed_len + 1 candidates a start (the last
    one exact), or 1 for exact seeds. A start's winner is its live
    candidate of highest priority: exact first, else the latest mismatch
    position, then the highest alternate base (the reference's LIFO
    stack). Only live lanes are extended at each step; a dead lane's
    interval is never read again. With a k-mer table (ktab, ktab_k, from
    fm.get_kmer_table) the first ktab_k steps are one table-row gather:
    fixed-length seeds emit nothing before their last base. Returns flat
    seed arrays sorted by (read, qbeg, SA rank), as smem_seed_batch."""
    reads = reads.to(torch.int32)
    lens = lens.to(torch.int32)
    B, L = reads.shape
    dev = reads.device
    dt = fmops.idx_dt(fm)
    S = max((L - seed_len) // stride + 1, 1)
    NL = B * S
    rid = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(S)
    x0 = (torch.arange(S, dtype=torch.int32, device=dev) * stride).repeat(B)
    lane_ok = x0 + seed_len <= lens[rid.long()]
    if inexact:
        tj = torch.arange(seed_len * 3, dtype=torch.int32, device=dev)
        ct = torch.cat([tj // 3, torch.full((1,), -1, dtype=torch.int32,
                                            device=dev)])
        cj = torch.cat([tj % 3, torch.zeros(1, dtype=torch.int32,
                                            device=dev)])
    else:  # exact only
        ct = torch.full((1,), -1, dtype=torch.int32, device=dev)
        cj = torch.zeros(1, dtype=torch.int32, device=dev)
    C = ct.shape[0]
    reads_flat = reads.reshape(-1)
    base0 = rid.long() * L + x0.long()

    def chosen(lane, cand, t):
        """Base of candidate `cand` of start `lane` at offset t (flat
        index vectors): the read base, or at the candidate's own mismatch
        offset the cj-th base other than the read base. Returns (read
        base, chosen base)."""
        rb = reads_flat[(base0[lane] + t).clamp(0, B * L - 1)]
        c = cj[cand]
        alt = c + (c >= rb).to(torch.int32)
        return rb, torch.where(ct[cand] == t, alt, rb)

    lane = torch.arange(NL, device=dev).repeat_interleave(C)
    cand = torch.arange(C, device=dev).repeat(NL)
    L2c = fmops._L2(fm)
    if ktab is not None and 1 < ktab_k < seed_len:
        code = torch.zeros(NL * C, dtype=torch.int64, device=dev)
        ok = lane_ok[lane]
        for t in range(ktab_k):
            rb, ch = chosen(lane, cand, t)
            ok &= rb < 4
            code = code * 4 + ch.clamp(0, 3)
        row = ktab[code]
        k, l, s = row[:, 0].to(dt), row[:, 1].to(dt), row[:, 2].to(dt)
        alive = ok & (s >= 1)
        t_start = ktab_k
    else:
        rb, ch = chosen(lane, cand, 0)
        chl = ch.clamp(0, 3).long()
        k = L2c[chl] + 1
        l = L2c[3 - chl] + 1
        s = L2c[chl + 1] - L2c[chl]
        alive = lane_ok[lane] & (rb < 4) & (s >= 1)
        t_start = 1
    for t in range(t_start, seed_len):
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        rb, ch = chosen(lane[idx], cand[idx], t)
        k4, l4, s4 = fmops.forward_ext4_batch(fm, k[idx], l[idx], s[idx])
        chc = ch.clamp(0, 3)
        sn = fmops._sel(s4, chc)
        live = (rb < 4) & (sn >= 1)
        k[idx] = torch.where(live, fmops._sel(k4, chc), k[idx])
        l[idx] = torch.where(live, fmops._sel(l4, chc), l[idx])
        s[idx] = torch.where(live, sn, s[idx])
        alive[idx] = live
    big = torch.full_like(ct, BIG)
    prio = torch.where(ct < 0, big, ct * 4 + cj)[cand]
    prio = torch.where(alive, prio, -1).reshape(NL, C)
    best_p, best = prio.max(dim=1)
    pick = torch.arange(NL, device=dev) * C + best
    return seed_kernels.sa_lookup(fm, rid, x0, x0 + seed_len, k[pick],
                                  s[pick], best_p >= 0, max_occ)
