"""Host worker pool for the per-read finalization stage.

TPU-native stand-in for the reference's kt_for thread pool running worker2
(reference: src/kthread.c:240 kt_for + src/bwamem.c:2451-2469 worker2,
launched at :2512). Python threads cannot parallelize this CPU-bound stage
(GIL), so the pool forks worker processes. Two constraints shape the
design:

  * fork must happen BEFORE any JAX/TPU client initialization (forking a
    process with live device-runtime threads can deadlock the children),
    so the pool is built from (options, host FMIndex) only — the emit
    stage touches NumPy and the native C++ kernels, never the device;
  * the index is inherited copy-on-write, so per-task traffic is only the
    small per-read region lists.

Dynamic chunking plays the role of the reference's shrinking batches +
work stealing (src/kthread.c:59-222): idle workers pull the next slice.
"""
from __future__ import annotations

import os

_STATE = None  # (opt, idx) in workers, set pre-fork


def _emit_se(opt, idx, names, seqs, quals, regs_lists, n_processed,
             comments=None, native=True):
    # jax-free imports only: emit workers must never pull in jax/device code
    cms = (comments if (comments and opt.copy_comment) else None)
    rg = getattr(opt, "rg_id", None)
    if native:
        from ..native import loader

        lib = loader.try_load()
        if lib is not None:
            blob = loader.finalize_se_native(
                lib, opt, idx, names, seqs, quals, regs_lists,
                n_processed, cms, rg)
            return blob.decode().splitlines()
    from .regions import mem_mark_primary_se
    from .samgen import mem_reg2sam_batch

    marked = []
    for b in range(len(seqs)):
        regs, _ = mem_mark_primary_se(opt, regs_lists[b], n_processed + b)
        marked.append(regs)
    return mem_reg2sam_batch(opt, idx, names, seqs, quals, marked,
                             comments=cms, rg_id=rg)


def _emit_pe(opt, idx, names, seqs, quals, pair_regs, pes, pair_id0,
             comments=None, native=True):
    cms = (comments if (comments and opt.copy_comment) else None)
    rg = getattr(opt, "rg_id", None)
    if native:
        from ..native import loader

        lib = loader.try_load()
        if lib is not None:
            blob = loader.finalize_pe_native(
                lib, opt, idx, pes, names, seqs, quals, pair_regs,
                pair_id0, cms, rg)
            return blob.decode().splitlines()
    from .pairing import Reg2AlnCtx, mem_sam_pe_plan, mem_sam_pe_render

    # slice-level batching: plan all pairs, ONE native reg2aln solve,
    # then render (the SE path does the same via mem_reg2sam_batch)
    ctx = Reg2AlnCtx(opt, idx)
    plans = []
    for i in range(len(pair_regs)):
        cm = (cms[i * 2 : i * 2 + 2] if cms else None)
        plans.append(mem_sam_pe_plan(
            opt, idx, pes, pair_id0 + i,
            names[i * 2 : i * 2 + 2], seqs[i * 2 : i * 2 + 2],
            quals[i * 2 : i * 2 + 2], pair_regs[i], ctx, comments=cm))
    ctx.solve()
    out = []
    for plan in plans:
        l0, l1 = mem_sam_pe_render(opt, idx, plan, ctx, rg_id=rg)
        out.extend(l0)
        out.extend(l1)
    return out


def _se_task(args):
    opt, idx = _STATE
    lo, names, seqs, quals, regs, n_processed, comments = args
    # one joined blob per slice: the main process unpickles 1 string per
    # task instead of ~2 per read (GIL relief for the collector thread)
    return "\n".join(_emit_se(opt, idx, names, seqs, quals, regs,
                              n_processed + lo, comments))


def _pe_task(args):
    opt, idx = _STATE
    lo_pair, names, seqs, quals, pair_regs, pes, n_pairs_done, comments = args
    return "\n".join(_emit_pe(opt, idx, names, seqs, quals, pair_regs, pes,
                              n_pairs_done + lo_pair, comments))


class HostPool:
    """Fork-based pool over the finalization stage. Build this BEFORE the
    device aligner so the fork happens pre-JAX. n_threads <= 1 runs
    inline."""

    def __init__(self, opt, idx, n_threads: int = 1):
        global _STATE
        # clamp to physical CPUs: oversubscribing forked workers on a
        # small host burns time in context switches instead of work
        self.n = max(min(int(n_threads), os.cpu_count() or 1), 1)
        self.opt = opt
        self.idx = idx
        self._pool = None
        if self.n > 1 and hasattr(os, "fork"):
            import multiprocessing as mp

            _STATE = (opt, idx)
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(self.n)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def _slices(self, n_items: int):
        """Dynamic slice sizes (reference: shrinking READ_BATCH_SIZE,
        src/kthread.c:163-178): ~4 slices per worker for balance."""
        step = max(n_items // (self.n * 4), 16)
        return [(lo, min(lo + step, n_items))
                for lo in range(0, n_items, step)]

    def emit_se(self, names, seqs, quals, per_read_regs,
                n_processed: int, comments=None) -> list[str]:
        if self._pool is None:
            return _emit_se(self.opt, self.idx, names, seqs, quals,
                            per_read_regs, n_processed, comments)
        tasks = [(lo, names[lo:hi], seqs[lo:hi], quals[lo:hi],
                  per_read_regs[lo:hi], n_processed,
                  comments[lo:hi] if comments else None)
                 for lo, hi in self._slices(len(seqs))]
        return [b for b in self._pool.map(_se_task, tasks) if b]

    def emit_pe(self, names, seqs, quals, pair_regs, pes,
                n_processed: int, comments=None) -> list[str]:
        if self._pool is None:
            return _emit_pe(self.opt, self.idx, names, seqs, quals,
                            pair_regs, pes, n_processed >> 1, comments)
        tasks = [(lo, names[lo * 2 : hi * 2], seqs[lo * 2 : hi * 2],
                  quals[lo * 2 : hi * 2], pair_regs[lo:hi], pes,
                  n_processed >> 1,
                  comments[lo * 2 : hi * 2] if comments else None)
                 for lo, hi in self._slices(len(pair_regs))]
        return [b for b in self._pool.map(_pe_task, tasks) if b]
