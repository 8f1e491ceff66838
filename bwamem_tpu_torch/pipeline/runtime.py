"""Pipelined read -> collect -> finalize -> write runtime.

Equivalent of the reference's kt_pipeline + stream double-buffering
(reference: src/kthread.c:277-348 launched at src/fastmap.c:528, plus the
CPU-chains-batch-N+1-while-GPU-extends-batch-N software pipeline inside
mem_align1_core, src/bwamem.c:1963-2213), re-expressed at chunk
granularity:

  reader thread   -> chunks of ~chunk_bases
  collector thread-> device stages for chunk i+1 (seeding + extension +
                     rescue) while the main thread finalizes chunk i —
                     device waits release the GIL, so host work genuinely
                     overlaps device time
  main thread     -> finalization (mark-primary/pairing/CIGAR/SAM) for
                     chunk i, fanned out over the HostPool worker
                     processes (the kt_for/worker2 equivalent, -t); at
                     -t 1 on a card the CIGARs are solved there
                     (pipeline/finalize.py)
  writer thread   -> ordered SAM write

Order is preserved: chunks finalize strictly in input order.

Each chunk gets a sequence number at the reader and carries it through
both queues; its `read`, `collect`, `finalize` and `sam_write` spans, the
spans the aligner opens inside `collect` and the counter events of its
work carry it (utils/timing's chunk context), so a trace gives each
chunk's queue waits. The threads are named `reader`, `collect_<i>` and
`writer`. The last `read` span, the one that meets the end of the input,
carries the next number, which no chunk has.
"""
from __future__ import annotations

import itertools
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, TextIO

from ..io.fastx import SeqRecord, chunk_records
from ..utils import timing
from ..utils.timing import Timings

_STOP = object()


def run_pipeline(records: Iterator[SeqRecord], aligner, chunk_bases: int,
                 out: TextIO, timings: Timings | None = None,
                 queue_depth: int = 2, paired: bool = False,
                 host_pool=None, lookahead: int = 2) -> int:
    """Stream records through the aligner; returns #reads processed."""
    from . import finalize as device_finalize
    from .hostpool import HostPool

    timings = timings or Timings()
    aligner.timings = timings  # fine-grained sub-spans inside "collect"
    pool = host_pool or HostPool(aligner.opt, aligner.idx, 1)
    emitter = device_finalize.route(aligner, pool, timings) or pool
    in_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    out_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    errors: list[BaseException] = []
    # Fail-fast cancellation (reference policy: abort on any stage error,
    # seed_gen.cu:2037-2042). Set on any thread's error so the others
    # unblock promptly instead of deadlocking on a full/empty queue.
    stop = threading.Event()

    def _put(q: queue.Queue, item) -> bool:
        """stop-aware blocking put; False if cancelled while waiting."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            batches = chunk_records(records, chunk_bases, paired=paired)
            for seq in itertools.count():
                with timing.chunk(seq), timings.span("read"):
                    batch = next(batches, None)
                    if batch is not None and timing.recording():
                        timing.count("reads", len(batch))
                        timing.count("bases", sum(len(r.seq) for r in batch))
                if batch is None:
                    break
                if not _put(in_q, (seq, batch)):
                    return
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            stop.set()
        finally:
            _put(in_q, _STOP)

    def writer():
        try:
            while True:
                item = out_q.get()
                if item is _STOP:
                    return
                seq, lines = item
                with timing.chunk(seq), timings.span("sam_write"):
                    for line in lines:
                        out.write(line)
                        out.write("\n")
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            stop.set()
            # keep draining so finalize's out_q.put never blocks forever
            while out_q.get() is not _STOP:
                pass

    def collect(seq, batch):
        names = [r.name for r in batch]
        seqs = [r.seq for r in batch]
        quals = [r.qual for r in batch]
        comments = [r.comment for r in batch]
        with timing.chunk(seq), timings.span("collect"):
            if paired:
                regs, pes = aligner.collect_pairs_batch(seqs)
            else:
                regs, pes = aligner.collect_regs_batch(seqs), None
        return names, seqs, quals, regs, pes, comments

    def finalize(seq, res, n_processed):
        names, seqs, quals, regs, pes, comments = res
        with timing.chunk(seq), timings.span("finalize"):
            if paired:
                lines = emitter.emit_pe(names, seqs, quals, regs, pes,
                                        n_processed, comments)
            else:
                lines = emitter.emit_se(names, seqs, quals, regs,
                                        n_processed, comments)
        return seq, lines

    rt = threading.Thread(target=reader, name="reader", daemon=True)
    wt = threading.Thread(target=writer, name="writer", daemon=True)
    rt.start()
    wt.start()

    n_processed = 0
    # two collector threads: chunk i+1's device stages overlap chunk i's
    # host stages (device waits drop the GIL); at most 2 chunks in flight.
    # lookahead=0 (the -1 flag / reference no_mt_io) finalizes each chunk
    # before the next one is collected — strictly serial.
    collector = ThreadPoolExecutor(max(1, min(2, lookahead)),
                                   thread_name_prefix="collect")
    try:
        from collections import deque

        pending: deque = deque()  # (future, n_reads_at_start, chunk id)
        while not stop.is_set():
            try:
                item = in_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is _STOP:
                break
            seq, batch = item
            pending.append((collector.submit(collect, seq, batch),
                            n_processed, seq))
            n_processed += len(batch)
            while (len(pending) > lookahead
                   or (pending and pending[0][0].done())):
                prev_fut, prev_n, prev_seq = pending.popleft()
                _put(out_q, finalize(prev_seq, prev_fut.result(), prev_n))
                print(f"[bwamem-tpu] processed {n_processed} reads...",
                      file=sys.stderr)
        while pending and not stop.is_set():
            prev_fut, prev_n, prev_seq = pending.popleft()
            _put(out_q, finalize(prev_seq, prev_fut.result(), prev_n))
    finally:
        stop_was_error = stop.is_set() or bool(errors)
        collector.shutdown(wait=False)
        # unblock + terminate the writer; it drains on its own error path
        while True:
            try:
                out_q.put(_STOP, timeout=0.2)
                break
            except queue.Full:
                if stop_was_error:
                    # a dead-but-drained writer already returned; don't spin
                    if not wt.is_alive():
                        break
        wt.join(timeout=5.0)
        stop.set()  # release the reader from any blocked put
        rt.join(timeout=5.0)
    if errors:
        raise errors[0]
    return n_processed
