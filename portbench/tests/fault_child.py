"""child.py with one fault planted in the program's timed path, named by
the PORTBENCH_FAULT environment variable, for the tests that the check
catches it (with PORTBENCH_SMALL_BLOCK set, the FASTQ reader takes
small_block_child.py's blocks) and for `control.py --fault` on the card:

- `half`: the aligner is given only the first half of each chunk (the
  rest as all-N reads, which nothing seeds), so half the batch comes out
  unaligned;
- `stale`: the aligner returns the previous chunk's regions unchanged, a
  step that keeps its state;
- `alter`: every AS tag is changed by one where the SAM text is made;
- `norescue`: mate rescue returns at once, having placed no mate.
"""
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def plant(fault: str) -> None:
    import numpy as np

    from bwamem_tpu_torch.pipeline import aligner, hostpool, pairing

    A = aligner.MemAligner
    if fault == "half":
        def halve(fn):
            def wrapped(self, seqs, *a, **k):
                keep = (len(seqs) // 2) & ~1
                seqs = list(seqs[:keep]) + [np.full_like(s, 4)
                                            for s in seqs[keep:]]
                return fn(self, seqs, *a, **k)
            return wrapped
        A.collect_regs_batch = halve(A.collect_regs_batch)
        A.collect_pairs_batch = halve(A.collect_pairs_batch)
    elif fault == "stale":
        def stale(fn):
            last = {}

            def wrapped(self, seqs, *a, **k):
                out = fn(self, seqs, *a, **k)
                prev = last.get(len(seqs))
                last[len(seqs)] = out
                return out if prev is None else prev
            return wrapped
        A.collect_regs_batch = stale(A.collect_regs_batch)
        A.collect_pairs_batch = stale(A.collect_pairs_batch)
    elif fault == "alter":
        pat = re.compile(r"AS:i:(\d+)")

        def alter(fn):
            def wrapped(*a, **k):
                return [pat.sub(lambda m: f"AS:i:{int(m[1]) + 1}", b)
                        for b in fn(*a, **k)]
            return wrapped
        hostpool.HostPool.emit_se = alter(hostpool.HostPool.emit_se)
        hostpool.HostPool.emit_pe = alter(hostpool.HostPool.emit_pe)
    elif fault == "norescue":
        pairing.mem_pe_rescue_batch = lambda *a, **k: 0
    else:
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    if os.environ.get("PORTBENCH_SMALL_BLOCK"):
        from bwamem_tpu_torch.io import fastx

        import small_block_child

        fastx._read_fastx_native.__defaults__ = (small_block_child.BLOCK,)
    plant(os.environ["PORTBENCH_FAULT"])
    import child

    sys.exit(child.main())
