"""Multi-host (N>=2 processes) data path.

The reference is strictly single-node — SURVEY §2.5 lists "distributed
comm backend" as the one TPU-native ADDITION this framework owes beyond
the fork's pthread pool (src/kthread.c) + single-GPU design. BWA-MEM is
data-parallel over reads, so the TPU-native scale-out keeps ALL traffic
off the cross-host network:

  * `jax.distributed.initialize` wires the processes into one runtime
    (control plane only — heartbeats, barrier at init);
  * each host takes a CONTIGUOUS record range [lo, hi) of the input
    (pair-aligned for PE) and aligns it on its LOCAL chips via the
    per-host `make_mesh` (parallel/sharded.py);
  * each host writes an ordered SAM shard `<out>.shard<k>` + a `.done`
    sentinel; host 0 concatenates the shards in rank order. Range
    sharding preserves global input order, so the merge is a cat.

Insert-size estimation stays per-host per-chunk — identical semantics to
vanilla bwa, whose pestat is re-estimated per ~chunk of reads
(reference: src/bwamem_pair.c:119-153 mem_pestat called per batch), so
host boundaries behave exactly like chunk boundaries.

Scaling model: zero cross-host bytes on the data path -> efficiency is
bounded only by range skew (equal record counts; upstream length
bucketing evens the per-read cost) and the final cat, which is
sequential file IO on host 0.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Iterable, Iterator


@dataclass(frozen=True)
class HostShard:
    """This process's slot in the multi-host run."""
    rank: int
    world: int

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def init_distributed(coordinator: str | None, world: int,
                     rank: int) -> None:
    """Join a torch.distributed process group over Gloo (control plane
    only: it needs no second card and touches no CUDA context; the
    caller leaves it with torch.distributed.destroy_process_group).
    Optional: the data path never crosses hosts, so runs without a
    coordinator (e.g. mpirun-style launches that only share a
    filesystem) work too."""
    import torch.distributed as dist

    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)


def record_range(n_records: int, rank: int, world: int,
                 granularity: int = 1) -> tuple[int, int]:
    """Contiguous [lo, hi) record range for `rank`, with lo/hi multiples
    of `granularity` (2 for paired input so mates never split across
    hosts). The last rank absorbs the remainder."""
    if world <= 1:
        return 0, n_records
    units = n_records // granularity
    per = units // world
    extra = units % world
    lo_u = rank * per + min(rank, extra)
    hi_u = lo_u + per + (1 if rank < extra else 0)
    lo, hi = lo_u * granularity, hi_u * granularity
    if rank == world - 1:
        hi = n_records  # trailing unpaired record (caller errors on it)
    return lo, hi


def take_range(records: Iterable, lo: int, hi: int) -> Iterator:
    """Slice [lo, hi) out of a record stream. Records outside the range
    are parsed and dropped — parse cost is ~100x below alignment cost,
    so O(file) parse per host is noise next to the 1/world alignment
    share."""
    for i, rec in enumerate(records):
        if i >= hi:
            return
        if i >= lo:
            yield rec


def count_records(path: str) -> int:
    """Total record count of a FASTA/FASTQ file (plain or gzip). One
    parse pass via the native scanner when available."""
    from ..io.fastx import read_fastx

    return sum(1 for _ in read_fastx(path))


def shard_path(out: str, rank: int) -> str:
    return f"{out}.shard{rank}"


def mark_done(out: str, rank: int) -> None:
    with open(shard_path(out, rank) + ".done", "w") as f:
        f.write("ok\n")


def merge_shards(out: str, world: int, timeout: float = 86400.0,
                 poll: float = 0.5, keep_shards: bool = False) -> None:
    """Host 0: wait for every shard's .done sentinel, then concatenate
    shards in rank order into `out` (stdout when out is '-'). Shards are
    removed afterwards unless keep_shards."""
    import shutil
    import sys

    deadline = time.monotonic() + timeout
    for r in range(world):
        sentinel = shard_path(out, r) + ".done"
        while not os.path.exists(sentinel):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shard {r} ({shard_path(out, r)}) not done within "
                    f"{timeout:.0f}s")
            time.sleep(poll)
    sink = sys.stdout if out == "-" else open(out, "w")
    try:
        for r in range(world):
            with open(shard_path(out, r)) as f:
                shutil.copyfileobj(f, sink, length=1 << 20)
    finally:
        if sink is not sys.stdout:
            sink.close()
    if not keep_shards:
        for r in range(world):
            os.unlink(shard_path(out, r))
            os.unlink(shard_path(out, r) + ".done")
