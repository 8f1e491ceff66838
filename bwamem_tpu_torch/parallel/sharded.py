"""Data parallel alignment over the GPUs of one process.

Port of bwamem_tpu/parallel/sharded.py. The JAX module puts a process's
local devices in a jax.sharding.Mesh: the index is replicated on each
device, reads are split into contiguous ranges, and results come back in
range order. Torch needs no collective for that. A Mesh here is the
ordered tuple of devices; each shard's work runs on its own device, the
shards one after another on the calling thread (each device's work is
queued asynchronously, but the seeding's host syncs serialize the
shards), and the host concatenates the results in shard order. The
JAX version's two reductions become host arithmetic: the total seed
count (its psum) and the largest cand_pool a shard's -g walk grew to (its
pmax of the pool multipliers), on which every shard walks.

Multi-host scale-out is a separate layer (multihost.py): hosts own
disjoint read ranges, so nothing crosses hosts.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, fields, replace

import torch

from ..index.device import _STATIC, DeviceFMIndex
from ..models.mem import AlignStepConfig, device_align_step

SEED_KEYS = ("read_id", "qbeg", "qend", "rbeg", "n_occ")


@dataclass(frozen=True)
class Mesh:
    devices: tuple      # torch.device of each shard, in shard order
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n: int | None = None, device="cuda",
              axis: str = "data") -> Mesh:
    """A data-parallel mesh of the process's own devices: cuda:0..n-1
    (every visible card when n is None or 0), or n shards on the one CPU
    (device="cpu"; the tests' stand-in for several devices). Raises when
    more cards are asked for than are visible."""
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        n = n or have
        if have == 0 or n > have:
            raise RuntimeError(f"{n or 'all'} GPUs asked for, {have} "
                               "visible")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    elif kind == "cpu":
        devs = (torch.device("cpu"),) * (n or 1)
    else:
        raise ValueError(f"unsupported device {device}")
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, axis)


def _on(dev: torch.device):
    """The device a shard's kernels launch on (the wrappers take the
    stream of their inputs' device; the launch needs it current)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _map_shards(mesh: Mesh, fn) -> list:
    """[fn(k) for each shard k], with shard k's device current."""
    out = []
    for k, dev in enumerate(mesh.devices):
        with _on(dev):
            out.append(fn(k))
    return out


def _index_on(fm: DeviceFMIndex, dev: torch.device) -> DeviceFMIndex:
    if fm.occ_blocks.device == dev:
        return fm
    return DeviceFMIndex(**{
        f.name: (getattr(fm, f.name) if f.name in _STATIC
                 else getattr(fm, f.name).to(dev)) for f in fields(fm)})


def replicate_index(mesh: Mesh, fm: DeviceFMIndex) -> list:
    """One DeviceFMIndex a shard, on its device (shards that share a
    device share one copy)."""
    copies: dict = {}
    return [copies.setdefault(str(dev), _index_on(fm, dev))
            for dev in mesh.devices]


def shard_reads(mesh: Mesh, reads, lens):
    """Pad the batch to a multiple of the mesh size (code 4, length 0)
    and split it by contiguous range, shard k's slice on its device.
    Returns (reads of each shard, lens of each shard, B)."""
    reads, lens = torch.as_tensor(reads), torch.as_tensor(lens)
    n = mesh.size
    B = reads.shape[0]
    Bp = -(-B // n) * n
    if Bp != B:
        reads = torch.cat([reads, torch.full(
            (Bp - B, reads.shape[1]), 4, dtype=reads.dtype,
            device=reads.device)])
        lens = torch.cat([lens, torch.zeros(Bp - B, dtype=lens.dtype,
                                            device=lens.device)])
    b_loc = Bp // n
    rs = [reads[k * b_loc:(k + 1) * b_loc].to(dev)
          for k, dev in enumerate(mesh.devices)]
    ls = [lens[k * b_loc:(k + 1) * b_loc].to(dev)
          for k, dev in enumerate(mesh.devices)]
    return rs, ls, B


def sharded_align_step(mesh: Mesh, cfg: AlignStepConfig = AlignStepConfig(),
                       gather_out: bool = True):
    """Returns a function (fms, reads, lens) -> (outputs, total seeds)
    over shard lists (replicate_index, shard_reads): device_align_step
    on each shard's device. With gather_out the per-read outputs are
    concatenated in range order on the mesh's first device; without, a
    list of each shard's outputs on its own device. The total is the sum
    of the shards' n_seeds (the JAX version's psum), an int."""

    def call(fms, reads, lens):
        outs = _map_shards(mesh, lambda k: device_align_step(
            fms[k], reads[k], lens[k], cfg))
        total = sum(int(o.pop("n_seeds")) for o in outs)
        if not gather_out:
            return outs, total
        dev0 = mesh.devices[0]
        return ({key: torch.cat([o[key].to(dev0) for o in outs])
                 for key in outs[0]}, total)

    return call


def sharded_seed_batch(mesh: Mesh, fms: list, reads, lens, cfg):
    """Seeding over the mesh: reads split by contiguous range
    (shard_reads), ops.seeding.smem_seed_batch on each shard's device
    with the shard's read count as its pool's, read ids rebased to the
    batch's, concatenated in shard order on the first device (the flat
    seed arrays of smem_seed_batch). A -g walk compacts on the largest
    cand_pool any shard grew to, as the JAX retry grows every shard's
    pool by the largest multiplier: a shard that grew less seeds again
    on it. Adds counts, the (c_need, seeds) of each shard, and
    pool_reads, the shard's read count; cand_pool is the common pool and
    c_need the total."""
    from ..ops.seeding import smem_seed_batch

    rs, ls, _ = shard_reads(mesh, reads, lens)
    b_loc = rs[0].shape[0]

    def seed(k, c):
        with _on(mesh.devices[k]):
            return smem_seed_batch(fms[k], rs[k], ls[k], c,
                                   pool_reads=b_loc)

    outs = [seed(k, cfg) for k in range(mesh.size)]
    cand = max(o["cand_pool"] for o in outs)
    outs = [o if o["cand_pool"] == cand
            else seed(k, replace(cfg, cand_pool=cand))
            for k, o in enumerate(outs)]
    dev0 = mesh.devices[0]
    out = {key: torch.cat([o[key].to(dev0) for o in outs])
           for key in SEED_KEYS}
    out["read_id"] = torch.cat([o["read_id"].to(dev0) + k * b_loc
                                for k, o in enumerate(outs)])
    out["cand_pool"] = cand
    out["counts"] = [(o["c_need"], o["qbeg"].shape[0]) for o in outs]
    out["pool_reads"] = b_loc
    out["c_need"] = sum(o["c_need"] for o in outs)
    return out


def _job_ranges(mesh: Mesh, n_jobs: int) -> list:
    """Contiguous (lo, hi) job ranges, one a shard."""
    per = -(-n_jobs // mesh.size)
    return [(min(k * per, n_jobs), min((k + 1) * per, n_jobs))
            for k in range(mesh.size)]


def sharded_extend_batch(mesh: Mesh, query, target, qlen, tlen, h0, mat,
                         params):
    """ops.extend.extend_batch_auto over the mesh: the jobs split by
    contiguous range, each range extended on its shard's device, the
    fields concatenated in job order on the device of query."""
    from ..ops.extend import extend_batch_auto

    if query.shape[0] == 0:
        return extend_batch_auto(query, target, qlen, tlen, h0, mat, params)
    ranges = _job_ranges(mesh, query.shape[0])

    def run(k):
        lo, hi = ranges[k]
        if lo == hi:
            return None
        dev = mesh.devices[k]
        return extend_batch_auto(
            *(x[lo:hi].to(dev).contiguous()
              for x in (query, target, qlen, tlen, h0)), mat.to(dev), params)

    outs = [o for o in _map_shards(mesh, run) if o is not None]
    return {key: torch.cat([o[key].to(query.device) for o in outs])
            for key in outs[0]}


def sharded_extend_choose_desc(mesh: Mesh, fms: list, reads_dev, j_read,
                               j_qstart, j_qlen, j_tstart, j_tlen, j_dir,
                               h0, mat, params, pen_clip: int, qmax: int,
                               tmax: int):
    """ops.extend.extend_choose_desc over the mesh: the job descriptors
    split by contiguous range; each shard gathers its windows from its
    copy of the reads and its replica of the index, extends them on its
    device and applies end_choice. Returns the stacked (3, N) int32
    (score, qle, tle) in job order on the device of j_read."""
    from ..ops.extend import extend_choose_desc

    jobs = (j_read, j_qstart, j_qlen, j_tstart, j_tlen, j_dir, h0)
    ranges = _job_ranges(mesh, j_read.shape[0])
    reads_on = {}

    def run(k):
        lo, hi = ranges[k]
        if lo == hi:
            return None
        dev = mesh.devices[k]
        reads_k = reads_on.setdefault(str(dev), reads_dev.to(dev))
        return extend_choose_desc(
            fms[k], reads_k, *(x[lo:hi].to(dev) for x in jobs), mat.to(dev),
            params, pen_clip, qmax, tmax).to(j_read.device)

    outs = [o for o in _map_shards(mesh, run) if o is not None]
    if not outs:
        return torch.zeros((3, 0), dtype=torch.int32, device=j_read.device)
    return torch.cat(outs, dim=1)
