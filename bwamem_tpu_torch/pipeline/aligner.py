"""End-to-end single-end alignment on one device (torch).

Port of the native SE path of bwamem_tpu/pipeline/aligner.py:MemAligner:

  device:  batched SMEM seeding over the whole read batch (ops/seeding)
  host:    native chaining + chain->extension-job construction (C++ core)
  device:  ONE extension launch over job descriptors: the device gathers
           the query/target windows from the uploaded reads and the packed
           genome, runs the dense extension kernel, applies end_choice
  host:    L/R merge, native dedup/patch, then mark-primary + SAM text

The reads buffer uploaded for seeding travels WITH its batch (in the seed
arrays dict), never as aligner state: run_pipeline runs two collector
threads on one aligner.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..index.device import DeviceFMIndex
from ..index.format import FMIndex
from ..ops.extend import ExtendParams, extend_choose_desc
from ..ops.seeding import SeedConfig, smem_seed_batch
from ..utils.shapes import bucket_len, bucket_read_len
from .options import MemOptions

_LONG_READ = 500  # the JAX twin's per-seed SW filter threshold


class MemAligner:
    """Index in device memory, batched device stages, host post-processing.
    Single-end, default seeding (SMEM + re-seed rounds), native host core."""

    def __init__(self, opt: MemOptions, idx: FMIndex,
                 fm: DeviceFMIndex | None = None,
                 seed_cfg: SeedConfig | None = None, device="cuda"):
        self.opt = opt
        self.idx = idx
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        self.stats = {"n_reads": 0, "n_seeds": 0, "n_extensions": 0}
        # optional stage timing, set by run_pipeline
        self.timings = None
        self.fm = fm or DeviceFMIndex.from_host(idx, self.device)
        self.seed_cfg = seed_cfg or SeedConfig(
            min_seed_len=opt.min_seed_len, max_occ=opt.max_occ,
            reseed=opt.full_reseed, split_factor=opt.split_factor,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv)
        self.ext_params = ExtendParams(
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, w=opt.w, zdrop=opt.zdrop,
            end_bonus=opt.pen_clip5, opt_ext=opt.opt_ext, max_mat=opt.a)
        self._mat = torch.from_numpy(np.array(opt.mat)).to(self.device)

    def _span(self, label: str):
        return (self.timings.span(label) if self.timings is not None
                else nullcontext())

    def _check_supported(self, seqs) -> None:
        opt = self.opt
        todo = []
        if opt.seed_type != 1:
            todo.append(f"-u {opt.seed_type} (ROADMAP queue A: seeding "
                        "variants)")
        if opt.re_seed:
            todo.append("-g (ROADMAP queue A: seeding variants)")
        if opt.shd_filter:
            todo.append("-F (ROADMAP queue A: seed filters/shd/banded)")
        if max((len(s) for s in seqs), default=0) >= _LONG_READ:
            todo.append(f"reads of {_LONG_READ} bp or more (ROADMAP queue "
                        "A: seed filters/shd/banded)")
        if opt.min_chain_weight > 0 or opt.verbose >= 4:
            todo.append("-W / -v >= 4 (the per-seed-object chaining path; "
                        "ROADMAP queue A: seed filters/shd/banded)")
        if todo:
            raise NotImplementedError("not ported yet: " + "; ".join(todo))

    def seed_batch_arrays(self, seqs: list[np.ndarray]) -> dict:
        """Device seeding; returns flat seed arrays (qbeg/qend/rbeg/n_occ)
        + per-read bounds, plus the uploaded reads buffer."""
        B = len(seqs)
        L = bucket_read_len(max(len(s) for s in seqs))
        reads = np.full((B, L), 4, np.int8)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = s
            lens[i] = len(s)
        reads_t = torch.from_numpy(reads).to(self.device)
        with self._span("seed_device"):
            out = smem_seed_batch(self.fm, reads_t,
                                  torch.from_numpy(lens).to(self.device),
                                  self.seed_cfg)
            host = {k: v.cpu().numpy() for k, v in out.items()}
        self.stats["n_seeds"] += len(host["rbeg"])
        bounds = np.searchsorted(host["read_id"], np.arange(B + 1))
        return dict(qbeg=host["qbeg"], qend=host["qend"], rbeg=host["rbeg"],
                    n_occ=host["n_occ"], bounds=bounds.astype(np.int64),
                    reads_dev=(B, L, reads_t))

    def _collect_native(self, seqs, seeds):
        """Native chaining AND chain2aln job construction (flat arrays, no
        per-seed Python objects), the device extension, then the merge and
        native dedup."""
        opt, idx = self.opt, self.idx
        from ..native import loader
        from .chain import chain_batch_raw

        lib = loader.try_load()
        if lib is None:
            raise NotImplementedError(
                "the native C++ core failed to build or load; the Python "
                "fallback path is not ported (ROADMAP queue A)")
        lqs = [len(s) for s in seqs]
        with self._span("chain_native"):
            raw = chain_batch_raw(opt, idx, lqs, None, seed_arrays=seeds)
        B = len(seqs)
        L = max(lqs)
        reads = np.full((B, L), 4, np.uint8)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = s
        with self._span("chain2aln_native"):
            out = loader.chain2aln_native(
                lib, opt, idx, raw, reads.reshape(-1), L,
                np.asarray(lqs, np.int32))
        nR = out["n_regs"]
        R = out["regs"]

        self.stats["n_reads"] += B
        self.stats["n_extensions"] += out["n_jobs"]
        partL = np.zeros((nR, 3), np.int64)
        partR = np.zeros((nR, 3), np.int64)
        self._run_jobs_arrays(out, (partL, partR),
                              reads_dev=seeds["reads_dev"][2])

        # vectorized L/R merge (reference rule: src/bwamem.c:2296-2311)
        with self._span("merge_numpy"):
            sides = R["sides"][:nR].astype(np.int64)
            seedlen0 = R["seedlen0"][:nR].astype(np.int64)
            qseed = R["qseed"][:nR].astype(np.int64)
            rseed = R["rseed"][:nR]
            ext = sides > 0
            # two-sided merge subtracts the double-counted seed at its SCORE
            # (seedlen0 * a), not its length
            score = np.where(
                ext,
                partL[:, 0] + partR[:, 0] - (sides == 2) * seedlen0 * opt.a,
                R["score0"][:nR])
            qb = np.where(ext, qseed - partL[:, 1], R["qb0"][:nR])
            qe = np.where(ext, qseed + seedlen0 + partR[:, 1], R["qe0"][:nR])
            rb = np.where(ext, rseed - partL[:, 2], R["rb0"][:nR])
            re = np.where(ext, rseed + seedlen0 + partR[:, 2], R["re0"][:nR])

            sq = raw["s_qbeg"].astype(np.int64)
            sr = raw["s_rbeg"]
            sl = raw["s_len"].astype(np.int64)
            soffs = R["chain_soff"][:nR].astype(np.int64)
            nss = R["chain_ns"][:nR].astype(np.int64)
            # vectorized seedcov: (reg, seed) pair table + masked bincount
            total = int(nss.sum())
            pair_reg = np.repeat(np.arange(nR), nss)
            cum = np.zeros(nR, np.int64)
            np.cumsum(nss[:-1], out=cum[1:])
            pair_seed = np.repeat(soffs - cum, nss) + np.arange(total)
            tq = sq[pair_seed]
            tr = sr[pair_seed]
            tl = sl[pair_seed]
            pm = ((tq >= qb[pair_reg]) & (tq + tl <= qe[pair_reg])
                  & (tr >= rb[pair_reg]) & (tr + tl <= re[pair_reg]))
            scov = np.bincount(pair_reg[pm], weights=tl[pm],
                               minlength=nR).astype(np.int64)
            scov = np.where(ext, scov, R["seedcov0"][:nR])
            rids = R["rid"][:nR]
            alts = R["is_alt"][:nR]
            fracs = R["frac"][:nR]
            reads_of = R["read"][:nR]

            # native dedup + patch over the flat arrays; regions arrive
            # grouped by read (chain2aln emits reads in order)
            if reads_of.size and not (np.diff(reads_of) >= 0).all():
                raise RuntimeError(
                    "chain2aln returned regions out of read order")
            reg_off = np.searchsorted(
                reads_of, np.arange(B + 1, dtype=np.int64)).astype(np.int64)
            qlens = np.fromiter((len(q) for q in seqs), np.int64, B)
            q_off = np.zeros(B, np.int64)
            np.cumsum(qlens[:-1], out=q_off[1:])
            qstream = (np.concatenate([np.asarray(q, np.uint8) for q in seqs])
                       if B else np.zeros(0, np.uint8))
            F = dict(
                rb=np.ascontiguousarray(rb, np.int64),
                re=np.ascontiguousarray(re, np.int64),
                qb=np.ascontiguousarray(qb, np.int32),
                qe=np.ascontiguousarray(qe, np.int32),
                score=np.ascontiguousarray(score, np.int32),
                truesc=np.ascontiguousarray(score, np.int32),
                w=np.full(nR, opt.w, np.int32),
                seedcov=np.ascontiguousarray(scov, np.int32),
                sub=np.zeros(nR, np.int32),
                csub=np.zeros(nR, np.int32),
                n_comp=np.ones(nR, np.int32),
                rid=np.ascontiguousarray(rids, np.int32),
            )
        with self._span("dedup_native"):
            oi, oc = loader.dedup_patch_native(lib, opt, idx, reg_off,
                                               qstream, q_off, F)
        # survivor selection into the array-backed region container
        from .regarrays import RegArrays

        oc64 = oc.astype(np.int64)
        new_off = np.zeros(B + 1, np.int64)
        np.cumsum(oc64, out=new_off[1:])
        tot = int(new_off[-1])
        row_start = np.repeat(reg_off[:B], oc64)
        within = np.arange(tot, dtype=np.int64) - np.repeat(
            new_off[:B], oc64)
        take = oi[row_start + within]
        cols = {name: F[name][take]
                for name in ("rb", "re", "qb", "qe", "score", "truesc",
                             "sub", "csub", "w", "seedcov", "rid")}
        cols["is_alt"] = alts[take].astype(np.int8)
        cols["frac"] = np.asarray(fracs, np.float64)[take]
        return RegArrays(new_off, cols, n_comp=F["n_comp"][take])

    def _run_jobs_arrays(self, out, parts, reads_dev) -> None:
        """One device extension over the batch's jobs, shipped as
        descriptors; results land in parts[side][reg, 0:3] =
        (score, qle, tle)."""
        opt = self.opt
        J = out["jobs"]
        nJ = out["n_jobs"]
        if nJ == 0:
            return
        qlen = J["qlen"][:nJ]

        # tlen clamp to the provable DP reach (output-exact for the chosen
        # (score, qle, tle): rows past it cannot update best/qle/tle, and
        # a gscore flatlined at 0 is discarded by end_choice)
        p = self.ext_params
        q64 = qlen.astype(np.int64)
        h064 = J["h0"][:nJ].astype(np.int64)
        e_min = max(min(p.e_del, p.e_ins), 1)
        o_min = min(p.o_del, p.o_ins)
        if p.opt_ext:
            reach = q64 + int(p.w) + 1
        else:
            reach = q64 + np.maximum(
                h064 + int(p.max_mat) * q64 - o_min, 0) // e_min + 2
        tlen = np.minimum(J["tlen"][:nJ].astype(np.int64),
                          reach).astype(np.int32)

        # window widths from the READ LENGTH bucket + score params, as the
        # JAX twin does (the kernel's work follows each job's own lengths)
        Lb = reads_dev.shape[1]
        QMAX = bucket_len(Lb)
        if p.opt_ext:
            TMAX = bucket_len(QMAX + int(p.w) + 1)
        else:
            TMAX = bucket_len(
                QMAX + (int(p.max_mat) * Lb - o_min) // e_min + 2)
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        with self._span("ext_device"):
            stacked = extend_choose_desc(
                self.fm, reads_dev, up(J["read"][:nJ], np.int32),
                up(J["qstart"][:nJ], np.int32), up(qlen, np.int32),
                up(J["tstart"][:nJ], np.int64), up(tlen, np.int32),
                up(J["dir"][:nJ], np.int8), up(J["h0"][:nJ], np.int32),
                self._mat, self.ext_params, int(opt.pen_clip5), QMAX, TMAX)
            sc, qe, te = stacked.cpu().numpy()
        jreg = J["reg"][:nJ]
        jside = J["side"][:nJ]
        for side in (0, 1):
            m = jside == side
            parts[side][jreg[m], 0] = sc[m]
            parts[side][jreg[m], 1] = qe[m]
            parts[side][jreg[m], 2] = te[m]

    def collect_regs_batch(self, seqs: list[np.ndarray]):
        """Device seeding + native chaining + ONE device extension + L/R
        merge + dedup/patch, before primary marking."""
        self._check_supported(seqs)
        with self._span("seed_total"):
            seed_arr = self.seed_batch_arrays(seqs)
        with self._span("native_total"):
            return self._collect_native(seqs, seed_arr)

    def collect_pairs_batch(self, seqs, pes=None):
        raise NotImplementedError(
            "paired-end alignment is not ported yet (ROADMAP queue A: "
            "PE/pairing + swalign)")

    def emit_sam_batch(self, names, seqs, quals, per_read_regs,
                       n_processed: int = 0, comments=None) -> list[str]:
        """Mark-primary + SAM text per read in ONE native call."""
        from ..native import loader

        opt = self.opt
        cms = comments if (comments and opt.copy_comment) else None
        lib = loader.try_load()
        if lib is None:
            raise NotImplementedError(
                "the native C++ core failed to build or load")
        blob = loader.finalize_se_native(
            lib, opt, self.idx, names, seqs, quals, per_read_regs,
            n_processed, cms, getattr(opt, "rg_id", None))
        return blob.decode().splitlines()

    def align_batch(self, names: list[str], seqs: list[np.ndarray],
                    quals: list[str | None] | None = None,
                    n_processed: int = 0) -> list[str]:
        """Single-end: SAM lines (one or more per read, in input order)."""
        quals = quals or [None] * len(seqs)
        per_read_regs = self.collect_regs_batch(seqs)
        return self.emit_sam_batch(names, seqs, quals, per_read_regs,
                                   n_processed)
