"""Command-line interface: `index` and `align` of single-end reads or of
pairs (two files, or one interleaved file with -p; `gase_aln` and `mem`
accepted as aliases), with the JAX package's flags plus --device.

Multi-device runs and the seeding/filter variants that are not ported yet
exit with a one-line error naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import __version__

PROG = "bwamem-tpu-torch"


def _add_align_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("index_prefix")
    p.add_argument("reads", help="FASTA/FASTQ query file")
    p.add_argument("mates", nargs="?", default=None,
                   help="mate FASTA/FASTQ for paired-end")
    p.add_argument("-t", type=int, default=1, dest="n_threads",
                   help="host worker threads")
    p.add_argument("--n-chips", type=int, default=1, dest="n_chips",
                   help="data-parallel device count (only 1 so far)")
    p.add_argument("--n-hosts", type=int, default=1, dest="n_hosts",
                   help="multi-host world size (only 1 so far)")
    p.add_argument("--host-id", type=int, default=None, dest="host_id",
                   help="this process's rank in 0..n_hosts-1")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port")
    p.add_argument("--keep-shards", action="store_true",
                   help="keep per-host SAM shards after the merge")
    p.add_argument("-k", type=int, default=None, dest="min_seed_len")
    p.add_argument("-w", type=int, default=300, dest="band_width")
    p.add_argument("-A", type=int, default=None, dest="match")
    p.add_argument("-B", type=int, default=None, dest="mismatch")
    p.add_argument("-O", default=None, dest="gap_open")
    p.add_argument("-E", default=None, dest="gap_ext")
    p.add_argument("-L", default=None, dest="clip_pen")
    p.add_argument("-T", type=int, default=30, dest="min_score")
    p.add_argument("-W", type=int, default=None, dest="min_chain_weight")
    p.add_argument("-x", default=None, dest="read_type",
                   choices=("intractg", "pacbio", "pbref", "ont2d"),
                   help="read-type presets (gap/mismatch/seed profiles)")
    p.add_argument("-e", type=int, default=0, dest="dp_type",
                   choices=(0, 1, 2, 3),
                   help="extension algorithm selector (fork -e flag; all "
                        "values run the batched device ksw-extend path)")
    p.add_argument("-d", type=int, default=0, dest="zdrop")
    p.add_argument("-c", type=int, default=500, dest="max_occ")
    p.add_argument("-K", type=int, default=10_000_000, dest="chunk_size")
    p.add_argument("-a", action="store_true", dest="all_alignments",
                   help="output all alignments (SE only)")
    p.add_argument("-M", action="store_true", dest="mark_short_split",
                   help="mark shorter split hits as secondary")
    p.add_argument("-U", type=int, default=None, dest="pen_unpaired",
                   help="penalty for an unpaired read pair")
    p.add_argument("-D", type=float, default=None, dest="drop_ratio",
                   help="drop secondary alignments below max_score*FLOAT")
    p.add_argument("-m", type=int, default=None, dest="max_matesw",
                   help="max mate-rescue rounds per read")
    p.add_argument("--xa-hits", default=None, dest="max_xa_hits",
                   help="max XA hits INT[,INT for ALT] (-h in the reference)")
    p.add_argument("-s", type=int, default=None, dest="split_width",
                   help="split width (reserved; all-MEM mode covers re-seeding)")
    p.add_argument("-r", type=float, default=None, dest="split_factor",
                   help="split factor")
    p.add_argument("-G", type=int, default=None, dest="max_chain_gap",
                   help="max chain gap")
    p.add_argument("-X", type=float, default=None, dest="mask_level",
                   help="chain overlap mask level")
    p.add_argument("-H", default=None, dest="header_insert",
                   help="insert STR (if it starts with @) or lines of FILE "
                        "into the SAM header")
    p.add_argument("-z", action="store_true", dest="use_avx2",
                   help="(reference: AVX2 SW path; no-op here — extension "
                        "always runs the batched device kernel)")
    p.add_argument("-l", type=int, default=None, dest="read_len",
                   help="(reference: read length for timing reports; "
                        "detected automatically here)")
    # NB -P/-S follow the reference exactly (src/fastmap.c:176,180:
    # 'P' -> MEM_F_NOPAIRING, 'S' -> MEM_F_NO_RESCUE), matching vanilla
    # bwa mem's documented semantics.
    p.add_argument("-P", action="store_true", dest="skip_pairing",
                   help="skip pairing; mate rescue performed unless -S also in use")
    p.add_argument("-S", action="store_true", dest="skip_rescue",
                   help="skip mate rescue (with -P: fully SE-like PE)")
    p.add_argument("-p", action="store_true", dest="smart_pairing",
                   help="smart pairing: reads file is interleaved PE")
    p.add_argument("-Y", action="store_true", dest="softclip_supp")
    # remaining reference getopt letters (src/fastmap.c:166); -b is in
    # the fork's getopt string but has no case -> dead letter, omitted;
    # -h (max XA hits) is spelled --xa-hits (argparse reserves -h)
    p.add_argument("-1", action="store_true", dest="no_mt_io",
                   help="disable pipeline lookahead (chunks process "
                        "strictly serially; reference: no_mt_io)")
    p.add_argument("-j", action="store_true", dest="ignore_alt",
                   help="treat ALT contigs as primary (ignore .alt)")
    p.add_argument("-Q", type=int, default=None, dest="mapq_coef_len",
                   help="mapQ coefficient length (0: seedcov formula)")
    p.add_argument("-N", type=int, default=None, dest="max_chain_extend",
                   help="cap on chains taken to extension")
    p.add_argument("-y", type=int, default=None, dest="max_mem_intv",
                   help="round-3 seeding occurrence threshold")
    p.add_argument("-V", action="store_true", dest="ref_hdr",
                   help="output the reference FASTA description in XR:Z")
    p.add_argument("-C", action="store_true", dest="copy_comment",
                   help="append FASTA/FASTQ comment to SAM output")
    p.add_argument("-I", default=None, dest="insert_spec",
                   help="fixed FR insert size: mean[,std[,max[,min]]] "
                        "(skips per-chunk inference)")
    p.add_argument("-F", action="store_true", dest="shd_filter",
                   help="SHD (shifted-Hamming-distance) seed pre-filter")
    p.add_argument("-u", type=int, default=1, dest="seed_type",
                   choices=(1, 2, 3, 4),
                   help="seeding: 1=SMEM 2=fixed exact 3=forward MEM "
                        "4=fixed <=1-mismatch")
    p.add_argument("-J", type=int, default=0, dest="seed_intv",
                   help="seed start interval for -u 2/4 [min_seed_len]")
    p.add_argument("-g", action="store_true", dest="re_seed",
                   help="all-MEM seeding (keep nested matches)")
    p.add_argument("-R", default=None, dest="rg_line",
                   help="read group header line such as '@RG\\tID:foo'")
    p.add_argument("-v", type=int, default=3, dest="verbosity")
    p.add_argument("-f", default=None, dest="timing_file",
                   help="append a timing TSV row to this file")
    p.add_argument("-o", default=None, dest="output")
    p.add_argument("--no-reseed", action="store_true", dest="no_reseed",
                   help="disable vanilla bwa's 2nd/3rd seeding rounds "
                        "(split re-seed + LAST-like), restoring the "
                        "fork's round-1-only GPUSeed behavior")
    p.add_argument("--vanilla", action="store_true",
                   help="vanilla bwa-mem defaults (w=100, zdrop=100)")
    p.add_argument("--seed-cands", type=int, default=48,
                   help="accepted for compatibility; seed compaction is "
                        "exact here, with no fixed pools")
    p.add_argument("--seed-cap", type=int, default=8,
                   help="accepted for compatibility; seed compaction is "
                        "exact here, with no fixed pools")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages [cuda]; there "
                        "is no automatic fallback to the CPU")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog=PROG, description="BWA-MEM-class short-read aligner (PyTorch)")
    ap.add_argument("--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build the FMD index")
    pi.add_argument("fasta")
    pi.add_argument("-p", default=None, dest="prefix",
                    help="index prefix [fasta path]")
    pi.add_argument("-r", type=int, default=4, dest="sa_intv",
                    help="suffix-array sampling interval (power of 2)")

    for name in ("align", "gase_aln", "mem"):
        pa = sub.add_parser(name, help="align single- or paired-end reads")
        _add_align_args(pa)

    args = ap.parse_args(argv)
    try:
        if args.cmd == "index":
            return cmd_index(args)
        return cmd_align(args)
    except (FileNotFoundError, IsADirectoryError, PermissionError,
            ValueError, EOFError, NotImplementedError) as e:
        # expected operational failures get one line, not a traceback
        print(f"[{PROG}] error: {e}", file=sys.stderr)
        return 1


def cmd_index(args) -> int:
    from .index.build import build_index

    t0 = time.perf_counter()
    idx = build_index(args.fasta, sa_intv=args.sa_intv)
    prefix = args.prefix or args.fasta
    idx.save(prefix + ".bmt")
    print(
        f"[{PROG}] indexed {idx.l_pac} bp "
        f"({len(idx.ann.names)} sequences) in "
        f"{time.perf_counter() - t0:.1f}s -> {prefix}.bmt.npz",
        file=sys.stderr,
    )
    return 0


def _sam_header(idx, rg_line: str | None, cmdline: str) -> list[str]:
    """reference: src/bwa.c:389 bwa_print_sam_hdr."""
    lines = [
        f"@SQ\tSN:{n}\tLN:{l}"
        for n, l in zip(idx.ann.names, idx.ann.lengths)
    ]
    if rg_line:
        lines.append(rg_line.replace("\\t", "\t"))
    lines.append(f"@PG\tID:{PROG}\tPN:{PROG}\tVN:{__version__}\tCL:{cmdline}")
    return lines


def _options(args):
    """MemOptions from the align flags (the JAX CLI's rules)."""
    from .pipeline.options import (MemOptions, MEM_F_ALL, MEM_F_NO_RESCUE,
                                   MEM_F_NOPAIRING, MEM_F_PE,
                                   MEM_F_SOFTCLIP)

    opt = MemOptions.vanilla() if args.vanilla else MemOptions()
    opt.w = args.band_width if not args.vanilla or args.band_width != 300 \
        else opt.w

    def _pair(v):
        parts = str(v).split(",")
        return (int(parts[0]), int(parts[1] if len(parts) > 1 else parts[0]))

    # user-set values first, then -x profile fills what the user left
    # unset (reference: src/fastmap.c:351-380 mode block + update_a)
    if args.min_seed_len is not None:
        opt.min_seed_len = args.min_seed_len
    if args.match is not None:
        opt.a = args.match
    if args.mismatch is not None:
        opt.b = args.mismatch
    if args.gap_open is not None:
        opt.o_del, opt.o_ins = _pair(args.gap_open)
    if args.gap_ext is not None:
        opt.e_del, opt.e_ins = _pair(args.gap_ext)
    if args.clip_pen is not None:
        opt.pen_clip5, opt.pen_clip3 = _pair(args.clip_pen)
    if args.min_chain_weight is not None:
        opt.min_chain_weight = args.min_chain_weight
    prof = args.read_type
    if prof == "intractg":
        if args.gap_open is None:
            opt.o_del = opt.o_ins = 16
        if args.mismatch is None:
            opt.b = 9
        if args.clip_pen is None:
            opt.pen_clip5 = opt.pen_clip3 = 5
    elif prof in ("pacbio", "pbref", "ont2d"):
        if args.gap_open is None:
            opt.o_del = opt.o_ins = 1
        if args.gap_ext is None:
            opt.e_del = opt.e_ins = 1
        if args.mismatch is None:
            opt.b = 1
        opt.split_factor = 10.0
        if args.min_chain_weight is None:
            opt.min_chain_weight = 20 if prof == "ont2d" else 40
        if args.min_seed_len is None:
            opt.min_seed_len = 14 if prof == "ont2d" else 17
        if args.clip_pen is None:
            opt.pen_clip5 = opt.pen_clip3 = 0
    elif args.match is not None and args.match != 1:
        # -A alone rescales unset dependent penalties (update_a)
        if args.mismatch is None:
            opt.b *= opt.a
        if args.gap_open is None:
            opt.o_del *= opt.a
            opt.o_ins *= opt.a
        if args.gap_ext is None:
            opt.e_del *= opt.a
            opt.e_ins *= opt.a
        if args.clip_pen is None:
            opt.pen_clip5 *= opt.a
            opt.pen_clip3 *= opt.a
        opt.zdrop *= opt.a
        opt.pen_unpaired *= opt.a
        opt.T *= opt.a
    opt.T = args.min_score
    opt.verbose = args.verbosity
    opt.n_threads = args.n_threads
    opt.copy_comment = args.copy_comment
    if args.ref_hdr:
        from .pipeline.options import MEM_F_REF_HDR

        opt.flag |= MEM_F_REF_HDR
    opt.dp_type = args.dp_type
    opt.zdrop = args.zdrop
    opt.max_occ = args.max_occ
    opt.chunk_size = args.chunk_size
    opt.shd_filter = args.shd_filter
    opt.seed_type = args.seed_type
    opt.seed_intv = args.seed_intv
    opt.re_seed = args.re_seed
    opt.full_reseed = not args.no_reseed
    if args.all_alignments:
        opt.flag |= MEM_F_ALL
    if args.mark_short_split:
        from .pipeline.options import MEM_F_NO_MULTI

        opt.flag |= MEM_F_NO_MULTI
    if args.pen_unpaired is not None:
        opt.pen_unpaired = args.pen_unpaired
    if args.drop_ratio is not None:
        opt.drop_ratio = args.drop_ratio
    if args.max_matesw is not None:
        opt.max_matesw = args.max_matesw
    if args.max_xa_hits is not None:
        parts = str(args.max_xa_hits).split(",")
        opt.max_XA_hits = int(parts[0])
        if len(parts) > 1:
            opt.max_XA_hits_alt = int(parts[1])
    if args.split_width is not None:
        opt.split_width = args.split_width
    if args.split_factor is not None:
        opt.split_factor = args.split_factor
    if args.mapq_coef_len is not None:
        opt.mapQ_coef_len = args.mapq_coef_len
    if args.max_chain_extend is not None:
        opt.max_chain_extend = args.max_chain_extend
    if args.max_mem_intv is not None:
        opt.max_mem_intv = args.max_mem_intv
    if args.max_chain_gap is not None:
        opt.max_chain_gap = args.max_chain_gap
    if args.mask_level is not None:
        opt.mask_level = args.mask_level
    if args.softclip_supp:
        opt.flag |= MEM_F_SOFTCLIP
    if args.mates is not None or args.smart_pairing:
        opt.flag |= MEM_F_PE
    if args.skip_pairing:
        opt.flag |= MEM_F_NOPAIRING
    if args.skip_rescue:
        opt.flag |= MEM_F_NO_RESCUE
    rg_id = None
    if args.rg_line:
        for f in args.rg_line.replace("\\t", "\t").split("\t"):
            if f.startswith("ID:"):
                rg_id = f[3:]
    opt.rg_id = rg_id  # per-record RG:Z tag (reference: src/bwamem.c:1674)
    return opt


def cmd_align(args) -> int:
    if args.n_chips != 1 or args.n_hosts > 1:
        raise NotImplementedError(
            "--n-chips/--n-hosts other than 1 are not ported yet (ROADMAP "
            "queue A: multi-GPU/multi-host)")
    if args.seed_type != 1 or args.re_seed:
        raise NotImplementedError(
            "-u 2/3/4 and -g are not ported yet (ROADMAP queue A: seeding "
            "variants)")
    if args.shd_filter:
        raise NotImplementedError(
            "-F is not ported yet (ROADMAP queue A: seed filters/shd/banded)")

    from .index.format import FMIndex
    from .io.fastx import read_fastx
    from .pipeline.aligner import MemAligner
    from .pipeline.runtime import run_pipeline
    from .ops.seeding import SeedConfig
    from .utils.timing import Timings

    opt = _options(args)
    paired = args.mates is not None or args.smart_pairing
    idx = FMIndex.load(args.index_prefix + ".bmt")
    if getattr(args, "ignore_alt", False) and idx.ann.is_alt:
        # -j: treat ALT contigs as part of the primary assembly
        idx.ann.is_alt = [False] * len(idx.ann.names)
    # fork the host worker pool BEFORE the first CUDA call (a fork after
    # CUDA initialization is unsafe; see pipeline/hostpool.py)
    from .pipeline.hostpool import HostPool

    host_pool = HostPool(opt, idx, args.n_threads)
    try:
        import torch

        if args.device.startswith("cuda") and not torch.cuda.is_available():
            sys.exit(f"[{PROG}] error: --device {args.device}: no CUDA "
                     "device is available (pass --device cpu to run the "
                     "device stages on the CPU)")
        seed_cfg = SeedConfig(min_seed_len=opt.min_seed_len,
                              max_occ=opt.max_occ, reseed=opt.full_reseed,
                              split_factor=opt.split_factor,
                              split_width=opt.split_width,
                              max_mem_intv=opt.max_mem_intv)
        aligner = MemAligner(opt, idx, seed_cfg=seed_cfg,
                             device=args.device)
        if args.insert_spec:
            from .pipeline.pairing import pestat_from_spec

            aligner.pes_fixed = pestat_from_spec(args.insert_spec)
            fr = aligner.pes_fixed[1]
            print(f"[{PROG}] fixed insert-size model (FR): avg={fr.avg:.1f} "
                  f"std={fr.std:.1f} bounds=[{fr.low},{fr.high}]",
                  file=sys.stderr)
        records = read_fastx(args.reads)
        if args.mates is not None:
            records = _interleave(records, read_fastx(args.mates))
        out = open(args.output, "w") if args.output else sys.stdout
        timings = Timings()
        cmdline = f"{PROG} " + " ".join(sys.argv[1:])
        for line in _sam_header(idx, args.rg_line, cmdline):
            out.write(line + "\n")
        if args.header_insert:  # -H (reference: src/bwa.c:425-466)
            if args.header_insert.startswith("@"):
                out.write(args.header_insert.replace("\\t", "\t") + "\n")
            else:
                with open(args.header_insert) as hf:
                    for hl in hf:
                        if hl.strip():
                            out.write(hl.rstrip("\n") + "\n")
        n = run_pipeline(records, aligner,
                         opt.chunk_size * max(args.n_threads, 1), out,
                         timings=timings, paired=paired,
                         host_pool=host_pool,
                         lookahead=0 if args.no_mt_io else 2)
    finally:
        host_pool.close()
    st = aligner.stats
    print(f"[{PROG}] done: {n} reads, {st['n_seeds']} seeds, "
          f"{st['n_extensions']} extensions", file=sys.stderr)
    timings.meta.update(st)
    try:  # reference appends every run to time.log (src/main.c:73,123)
        timings.append_log("time.log", cmdline)
    except OSError:
        pass
    if args.verbosity >= 3:
        print(timings.report(), file=sys.stderr)
    if args.timing_file:
        timings.append_tsv(args.timing_file, n_threads=args.n_threads,
                           min_seed_len=opt.min_seed_len,
                           seed_type=opt.seed_type, dp_type=opt.dp_type,
                           n_reads_total=n)
    if out is not sys.stdout:
        out.close()
    return 0


def _interleave(it1, it2):
    try:
        for a, b in zip(it1, it2, strict=True):
            yield a
            yield b
    except ValueError:
        raise SystemExit(
            f"[{PROG}] error: paired files have different read counts")


if __name__ == "__main__":
    sys.exit(main())
