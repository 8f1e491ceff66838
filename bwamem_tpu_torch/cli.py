"""Command-line interface: `index`, `ingest` (a reference-format index to
the native format), `fastmap` (the SMEMs of each read) and `align` of
single-end reads or of pairs (two files, or one interleaved file with -p;
`gase_aln` and `mem` accepted as aliases), with the JAX package's flags
plus --device.

`align --n-chips N` runs data parallel over N GPUs of this process
(parallel/sharded.py; 0 = every visible card); `--n-hosts W --host-id R`
aligns host R's contiguous share of the records into `<out>.shard<R>`,
and host 0 merges the shards into -o (parallel/multihost.py; with
--coordinator the hosts first join a Gloo process group).
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
                   help="data-parallel GPU count of this process (0 = all "
                        "visible cards; with --device cpu, shards on the "
                        "CPU)")
    p.add_argument("--n-hosts", type=int, default=1, dest="n_hosts",
                   help="multi-host world size (each host aligns a "
                        "contiguous record range; needs --host-id and -o)")
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
                   help="the JAX package's candidate slots a read: seed "
                        "compaction is exact here, but -g follows the "
                        "JAX walk on its pool's width")
    p.add_argument("--seed-cap", type=int, default=8,
                   help="the JAX package's seed slots a read: where -g "
                        "splits a batch as the JAX aligner does")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages [cuda]; there "
                        "is no automatic fallback to the CPU")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   dest="trace_out",
                   help="record spans (with chunk, parent and thread CPU "
                        "time) and per-chunk counters, and write them at "
                        "exit as Chrome trace-event JSON on torch.profiler's "
                        "clock")


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

    pg = sub.add_parser(
        "ingest",
        help="convert a reference-format index (bwa index two-pass "
             "output: .ann/.amb/.pac/.bwt/.sa) to the native .bmt format")
    pg.add_argument("ref_prefix")
    pg.add_argument("-p", default=None, dest="prefix",
                    help="output prefix [ref_prefix]")
    pg.add_argument("-r", type=int, default=4, dest="sa_intv",
                    help="suffix-array sampling interval (power of 2)")
    pg.add_argument("--no-verify", action="store_true",
                    help="skip the P.sa cross-check during the SA walk")

    pf = sub.add_parser("fastmap",
                        help="dump SMEMs per read (reference: main_fastmap)")
    pf.add_argument("index_prefix")
    pf.add_argument("reads")
    pf.add_argument("-l", type=int, default=17, dest="min_seed_len",
                    help="min SMEM length to output")
    pf.add_argument("-w", type=int, default=20, dest="max_occ_out",
                    help="max interval size to find coordinates")
    pf.add_argument("-p", action="store_true", dest="print_seq",
                    help="print the query sequence on the SQ line")
    pf.add_argument("--device", default="cuda",
                    help="torch device for the seeding [cuda]; there is no "
                         "automatic fallback to the CPU")

    args = ap.parse_args(argv)
    try:
        if args.cmd == "index":
            return cmd_index(args)
        if args.cmd == "ingest":
            return cmd_ingest(args)
        if args.cmd == "fastmap":
            return cmd_fastmap(args)
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


def cmd_ingest(args) -> int:
    from .index.ingest import load_reference_index

    t0 = time.perf_counter()
    idx = load_reference_index(args.ref_prefix, sa_intv=args.sa_intv,
                               verify=not args.no_verify)
    prefix = args.prefix or args.ref_prefix
    idx.save(prefix + ".bmt")
    print(
        f"[{PROG}] ingested {idx.l_pac} bp "
        f"({len(idx.ann.names)} sequences) from {args.ref_prefix}.* in "
        f"{time.perf_counter() - t0:.1f}s -> {prefix}.bmt.npz",
        file=sys.stderr,
    )
    return 0


def _no_cuda_exit(device: str) -> None:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit(f"[{PROG}] error: --device {device}: no CUDA device is "
                 "available (pass --device cpu to run the device stages on "
                 "the CPU)")


def cmd_fastmap(args) -> int:
    """The SMEMs of each read (the reference's main_fastmap,
    src/fastmap.c:559-633): 'SQ name len', then one 'EM qb qe n_occ
    pos...' line per SMEM, then '//'. Seeding runs on --device, 512 reads
    a batch."""
    from .index.format import FMIndex
    from .io.fastx import read_fastx
    from .pipeline.aligner import MemAligner
    from .pipeline.options import MemOptions
    from .utils.dna import decode

    _no_cuda_exit(args.device)
    idx = FMIndex.load(args.index_prefix + ".bmt")
    opt = MemOptions()
    opt.min_seed_len = args.min_seed_len
    # fastmap iterates pure round-1 SMEMs (smem_next -> bwt_smem1,
    # min_intv=1): no split re-seed or LAST-like rounds
    opt.full_reseed = False
    al = MemAligner(opt, idx, device=args.device)
    lp = idx.l_pac

    def flush(batch):
        for rec, sl in zip(batch, al.seed_batch([r.seq for r in batch])):
            sq_seq = f"\t{decode(rec.seq)}" if args.print_seq else ""
            print(f"SQ\t{rec.name}\t{len(rec.seq)}{sq_seq}")
            by_span: dict = {}
            for qb, qe, rb, occ in sl:
                by_span.setdefault((qb, qe, occ), []).append(rb)
            for (qb, qe, occ), rbs in by_span.items():
                # vanilla prints coordinates only when the interval fits
                # under -w, else a bare '*' (src/fastmap.c:612-623)
                if occ > args.max_occ_out:
                    print(f"EM\t{qb}\t{qe}\t{occ}\t*")
                    continue
                locs = []
                for rb in rbs[: args.max_occ_out]:
                    fwd = rb < lp
                    pos = rb if fwd else 2 * lp - 1 - rb - (qe - qb) + 1
                    rid = idx.ann.pos_to_rid(pos)
                    locs.append(f"{idx.ann.names[rid]}:"
                                f"{'+-'[not fwd]}"
                                f"{pos - idx.ann.offsets[rid] + 1}")
                print(f"EM\t{qb}\t{qe}\t{occ}\t" + "\t".join(locs))
            print("//")

    batch: list = []
    for rec in read_fastx(args.reads):
        batch.append(rec)
        if len(batch) >= 512:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
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
    if args.trace_out is None:
        return _align(args)
    from .utils import timing

    timing.enable()
    try:
        return _align(args)
    finally:
        timing.disable().write_chrome(args.trace_out)


def _align(args) -> int:
    from .index.format import FMIndex
    from .io.fastx import read_fastx
    from .pipeline.aligner import MemAligner
    from .pipeline.runtime import run_pipeline
    from .ops.seeding import SeedConfig
    from .utils.timing import Timings

    opt = _options(args)
    paired = args.mates is not None or args.smart_pairing
    shard = None
    if args.n_hosts > 1:
        from .parallel import multihost as mh

        if args.host_id is None or not 0 <= args.host_id < args.n_hosts:
            sys.exit(f"[{PROG}] --n-hosts requires --host-id in "
                     "0..n_hosts-1")
        if args.output is None:
            sys.exit(f"[{PROG}] multi-host mode requires -o (shards live "
                     "next to the output on the shared filesystem)")
        if args.reads == "-" or args.mates == "-":
            sys.exit(f"[{PROG}] stdin input cannot be range-sharded "
                     "across hosts")
        shard = mh.HostShard(rank=args.host_id, world=args.n_hosts)
    idx = FMIndex.load(args.index_prefix + ".bmt")
    if getattr(args, "ignore_alt", False) and idx.ann.is_alt:
        # -j: treat ALT contigs as part of the primary assembly
        idx.ann.is_alt = [False] * len(idx.ann.names)
    # fork the host worker pool BEFORE the first CUDA call (a fork after
    # CUDA initialization is unsafe; see pipeline/hostpool.py)
    from .pipeline.hostpool import HostPool

    host_pool = HostPool(opt, idx, args.n_threads)
    joined = False
    try:
        if shard is not None and args.coordinator:
            # the control plane, joined before any device use (and after
            # the fork above); the data path never crosses hosts
            _join(args)
            joined = True
        _no_cuda_exit(args.device)
        # the native core's first build, one process at a time: hosts that
        # start together would otherwise link the same library at once
        _load_native()
        seed_cfg = SeedConfig(min_seed_len=opt.min_seed_len,
                              cand_pool=args.seed_cands,
                              seed_pool=args.seed_cap, max_occ=opt.max_occ,
                              reseed=opt.full_reseed,
                              split_factor=opt.split_factor,
                              split_width=opt.split_width,
                              max_mem_intv=opt.max_mem_intv)
        mesh = None
        if args.n_chips != 1:
            from .parallel.sharded import make_mesh

            try:
                mesh = make_mesh(args.n_chips or None, args.device)
            except RuntimeError as e:
                sys.exit(f"[{PROG}] error: --n-chips {args.n_chips}: {e}")
            if mesh.size > 1:
                print(f"[{PROG}] data-parallel over {mesh.size} devices",
                      file=sys.stderr)
            else:
                mesh = None
        aligner = MemAligner(opt, idx, seed_cfg=seed_cfg,
                             device=args.device, mesh=mesh)
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
        if shard is not None:
            n_rec = mh.count_records(args.reads)
            if args.mates is not None:
                n_rec *= 2
            lo, hi = mh.record_range(n_rec, shard.rank, shard.world,
                                     granularity=2 if paired else 1)
            records = mh.take_range(records, lo, hi)
            print(f"[{PROG}] host {shard.rank}/{shard.world}: records "
                  f"[{lo}, {hi}) of {n_rec}", file=sys.stderr)
            out = open(mh.shard_path(args.output, shard.rank), "w")
        else:
            out = open(args.output, "w") if args.output else sys.stdout
        timings = Timings()
        cmdline = f"{PROG} " + " ".join(sys.argv[1:])
        if shard is None or shard.is_primary:  # the header once, in shard 0
            for line in _sam_header(idx, args.rg_line, cmdline):
                out.write(line + "\n")
            if args.header_insert:  # -H (reference: src/bwa.c:425-466)
                if args.header_insert.startswith("@"):
                    out.write(args.header_insert.replace("\\t", "\t")
                              + "\n")
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
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
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
    if shard is not None:
        mh.mark_done(args.output, shard.rank)
        if shard.is_primary:
            mh.merge_shards(args.output, shard.world,
                            keep_shards=args.keep_shards)
            print(f"[{PROG}] merged {shard.world} shards -> {args.output}",
                  file=sys.stderr)
    return 0


def _join(args) -> None:
    """Join the hosts' Gloo process group at --coordinator; a failed join
    exits with an error."""
    from .parallel.multihost import init_distributed

    try:
        init_distributed(args.coordinator, args.n_hosts, args.host_id)
    except (RuntimeError, ValueError, OSError) as e:
        sys.exit(f"[{PROG}] error: joining the hosts at {args.coordinator} "
                 f"failed: {e}")


def _load_native() -> None:
    """Build and load the native core under a file lock in its build
    directory, so that processes which start together build it once."""
    import fcntl

    from .native import loader

    loader._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(loader._BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        loader.try_load()


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
