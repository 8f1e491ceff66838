"""ctypes loader for the native (C++) components.

Builds `libbwamem_native.so` from the sources in <repo>/native on first use
(g++ -O3). Native pieces mirror the reference's native runtime components
(SURVEY §2 marks them ⊕): SA-IS index construction here; more (IO packers)
live alongside.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO_ROOT / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB_PATH = _BUILD_DIR / "libbwamem_native.so"

_lock = threading.Lock()
_lib = None
_load_failed = False

_SOURCES = ["sais.cpp", "ksw.cpp", "fastx.cpp", "chain.cpp", "chain2aln.cpp",
            "reg2aln.cpp", "dedup.cpp", "samemit.cpp"]


def _build() -> bool:
    srcs = [str(_SRC_DIR / s) for s in _SOURCES if (_SRC_DIR / s).exists()]
    if not srcs:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # rebuild when any source is newer than the lib
    if _LIB_PATH.exists():
        lib_mtime = _LIB_PATH.stat().st_mtime
        if all(Path(s).stat().st_mtime <= lib_mtime for s in srcs):
            return True
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-o", str(_LIB_PATH), *srcs,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        return False
    return True


def try_load():
    """Return the loaded CDLL or None if native build is unavailable.
    BWAMEM_TPU_NO_NATIVE=1 disables the native cores entirely (every
    caller falls back to its Python twin — the differential-oracle
    path), which isolates native-code faults and doubles as an escape
    hatch on hosts without a toolchain."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    import os
    if os.environ.get("BWAMEM_TPU_NO_NATIVE"):
        _load_failed = True
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _load_failed = True
            return None
        lib.bm_sais_u8.restype = ctypes.c_int
        lib.bm_sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bm_chain_batch.restype = ctypes.c_int64
        lib.bm_chain_batch.argtypes = [
            i32p, i32p, i64p, i64p, i64p, ctypes.c_int64, i32p,
            i64p, ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32,
            ctypes.c_int64,
            i64p, i32p, i32p, ctypes.c_int64,
            i32p, i32p, i32p, i32p, i64p, i32p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, i64p,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        dbp = ctypes.POINTER(ctypes.c_double)
        lib.bm_chain2aln_batch.restype = ctypes.c_int64
        lib.bm_chain2aln_batch.argtypes = [
            i32p, i32p, dbp, i64p, i32p, ctypes.c_int64,      # chains
            i64p, i32p, i32p, i32p,                            # seeds
            u8p, ctypes.c_int64, i32p,                         # reads
            u32p, ctypes.c_int64, i64p, i8p, ctypes.c_int64,   # reference
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # a w o_del
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # e_del o_ins e_ins
            i32p, i32p, i8p, dbp, i32p, i32p, i64p, i8p,       # regs...
            i64p, i32p,
            i32p, i32p, i32p, i64p, i64p, i32p, ctypes.c_int64,
            i64p, i8p, i32p, i32p, i32p, i64p, i64p,
            i32p, i32p, i64p, i8p,
            ctypes.c_int64,
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            i64p,
        ]
        lib.bm_scatter_jobs.restype = None
        lib.bm_scatter_jobs.argtypes = [
            u8p, i64p, i32p, i64p, ctypes.c_int64, i8p,
            ctypes.c_int64, ctypes.c_int8,
        ]
        lib.bm_fastx_scan.restype = ctypes.c_int64
        lib.bm_fastx_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bm_encode_bases.restype = None
        lib.bm_encode_bases.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        vp = ctypes.c_void_p
        lib.bm_dedup_patch_batch.restype = ctypes.c_int
        lib.bm_dedup_patch_batch.argtypes = [
            vp, ctypes.c_int64, vp,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64,
            vp, vp, vp,
            vp, vp, vp, vp, vp, vp, vp,
            vp, vp, vp, vp, vp,
            vp, vp,
        ]
        lib.bm_reg2aln_batch.restype = ctypes.c_int
        lib.bm_reg2aln_batch.argtypes = [
            vp, ctypes.c_int64, vp,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64,
            vp, vp, vp,
            vp, vp,
            vp, vp,
            vp,
            vp, ctypes.c_int64, vp, vp,
            vp, ctypes.c_int64, vp, vp,
        ]
        lib.bm_finalize_se_batch.restype = ctypes.c_int
        lib.bm_finalize_se_batch.argtypes = [
            vp, ctypes.c_int64, vp,                     # pac, l_pac, mat
            vp, ctypes.c_int32, vp, vp, vp, vp,         # ann/names/annos
            vp, vp,                                     # opt_d, opt_i
            ctypes.c_int64, ctypes.c_int64, vp,         # n, id0, reg_off
            vp, vp, vp,                                 # qstream,q_off,q_len
            vp, vp, vp, vp, vp, vp,                     # names/quals/comments
            vp, ctypes.c_int32,                         # rg
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # regs
            vp, ctypes.c_int64, vp,                     # out
        ]
        lib.bm_finalize_pe_batch.restype = ctypes.c_int
        lib.bm_finalize_pe_batch.argtypes = [
            vp, ctypes.c_int64, vp,                     # pac, l_pac, mat
            vp, ctypes.c_int32, vp, vp, vp, vp,         # ann/names/annos
            vp, vp,                                     # opt_d, opt_i
            vp, vp,                                     # pes_i, pes_d
            ctypes.c_int64, ctypes.c_int64, vp,         # n_pairs, id0, reg_off
            vp, vp, vp,                                 # qstream,q_off,q_len
            vp, vp, vp, vp, vp, vp,                     # names/quals/comments
            vp, ctypes.c_int32,                         # rg
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # regs
            vp, ctypes.c_int64, vp,                     # out
        ]
        lib.bm_ksw_global.restype = ctypes.c_int
        lib.bm_ksw_global.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


_scratch = threading.local()


def _cig_scratch(cap: int) -> np.ndarray:
    """Reusable per-thread cigar output buffer (hot in per-record SAM gen;
    the cigar is consumed into Python tuples before the next call)."""
    buf = getattr(_scratch, "cig", None)
    if buf is None or len(buf) < cap:
        buf = np.empty(max(cap, 1024), dtype=np.uint32)
        _scratch.cig = buf
    return buf


def ksw_global_native(lib, query, target, mat, o_del, e_del, o_ins, e_ins,
                      w, want_cigar=True):
    """Native banded global alignment; mirrors oracle.ksw.ksw_global's
    return contract: (score, [(op, len), ...])."""
    q = np.ascontiguousarray(query, dtype=np.uint8)
    t = np.ascontiguousarray(target, dtype=np.uint8)
    m = mat if (mat.dtype == np.int8 and mat.flags.c_contiguous) \
        else np.ascontiguousarray(mat, dtype=np.int8)
    score = ctypes.c_int32()
    n_cigar = ctypes.c_int32()
    cap = len(q) + len(t) + 2
    cig = _cig_scratch(cap)
    rc = lib.bm_ksw_global(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), m.shape[0],
        int(o_del), int(e_del), int(o_ins), int(e_ins), int(w),
        ctypes.byref(score),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)) if want_cigar
        else None,
        cap, ctypes.byref(n_cigar),
    )
    if rc != 0:
        raise RuntimeError("bm_ksw_global failed")
    cigar = [(int(c & 0xF), int(c >> 4)) for c in cig[: n_cigar.value]]
    return int(score.value), cigar


def chain2aln_native(lib, opt, idx, raw, reads_flat: np.ndarray,
                     read_stride: int, l_query: np.ndarray):
    """Run bm_chain2aln_batch over chain_batch_raw output. Returns a dict
    of reg/job arrays + sequence streams, or retries with bigger caps."""
    import ctypes

    n_chains = raw["n_chains"]
    n_seeds = raw["n_seeds"]
    ann_off = np.asarray(idx.ann.offsets, np.int64)
    ann_alt = np.asarray(
        [1 if idx.ann.alt_of(r) else 0 for r in range(len(ann_off))],
        np.int8)
    pac = idx.pac_words.view(np.uint32)
    p32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    p8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    pu8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    pu32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    pdb = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    reg_cap = max(n_seeds + 16, 64)
    job_cap = reg_cap * 2
    stream_cap = max(int(l_query.sum()) * 2 + (1 << 16), 1 << 16)
    while True:
        R = dict(
            read=np.empty(reg_cap, np.int32),
            rid=np.empty(reg_cap, np.int32),
            is_alt=np.empty(reg_cap, np.int8),
            frac=np.empty(reg_cap, np.float64),
            seedlen0=np.empty(reg_cap, np.int32),
            qseed=np.empty(reg_cap, np.int32),
            rseed=np.empty(reg_cap, np.int64),
            sides=np.empty(reg_cap, np.int8),
            chain_soff=np.empty(reg_cap, np.int64),
            chain_ns=np.empty(reg_cap, np.int32),
            score0=np.empty(reg_cap, np.int32),
            qb0=np.empty(reg_cap, np.int32),
            qe0=np.empty(reg_cap, np.int32),
            rb0=np.empty(reg_cap, np.int64),
            re0=np.empty(reg_cap, np.int64),
            seedcov0=np.empty(reg_cap, np.int32),
        )
        J = dict(
            reg=np.empty(job_cap, np.int64),
            side=np.empty(job_cap, np.int8),
            h0=np.empty(job_cap, np.int32),
            qlen=np.empty(job_cap, np.int32),
            tlen=np.empty(job_cap, np.int32),
            qoff=np.empty(job_cap, np.int64),
            toff=np.empty(job_cap, np.int64),
            read=np.empty(job_cap, np.int32),
            qstart=np.empty(job_cap, np.int32),
            tstart=np.empty(job_cap, np.int64),
            dir=np.empty(job_cap, np.int8),
        )
        qstream = np.empty(stream_cap, np.uint8)
        tstream = np.empty(stream_cap * 3, np.uint8)
        counts = np.zeros(5, np.int64)
        lib.bm_chain2aln_batch(
            p32(raw["c_read"]), p32(raw["c_rid"]), pdb(raw["c_frac"]),
            p64(raw["c_soff"]), p32(raw["c_ns"]), n_chains,
            p64(raw["s_rbeg"]), p32(raw["s_qbeg"]), p32(raw["s_len"]),
            p32(raw.get("s_score", raw["s_len"])),
            pu8(reads_flat), read_stride, p32(l_query),
            pu32(pac), idx.l_pac, p64(ann_off), p8(ann_alt), len(ann_off),
            opt.a, opt.w, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            p32(R["read"]), p32(R["rid"]), p8(R["is_alt"]), pdb(R["frac"]),
            p32(R["seedlen0"]), p32(R["qseed"]), p64(R["rseed"]),
            p8(R["sides"]), p64(R["chain_soff"]), p32(R["chain_ns"]),
            p32(R["score0"]), p32(R["qb0"]), p32(R["qe0"]), p64(R["rb0"]),
            p64(R["re0"]), p32(R["seedcov0"]), reg_cap,
            p64(J["reg"]), p8(J["side"]), p32(J["h0"]), p32(J["qlen"]),
            p32(J["tlen"]), p64(J["qoff"]), p64(J["toff"]),
            p32(J["read"]), p32(J["qstart"]), p64(J["tstart"]),
            p8(J["dir"]), job_cap,
            pu8(qstream), stream_cap, pu8(tstream), stream_cap * 3,
            p64(counts),
        )
        if not counts[4]:
            break
        reg_cap *= 2
        job_cap *= 2
        stream_cap *= 2
    return dict(n_regs=int(counts[0]), n_jobs=int(counts[1]),
                regs=R, jobs=J, qstream=qstream, tstream=tstream)


def scatter_jobs(lib, stream, offs, lens, sel, max_len, fill=4):
    """Pad selected var-length stream slices into an (n_sel, max_len)
    int32 batch."""
    import ctypes

    sel = np.ascontiguousarray(sel, np.int64)
    out = np.empty((len(sel), max_len), np.int8)
    if len(sel):
        lib.bm_scatter_jobs(
            stream.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(sel),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            max_len, ctypes.c_int8(fill))
    return out


def sais(lib, codes: np.ndarray) -> np.ndarray:
    s = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(s)
    sa = np.empty(n, dtype=np.int64)
    k = int(s.max()) + 1 if n else 1
    rc = lib.bm_sais_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        k,
    )
    if rc != 0:
        raise RuntimeError("bm_sais_u8 failed")
    return sa


def reg2aln_native(lib, opt, idx, qstream, q_off, q_len, rb, re, truesc,
                   ar_w):
    """Batched mem_reg2aln numeric core (band retry loop + banded global DP
    + NM/MD). Mirrors samgen._reg2aln_solve_scalar / gen_cigar exactly
    (reference: src/bwamem.c:2344-2438, src/bwa.c:111-217). Inputs must
    already be contiguous arrays of the right dtype (the samgen caller
    builds them that way); kept lean because paired-end finalize calls
    this with 1-2 records at a time. Returns
    (cig_pool, cig_off, cig_n, nm, md_pool_bytes, md_off, md_len)."""
    n = len(q_len)
    key = (opt.a, opt.b, "i8")
    cached = getattr(opt, "__dict__", None)
    mat = None
    if cached is not None:
        hit = cached.get("_mat8_cache")
        if hit is not None and hit[0] == key:
            mat = hit[1]
    if mat is None:
        mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
        if cached is not None:
            cached["_mat8_cache"] = (key, mat)
    pac = idx.pac_words
    nm = np.empty(n, np.int32)
    cig_off = np.empty(n, np.int64)
    cig_n = np.empty(n, np.int32)
    md_off = np.empty(n, np.int64)
    md_len = np.empty(n, np.int32)
    total_q = int(q_len.sum())
    cig_cap = max(total_q // 8 + 64 * n + 64, 1024)
    md_cap = max(total_q // 2 + 16 * n + 64, 1024)
    fn = lib.bm_reg2aln_batch
    while True:
        cig_pool = np.empty(cig_cap, np.uint32)
        md_pool = np.empty(md_cap, np.uint8)
        rc = fn(
            pac.ctypes.data, int(idx.l_pac), mat.ctypes.data,
            int(opt.o_del), int(opt.e_del), int(opt.o_ins), int(opt.e_ins),
            int(opt.a), int(opt.w), n,
            qstream.ctypes.data, q_off.ctypes.data, q_len.ctypes.data,
            rb.ctypes.data, re.ctypes.data,
            truesc.ctypes.data, ar_w.ctypes.data,
            nm.ctypes.data,
            cig_pool.ctypes.data, cig_cap, cig_off.ctypes.data,
            cig_n.ctypes.data,
            md_pool.ctypes.data, md_cap, md_off.ctypes.data,
            md_len.ctypes.data,
        )
        if rc == 0:
            return cig_pool, cig_off, cig_n, nm, md_pool, md_off, md_len
        cig_cap *= 2
        md_cap *= 2


def dedup_patch_native(lib, opt, idx, reg_off, qstream, q_off, fields):
    """Batched mem_sort_dedup_patch over flat region arrays (twin:
    pipeline/regions.py mem_sort_dedup_patch; reference:
    src/bwamem.c:580-680). `fields` is a dict of contiguous arrays
    (rb/re int64, qb/qe/score/truesc/w/seedcov/sub/csub/n_comp int32,
    rid int32) mutated in place. Returns (out_idx, out_cnt)."""
    n_regs = len(fields["qb"])
    n_reads = len(q_off)
    out_idx = np.empty(n_regs, np.int32)
    out_cnt = np.empty(n_reads, np.int32)
    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    lib.bm_dedup_patch_batch(
        idx.pac_words.ctypes.data, int(idx.l_pac), mat.ctypes.data,
        int(opt.o_del), int(opt.e_del), int(opt.o_ins), int(opt.e_ins),
        int(opt.w), int(opt.max_chain_gap), float(opt.mask_level_redun),
        n_reads,
        reg_off.ctypes.data, qstream.ctypes.data, q_off.ctypes.data,
        fields["rb"].ctypes.data, fields["re"].ctypes.data,
        fields["qb"].ctypes.data, fields["qe"].ctypes.data,
        fields["score"].ctypes.data, fields["truesc"].ctypes.data,
        fields["w"].ctypes.data, fields["seedcov"].ctypes.data,
        fields["sub"].ctypes.data, fields["csub"].ctypes.data,
        fields["n_comp"].ctypes.data, fields["rid"].ctypes.data,
        out_idx.ctypes.data, out_cnt.ctypes.data,
    )
    return out_idx, out_cnt


def finalize_se_native(lib, opt, idx, names, seqs, quals, per_read_regs,
                       n_processed=0, comments=None, rg_id=None) -> bytes:
    """Whole SE finalization (mark-primary + selection + XA + CIGAR/NM/MD
    + SAM text) in one native call (twin: regions.mem_mark_primary_se +
    samgen.mem_reg2sam_batch; reference: src/bwamem.c:715-761, 1506-1775,
    2344-2438, src/bwamem_extra.c mem_gen_alt). Returns the SAM text blob
    ('\\n'-terminated lines, reads in input order)."""
    (reg_off, rb, re_, qb, qe, score, truesc, sub, csub, arw, seedcov,
     rid, is_alt, frac) = _reg_arrays(per_read_regs)
    (qstream, q_off, qlens, names_b, name_off, quals_b, qual_off,
     cm_b, com_off) = _read_streams(seqs, names, quals, comments)
    ann_off, rnames_b, rname_off, annos_b, anno_off = _idx_streams(idx)
    from .samfmt_opts import pack_opts
    opt_d, opt_i = pack_opts(opt)
    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    rg_b = (rg_id or "").encode()

    NR = int(reg_off[-1])
    cap = int(qstream.size * 3 + NR * 196 + len(seqs) * 256 + 4096)
    while True:
        out = np.empty(cap, np.uint8)
        out_len = np.zeros(1, np.int64)
        rc = lib.bm_finalize_se_batch(
            idx.pac_words.ctypes.data, int(idx.l_pac), mat.ctypes.data,
            ann_off.ctypes.data, len(idx.ann.names), rnames_b,
            rname_off.ctypes.data, annos_b, anno_off.ctypes.data,
            opt_d.ctypes.data, opt_i.ctypes.data,
            len(seqs), int(n_processed), reg_off.ctypes.data,
            qstream.ctypes.data, q_off.ctypes.data, qlens.ctypes.data,
            names_b, name_off.ctypes.data,
            quals_b, qual_off.ctypes.data,
            cm_b, com_off.ctypes.data,
            rg_b if rg_b else None, len(rg_b),
            rb.ctypes.data, re_.ctypes.data, qb.ctypes.data, qe.ctypes.data,
            score.ctypes.data, truesc.ctypes.data, sub.ctypes.data,
            csub.ctypes.data, arw.ctypes.data, seedcov.ctypes.data,
            rid.ctypes.data, is_alt.ctypes.data, frac.ctypes.data,
            out.ctypes.data, cap, out_len.ctypes.data,
        )
        if rc == 0:
            return out[: int(out_len[0])].tobytes()
        cap *= 2


_idx_cache: dict = {}


def _idx_streams(idx):
    """Per-index marshaling cache: ann offsets (+sentinel), ref-name and
    description byte streams, score matrix."""
    key = id(idx)
    hit = _idx_cache.get(key)
    if hit is not None:
        return hit
    ann = idx.ann

    def stream_of(strs):
        offs = np.zeros(len(strs) + 1, np.int64)
        t = 0
        bs = []
        for i, s in enumerate(strs):
            b = s.encode() if isinstance(s, str) else (s or b"")
            bs.append(b)
            t += len(b)
            offs[i + 1] = t
        return b"".join(bs), offs

    ann_off = np.asarray(list(ann.offsets) + [int(idx.l_pac)], np.int64)
    rnames_b, rname_off = stream_of(ann.names)
    annos_b, anno_off = stream_of(ann.annos if ann.annos
                                  else [""] * len(ann.names))
    out = (ann_off, rnames_b, rname_off, annos_b, anno_off)
    _idx_cache.clear()   # one live index per process is the norm
    _idx_cache[key] = out
    return out


def _reg_arrays(per_read_regs):
    from ..pipeline.regarrays import RegArrays

    if isinstance(per_read_regs, RegArrays):
        return per_read_regs.flat()  # no object round-trip (SE fast path)
    B = len(per_read_regs)
    counts = np.fromiter((len(r) for r in per_read_regs), np.int64, B)
    reg_off = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=reg_off[1:])
    NR = int(reg_off[-1])
    rb = np.empty(NR, np.int64)
    re_ = np.empty(NR, np.int64)
    i32 = lambda: np.empty(NR, np.int32)
    qb, qe, score, truesc, sub, csub, arw, seedcov, rid = (
        i32() for _ in range(9))
    is_alt = np.empty(NR, np.int8)
    frac = np.empty(NR, np.float64)
    k = 0
    for regs in per_read_regs:
        for r in regs:
            rb[k] = r.rb
            re_[k] = r.re
            qb[k] = r.qb
            qe[k] = r.qe
            score[k] = r.score
            truesc[k] = r.truesc
            sub[k] = r.sub
            csub[k] = r.csub
            arw[k] = r.w
            seedcov[k] = r.seedcov
            rid[k] = r.rid
            is_alt[k] = 1 if r.is_alt else 0
            frac[k] = r.frac_rep
            k += 1
    return (reg_off, rb, re_, qb, qe, score, truesc, sub, csub, arw,
            seedcov, rid, is_alt, frac)


def _read_streams(seqs, names, quals, comments):
    B = len(seqs)
    qlens = np.fromiter((len(s) for s in seqs), np.int32, B)
    q_off = np.zeros(B + 1, np.int64)
    np.cumsum(qlens.astype(np.int64), out=q_off[1:])
    qstream = (np.concatenate([np.asarray(s, np.uint8) for s in seqs])
               if B else np.zeros(0, np.uint8))

    def stream_of(strs):
        offs = np.zeros(len(strs) + 1, np.int64)
        t = 0
        bs = []
        for i, s in enumerate(strs):
            b = s.encode() if isinstance(s, str) else (s or b"")
            bs.append(b)
            t += len(b)
            offs[i + 1] = t
        return b"".join(bs), offs

    names_b, name_off = stream_of(names)
    have_qual = any(q for q in quals)
    quals_b, qual_off = (stream_of([q or "" for q in quals]) if have_qual
                         else (b"", np.zeros(B + 1, np.int64)))
    have_cm = bool(comments) and any(c for c in comments)
    cm_b, com_off = (stream_of([c or "" for c in comments]) if have_cm
                     else (b"", np.zeros(B + 1, np.int64)))
    return (qstream, q_off, qlens, names_b, name_off,
            quals_b if have_qual else None, qual_off,
            cm_b if have_cm else None, com_off)


def finalize_pe_native(lib, opt, idx, pes, names, seqs, quals, pair_regs,
                       pair_id0=0, comments=None, rg_id=None) -> bytes:
    """Whole PE finalization (mark-primary + pairing + selection + XA +
    CIGAR/NM/MD + SAM text) in one native call (twin:
    pairing.mem_sam_pe_plan/render; reference: src/bwamem_pair.c:190-397
    mem_sam_pe). `seqs` interleaved r1,r2; pair_regs[i] = [regs0, regs1].
    Returns the SAM text blob (read1 lines then read2 lines per pair)."""
    per_read = []
    for pr in pair_regs:
        per_read.append(pr[0])
        per_read.append(pr[1])
    (reg_off, rb, re_, qb, qe, score, truesc, sub, csub, arw, seedcov,
     rid, is_alt, frac) = _reg_arrays(per_read)
    (qstream, q_off, qlens, names_b, name_off, quals_b, qual_off,
     cm_b, com_off) = _read_streams(seqs, names, quals, comments)
    ann_off, rnames_b, rname_off, annos_b, anno_off = _idx_streams(idx)
    from .samfmt_opts import pack_opts
    opt_d, opt_i = pack_opts(opt)
    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    pes_i = np.zeros(12, np.int32)
    pes_d = np.zeros(8, np.float64)
    for d in range(4):
        p = pes[d]
        pes_i[d * 3] = 1 if p.failed else 0
        pes_i[d * 3 + 1] = p.low
        pes_i[d * 3 + 2] = p.high
        pes_d[d * 2] = p.avg
        pes_d[d * 2 + 1] = p.std

    NR = int(reg_off[-1])
    cap = int(qstream.size * 3 + NR * 196 + len(seqs) * 256 + 4096)
    while True:
        out = np.empty(cap, np.uint8)
        out_len = np.zeros(1, np.int64)
        rc = lib.bm_finalize_pe_batch(
            idx.pac_words.ctypes.data, int(idx.l_pac), mat.ctypes.data,
            ann_off.ctypes.data, len(idx.ann.names), rnames_b,
            rname_off.ctypes.data, annos_b, anno_off.ctypes.data,
            opt_d.ctypes.data, opt_i.ctypes.data,
            pes_i.ctypes.data, pes_d.ctypes.data,
            len(pair_regs), int(pair_id0), reg_off.ctypes.data,
            qstream.ctypes.data, q_off.ctypes.data, qlens.ctypes.data,
            names_b, name_off.ctypes.data,
            quals_b, qual_off.ctypes.data,
            cm_b, com_off.ctypes.data,
            (rg_id or "").encode() or None, len(rg_id or ""),
            rb.ctypes.data, re_.ctypes.data, qb.ctypes.data, qe.ctypes.data,
            score.ctypes.data, truesc.ctypes.data, sub.ctypes.data,
            csub.ctypes.data, arw.ctypes.data, seedcov.ctypes.data,
            rid.ctypes.data, is_alt.ctypes.data, frac.ctypes.data,
            out.ctypes.data, cap, out_len.ctypes.data,
        )
        if rc == 0:
            return out[: int(out_len[0])].tobytes()
        cap *= 2
