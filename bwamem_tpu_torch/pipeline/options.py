"""Aligner options — parity with the fork's mem_opt_t defaults
(reference: src/bwamem.c:101-146 mem_opt_init; note the fork differs from
vanilla BWA: w=300, zdrop=0 disabled).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.extend import make_score_matrix

# flags (reference: src/bwamem.h MEM_F_*)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400

PATCH_MAX_R_BW = 0.05       # reference: src/bwamem.c PATCH_MAX_R_BW
PATCH_MIN_SC_RATIO = 0.90   # reference: src/bwamem.c PATCH_MIN_SC_RATIO
MEM_MAPQ_COEF = 30.0
MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05
FILTER_COEF = 0.85          # fork's estimated-extent coefficient (src/bwamem.c:52)


@dataclass
class MemOptions:
    a: int = 1                 # match score
    b: int = 4                 # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    w: int = 300               # fork default (vanilla: 100)
    zdrop: int = 0             # fork default: disabled (vanilla: 100)
    T: int = 30                # min score to output
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    min_seed_len: int = 19
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    max_ins: int = 10000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    split_factor: float = 1.5
    chunk_size: int = 10_000_000
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    max_matesw: int = 50
    mask_level_redun: float = 0.95
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    mapQ_coef_len: int = 50
    flag: int = 0
    n_threads: int = 1
    opt_ext: bool = False      # fork decoy passes opt_ext=0 (src/bwamem.c:1891)
    shd_filter: bool = False   # -F: SHD seed pre-filter (fork flag, src/bwamem.h:72)
    seed_type: int = 1         # -u: 1=SMEM 2=fixed exact 3=fwd MEM 4=fixed
    #                            <=1-mismatch (fork, src/bwamem.c:136,240-255)
    seed_intv: int = 0         # -J: start stride for -u 2/4; 0 = min_seed_len
    #                            (fork default, src/bwamem.c:137)
    re_seed: bool = False      # -g: all-MEM seeding (fork: GPUSeed is_smem=0,
    #                            src/fastmap.c:442)
    max_mem_intv: int = 20     # round-3 LAST-like seeding threshold
    #                            (vanilla bwa_index/bwamem.c:62; the fork
    #                            carries the field but its GPU seeding
    #                            never runs the round)
    full_reseed: bool = True   # vanilla seeding rounds 2+3 (split re-seed
    #                            + LAST-like; bwa_index/bwamem.c:129-159).
    #                            Default ON to match the golden-SAM oracle;
    #                            --no-reseed restores the fork's
    #                            round-1-only GPUSeed behavior
    #                            (src/bwamem.c:140 re_seed=0)
    dp_type: int = 0           # -e: extension algorithm selector (fork,
    #                            src/bwamem.h:70; informational here — all
    #                            values use the batched device ksw path)
    copy_comment: bool = False  # -C: append FASTA/Q comment to SAM
    rg_id: str | None = None    # ID: field of -R (RG:Z: per-record tag)
    verbose: int = 3           # -v: 1=err 2=warn 3=info 4+=debug dumps of
    #                            seeds/chains/regions (reference:
    #                            bwa_verbose, src/bwa.c:16 + the >=4 traces
    #                            in src/bwamem.c:386-402,1260-1451)

    @classmethod
    def vanilla(cls) -> "MemOptions":
        """Vanilla bwa-mem 0.7.x defaults (for golden-SAM comparison)."""
        return cls(w=100, zdrop=100, opt_ext=True)

    @property
    def mapQ_coef_fac(self) -> float:
        # cached (hot in per-record mapQ; invalidated if mapQ_coef_len set)
        # TRUNCATED to int: bwa declares `int mapQ_coef_fac` and assigns
        # log(mapQ_coef_len) into it (reference: src/bwamem.h:61,
        # src/bwamem.c:134-135) — so the default factor is 3, not
        # log(50)=3.912. MAPQs are ~60% of what the float formula gives;
        # verified against the in-tree bwa binary (tools/concordance.py).
        cached = self.__dict__.get("_mqf_cache")
        if cached is None or cached[0] != self.mapQ_coef_len:
            # -Q 0 switches mapQ to the seedcov branch; fork sets fac=0
            # (src/fastmap.c:213-216)
            fac = (float(int(math.log(self.mapQ_coef_len)))
                   if self.mapQ_coef_len > 0 else 0.0)
            cached = (self.mapQ_coef_len, fac)
            self.__dict__["_mqf_cache"] = cached
        return cached[1]

    @property
    def mat(self) -> np.ndarray:
        # cached; rebuilt only when (a, b) change (hot in per-record SAM gen)
        key = (self.a, self.b)
        cached = self.__dict__.get("_mat_cache")
        if cached is None or cached[0] != key:
            cached = (key, make_score_matrix(self.a, self.b))
            self.__dict__["_mat_cache"] = cached
        return cached[1]

    def scale_for_a(self) -> None:
        """-A rescaling of dependent penalties (reference: src/fastmap.c
        update_a / bwa-mem behavior when only -A given)."""
        self.b *= self.a
        self.o_del *= self.a
        self.o_ins *= self.a
        self.e_del *= self.a
        self.e_ins *= self.a
        self.zdrop *= self.a
        self.pen_clip5 *= self.a
        self.pen_clip3 *= self.a
        self.pen_unpaired *= self.a
        self.T *= self.a


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    """reference: src/bwamem.c:996-1003."""
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w << 1)


def hash_64(key: int) -> int:
    """Thomas Wang 64-bit mix (reference: src/utils.h hash_64) — used for
    deterministic alignment tie-breaking; must match bit-for-bit."""
    M = (1 << 64) - 1
    key = (key + (~(key << 32) & M)) & M
    key ^= key >> 22
    key = (key + (~(key << 13) & M)) & M
    key ^= key >> 8
    key = (key + (key << 3)) & M
    key ^= key >> 15
    key = (key + (~(key << 27) & M)) & M
    key ^= key >> 31
    return key
