"""Option packing for the native SE finalizer (bm_finalize_se_batch)."""
from __future__ import annotations

import numpy as np

from ..pipeline.options import (MEM_F_SOFTCLIP, MEM_F_ALL, MEM_F_NO_MULTI,
                                MEM_F_REF_HDR, MEM_F_NOPAIRING)


def pack_opts(opt):
    opt_i = np.asarray([
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.w, opt.T, opt.min_seed_len,
        opt.max_XA_hits, opt.max_XA_hits_alt, opt.mapQ_coef_len,
        1 if (opt.flag & MEM_F_SOFTCLIP) else 0,
        1 if (opt.flag & MEM_F_ALL) else 0,
        1 if (opt.flag & MEM_F_NO_MULTI) else 0,
        1 if (opt.flag & MEM_F_REF_HDR) else 0,
        opt.pen_unpaired,
        1 if (opt.flag & MEM_F_NOPAIRING) else 0,
    ], np.int32)
    opt_d = np.asarray([
        float(opt.drop_ratio), float(opt.XA_drop_ratio),
        float(opt.mask_level),
        float(opt.mapQ_coef_fac) if opt.mapQ_coef_len > 0 else 0.0,
    ], np.float64)
    return opt_d, opt_i
