"""Banded global alignment dispatch: native C++ when available, Python
oracle otherwise. Used for CIGAR generation (reference: src/bwa.c:111
bwa_gen_cigar2) and the mem_patch_reg score probe. Both backends are
tested for identical output (tests/test_native_ksw.py)."""
from __future__ import annotations

from ..oracle.ksw import ksw_global as _py_ksw_global

_LIB = None


def ksw_global(query, target, mat, o_del, e_del, o_ins, e_ins, w,
               want_cigar: bool = True):
    """Returns (score, cigar) with cigar = [(op, len), ...]."""
    global _LIB
    if _LIB is None:
        from ..native import loader

        _LIB = loader.try_load() or False
    if _LIB:
        from ..native.loader import ksw_global_native

        return ksw_global_native(_LIB, query, target, mat, o_del, e_del,
                                 o_ins, e_ins, w, want_cigar=want_cigar)
    return _py_ksw_global(query, target, mat, o_del, e_del, o_ins, e_ins,
                          w, want_cigar=want_cigar)
