"""Suffix-array construction.

Two backends:
  * a NumPy prefix-doubling implementation (O(n log n) sorts) — always
    available, fine up to tens of Mbp;
  * a native C++ SA-IS implementation (bwamem_tpu_torch/native) loaded via ctypes
    when the shared library has been built — linear time, for large genomes.

The reference builds its suffix array inside `bwa index` (is.c / bwt_gen.c /
rope.c, see SURVEY §2 component 9); we build it offline in the index
toolchain and derive BWT + sampled SA from it directly.
"""
from __future__ import annotations

import numpy as np

from ..native import loader as _native


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of `codes` (values 0..k, no sentinel appended by caller).

    Returns int64 positions of suffixes in lexicographic order, where the
    (virtual) empty suffix / terminal sentinel is NOT included — callers that
    need the sentinel row prepend it themselves (it always sorts first).
    """
    lib = _native.try_load()
    if lib is not None:
        return _native.sais(lib, codes)
    return _suffix_array_numpy(codes)


def _suffix_array_numpy(codes: np.ndarray) -> np.ndarray:
    s = np.asarray(codes, dtype=np.int64)
    n = len(s)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    # rank = current order of single chars; sentinel handled as rank -1 at
    # virtual position n (suffix comparisons pad with -1 which sorts first).
    rank = s.copy()
    sa = np.argsort(rank, kind="stable")  # initial: stable sort not enough, refine below
    k = 1
    while True:
        # key = (rank[i], rank[i+k]) with out-of-range = -1
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        # recompute ranks
        r_o = rank[order]
        s_o = second[order]
        new_rank = np.empty(n, dtype=np.int64)
        diff = np.ones(n, dtype=np.int64)
        diff[1:] = (r_o[1:] != r_o[:-1]) | (s_o[1:] != s_o[:-1])
        new_rank[order] = np.cumsum(diff) - 1
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2
