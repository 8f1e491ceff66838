"""Array-backed alignment-region container (SE fast path).

The native collect path (aligner._collect_native) produces flat
survivor arrays, and the native finalize path consumes flat arrays
(native/loader.py:_reg_arrays). The AlnReg object round-trip between
them — build ~28k dataclass objects per 16k-read chunk, then
immediately re-flatten them — was pure GIL-holding Python overhead
(~0.16 s/chunk on chip, BENCH_BREAKDOWN.md). This container carries
the arrays straight through HostPool.emit_se; Python consumers (int
indexing, iteration — tests, the PE pairing path, verbose dumps) get
AlnReg lists materialized on demand.
"""
from __future__ import annotations

import numpy as np

# column name -> dtype, in native/loader.py:_reg_arrays return order
COLS = (("rb", np.int64), ("re", np.int64), ("qb", np.int32),
        ("qe", np.int32), ("score", np.int32), ("truesc", np.int32),
        ("sub", np.int32), ("csub", np.int32), ("w", np.int32),
        ("seedcov", np.int32), ("rid", np.int32), ("is_alt", np.int8),
        ("frac", np.float64))


class RegArrays:
    """Per-read alignment regions as flat columns + a (B+1,) offset
    table. Slicing (used by HostPool's worker split) returns a cheap
    view-like copy; int indexing materializes the read's AlnReg list."""

    __slots__ = ("off", "cols", "n_comp")

    def __init__(self, off: np.ndarray, cols: dict[str, np.ndarray],
                 n_comp: np.ndarray | None = None):
        self.off = off
        self.cols = cols
        self.n_comp = n_comp

    def __len__(self) -> int:
        return len(self.off) - 1

    def _read_objs(self, b: int) -> list:
        from .regions import AlnReg

        lo, hi = int(self.off[b]), int(self.off[b + 1])
        c = self.cols
        out = []
        for k in range(lo, hi):
            out.append(AlnReg(
                rb=int(c["rb"][k]), re=int(c["re"][k]),
                qb=int(c["qb"][k]), qe=int(c["qe"][k]),
                rid=int(c["rid"][k]), score=int(c["score"][k]),
                truesc=int(c["truesc"][k]), sub=int(c["sub"][k]),
                csub=int(c["csub"][k]), w=int(c["w"][k]),
                seedcov=int(c["seedcov"][k]),
                n_comp=(int(self.n_comp[k])
                        if self.n_comp is not None else 1),
                is_alt=bool(c["is_alt"][k]),
                frac_rep=float(c["frac"][k])))
        return out

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(len(self))
            if step != 1:
                raise IndexError("RegArrays supports unit-step slices")
            o0, o1 = int(self.off[lo]), int(self.off[hi])
            return RegArrays(
                self.off[lo:hi + 1] - o0,
                {k: v[o0:o1] for k, v in self.cols.items()},
                self.n_comp[o0:o1] if self.n_comp is not None else None)
        b = int(idx)
        if b < 0:
            b += len(self)
        if not 0 <= b < len(self):
            raise IndexError(b)
        return self._read_objs(b)

    def __iter__(self):
        for b in range(len(self)):
            yield self._read_objs(b)

    def to_lists(self) -> list[list]:
        return [self._read_objs(b) for b in range(len(self))]

    def flat(self):
        """(reg_off, columns in _reg_arrays order) — the native finalize
        marshalling, with zero per-object work."""
        c = self.cols
        return (np.ascontiguousarray(self.off, np.int64),) + tuple(
            np.ascontiguousarray(c[name], dt) for name, dt in COLS)
