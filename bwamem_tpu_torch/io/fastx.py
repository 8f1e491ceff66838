"""FASTA/FASTQ reading and chunking.

Equivalent of the reference's bseq_read + kseq (reference: src/bwa.c:42
bseq_read, src/kseq.h), including the chunk-size policy: read records until
the accumulated base count passes chunk_size (actual_chunk_size =
chunk_size * n_threads, reference src/fastmap.c:62-67).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..utils.dna import encode


def open_maybe_gzip(path: str):
    """Binary stream over `path`, transparently gunzipping (the reference
    reads gzipped FASTA/FASTQ through kseq+zlib, src/kseq.h/src/bwa.c)."""
    import gzip
    import io
    import sys

    f = sys.stdin.buffer if path == "-" else open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def _trim_readno(name: str) -> str:
    """Drop a trailing /1 or /2 (reference: src/bwa.c trim_readno via
    bseq_read) so mate QNAMEs match."""
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


@dataclass
class SeqRecord:
    name: str
    seq: np.ndarray          # 0..4 codes
    qual: str | None = None
    comment: str | None = None


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Streaming FASTA/FASTQ parser. Uses the native C++ scanner when
    available (equivalent of the reference's kseq lexer on the input
    pipeline thread, src/kseq.h); falls back to pure Python for
    multi-line FASTA or when the native lib is unavailable."""
    from ..native import loader

    lib = loader.try_load()
    if lib is not None:
        yielded_any = False
        try:
            for rec in _read_fastx_native(lib, path):
                yielded_any = True
                yield rec
            return
        except _NativeParseFallback:
            if yielded_any:
                raise RuntimeError(
                    "native FASTX scanner failed mid-file; mixed "
                    "single/multi-line input is unsupported")
    yield from _read_fastx_py(path)


class _NativeParseFallback(Exception):
    pass


def _read_fastx_native(lib, path: str,
                       chunk: int = 8 << 20) -> Iterator[SeqRecord]:
    import ctypes

    CHUNK = chunk
    CAP = 1 << 16
    recs = np.empty(CAP * 5, np.int64)
    recs_p = recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    nrec = ctypes.c_int64()
    buf = b""
    with open_maybe_gzip(path) as f:
        eof = False
        while not eof or buf:
            if not eof:
                more = f.read(CHUNK)
                eof = not more
                buf += more
            consumed_total = 0
            while True:
                view = buf[consumed_total:]
                if not view:
                    break
                consumed = lib.bm_fastx_scan(
                    view, len(view), int(eof), recs_p, CAP,
                    ctypes.byref(nrec))
                if consumed < 0:
                    raise _NativeParseFallback()
                n = nrec.value
                if n == 0 and consumed == 0:
                    if eof:
                        raise _NativeParseFallback()  # stuck: malformed
                    break
                codes = np.frombuffer(view, np.uint8)
                table = _CODE_LUT
                for i in range(n):
                    nb, ne, sb, se, qb = recs[i * 5 : i * 5 + 5]
                    seq = table[codes[sb:se]]
                    qual = (view[qb : qb + (se - sb)].decode()
                            if qb >= 0 else None)
                    # header tail after the name = the comment
                    cm = view[ne : sb - 1].strip()
                    yield SeqRecord(
                        name=_trim_readno(view[nb:ne].decode()),
                        seq=seq, qual=qual,
                        comment=cm.decode() if cm else None)
                consumed_total += consumed
                if n < CAP:
                    break
            buf = buf[consumed_total:]
            if eof and consumed_total == 0 and buf:
                raise _NativeParseFallback()


_CODE_LUT = np.full(256, 4, np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _CODE_LUT[_ch] = _i
    _CODE_LUT[_ch + 32] = _i  # lowercase


def _read_fastx_py(path: str) -> Iterator[SeqRecord]:
    """Pure-Python fallback parser (handles multi-line FASTA)."""
    with open_maybe_gzip(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        is_fastq = first == b"@"
        if is_fastq:
            while True:
                hdr = f.readline()
                if not hdr:
                    return
                seq = f.readline().strip()
                f.readline()  # +
                qual = f.readline().strip()
                parts = hdr[1:].strip().split(None, 1)
                yield SeqRecord(
                    name=_trim_readno(parts[0].decode()),
                    seq=encode(seq),
                    qual=qual.decode(),
                    comment=parts[1].decode() if len(parts) > 1 else None,
                )
        else:
            name = None
            comment = None
            chunks: list[bytes] = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b">"):
                    if name is not None:
                        yield SeqRecord(name, encode(b"".join(chunks)),
                                        None, comment)
                    parts = line[1:].split(None, 1)
                    name = _trim_readno(parts[0].decode())
                    comment = parts[1].decode() if len(parts) > 1 else None
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield SeqRecord(name, encode(b"".join(chunks)), None, comment)


def chunk_records(records: Iterator[SeqRecord], chunk_bases: int,
                  paired: bool = False) -> Iterator[list[SeqRecord]]:
    """Group records into chunks of ~chunk_bases total bases (the
    reference reads one extra record past the threshold; we stop at it).
    With paired=True a chunk boundary never splits a read pair (the
    reference keeps chunks even-sized the same way, src/bwa.c:76-78)."""
    batch: list[SeqRecord] = []
    size = 0
    for rec in records:
        batch.append(rec)
        size += len(rec.seq)
        if size >= chunk_bases and not (paired and len(batch) % 2):
            yield batch
            batch, size = [], 0
    if batch:
        yield batch
