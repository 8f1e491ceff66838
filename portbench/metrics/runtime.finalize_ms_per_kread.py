"""Host wall time of the `finalize` spans (pipeline/runtime.py: marking
primaries, pairing, CIGAR and SAM text of a chunk; on the main thread at
-t 1) per 1,000 window reads."""
LAYER = "cli and pipeline/runtime"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.span_seconds("finalize"))
