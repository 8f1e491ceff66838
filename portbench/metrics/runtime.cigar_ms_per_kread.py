"""Host wall time of the `cigar_device` spans (pipeline/finalize.py: the
finalize's CIGAR solve on the card, from the upload of the reads and the
jobs to the copy-back of the rows) per 1,000 window reads. A program
without the span reports nothing."""
LAYER = "cli and pipeline/runtime"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.span_seconds("cigar_device"))
