"""Host wall time of the `pe_rescue` spans (pipeline/aligner.py around
pipeline/pairing.py's mate rescue: windows, K2, applying the hits) per
1,000 window reads. Pairs only: a run with no such span reports nothing."""
LAYER = "pipeline/pairing"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.span_seconds("pe_rescue"))
