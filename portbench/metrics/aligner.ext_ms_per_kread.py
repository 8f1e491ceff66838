"""Host wall time of the `ext_device` spans (pipeline/aligner.py: the seed
extension jobs on the card) per 1,000 window reads."""
LAYER = "pipeline/aligner"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.span_seconds("ext_device"))
