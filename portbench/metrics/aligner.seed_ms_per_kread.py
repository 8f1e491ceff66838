"""Host wall time of the `seed_device` spans (pipeline/aligner.py: SMEM
seeding on the card, ending at the host's copy of the seeds, so device
time and syncs are inside) per 1,000 window reads."""
LAYER = "pipeline/aligner"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.span_seconds("seed_device"))
