"""Host wall time of the `collect` spans (pipeline/runtime.py: seeding,
chaining, extension and, for pairs, pairing and rescue of a chunk),
summed over both collector threads, per 1,000 window reads. The two
threads overlap, so the sum can pass the window's length."""
LAYER = "cli and pipeline/runtime"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.span_seconds("collect"))
