"""User and system CPU time of the program's process (and of any host
workers it forked and reaped) from the first chunk's end to the last,
per 1,000 window reads."""
LAYER = "host"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.cpu_seconds())
