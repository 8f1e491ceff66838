"""`reads_per_s` in the cells whose runs spread past the largest bound an
end-to-end metric may have (PERF.md §2): the same rate, window reads (both
mates count) over the time from the window's start to the last SAM
record, reported per layer. It names the end-to-end metric those cells
report besides `setup_s`."""
LAYER = "cli and pipeline/runtime"
UNIT = "reads/s"
MOVES = "device_mem_peak_mib"


def read(w):
    wall = w.end - w.start
    return w.reads / wall if w.reads > 0 and wall > 0 else None
