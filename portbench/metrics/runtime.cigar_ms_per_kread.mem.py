"""`runtime.cigar_ms_per_kread` in the cells whose `reads_per_s` is not
held end to end (its runs spread past the largest bound an end-to-end
metric may have; PERF.md §2): the same reading, naming the end-to-end
metric those cells report besides `setup_s`."""
LAYER = "cli and pipeline/runtime"
UNIT = "ms/kread"
MOVES = "device_mem_peak_mib"


def read(w):
    return w.per_kread_ms(w.span_seconds("cigar_device"))
