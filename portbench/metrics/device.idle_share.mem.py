"""`device.idle_share` in the cells whose `reads_per_s` is not held end to
end (its runs spread past the largest bound an end-to-end metric may
have; PERF.md §2): the same reading, naming the end-to-end metric those
cells report besides `setup_s`."""
LAYER = "device"
UNIT = "%"
MOVES = "device_mem_peak_mib"


def read(w):
    busy, win = w.busy_s(), w.window_s()
    if busy is None or not win:
        return None
    return 100.0 * (1.0 - busy / win)
