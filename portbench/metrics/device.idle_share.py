"""Share of the traced window in which no operation ran on the card:
1 - (union of the device operations' intervals) / window, in %."""
LAYER = "device"
UNIT = "%"
MOVES = "reads_per_s"


def read(w):
    busy, win = w.busy_s(), w.window_s()
    if busy is None or not win:
        return None
    return 100.0 * (1.0 - busy / win)
