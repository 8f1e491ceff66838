"""Device time of the operations launched from inside `cigar_device` spans
(the CIGAR kernel K5 with the copies of its inputs and rows), in the
traced window, per 1,000 window reads. A program without the span
reports nothing."""
LAYER = "kernels (ops/kernels, csrc)"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.kernel_seconds("cigar_device"))
