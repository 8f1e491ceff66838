"""Device time of the operations launched from inside `seed_device` spans
(the seeding kernels S1-S4 and the torch ops around them), in the traced
window, per 1,000 window reads. Given to the span by where each kernel
was launched, not by its name."""
LAYER = "kernels (ops/kernels, csrc)"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.kernel_seconds("seed_device"))
