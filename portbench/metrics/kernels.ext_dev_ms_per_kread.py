"""Device time of the operations launched from inside `ext_device` spans
(the extension kernels K1/K3 with their job binning and copies), in the
traced window, per 1,000 window reads."""
LAYER = "kernels (ops/kernels, csrc)"
UNIT = "ms/kread"
MOVES = "reads_per_s"


def read(w):
    return w.per_kread_ms(w.kernel_seconds("ext_device"))
