"""Device milliseconds per step in the port's own kernels (``gasfm::``)."""

from benchmark.trace import is_port_kernel


def read(r):
    w = r.window
    t = 0.0 if w is None else w.seconds(is_port_kernel)
    if t <= 0:
        return None
    return 1e3 * t / w.steps
