"""Device milliseconds per step in the optimizer's kernels."""

from benchmark.trace import is_optimizer_kernel


def read(r):
    w = r.window
    t = 0.0 if w is None else w.seconds(is_optimizer_kernel)
    return 1e3 * t / w.steps if t > 0 else None
