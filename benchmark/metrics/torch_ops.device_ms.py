"""Device milliseconds per step in PyTorch's kernels: neither the port's
nor the optimizer's (GEMMs, LayerNorms, reductions, elementwise work)."""

from benchmark.trace import is_optimizer_kernel, is_port_kernel


def read(r):
    w = r.window
    if w is None:
        return None
    t = w.seconds(lambda k: not is_port_kernel(k) and not is_optimizer_kernel(k))
    return 1e3 * t / w.steps if t > 0 else None
