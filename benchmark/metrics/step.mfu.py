"""The whole step's share of the card's float32 peak: the model's
operations per step (``benchmark.counts``) over the device's time per step,
from its first operation's start to its last one's end in the trace."""

from benchmark.roofline import F32_FLOPS_PER_S


def read(r):
    w = r.window
    if w is None or w.span_s <= 0 or not r.model_flops:
        return None
    return 100.0 * r.model_flops / (w.span_s / w.steps) / F32_FLOPS_PER_S
