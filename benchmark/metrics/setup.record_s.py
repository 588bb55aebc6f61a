"""Seconds of the warm-up steps: the eager step, the recording and the
first replay, each through ``epoch_train``."""


def read(r):
    return r.spans.get("record")
