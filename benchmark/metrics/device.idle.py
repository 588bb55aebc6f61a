"""The share of the traced window in which no operation ran on the device."""


def read(r):
    w = r.window
    if w is None or w.busy_s <= 0 or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
