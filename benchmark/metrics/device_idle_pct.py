"""Share of the traced window in which the profiler shows no kernel, copy or
memset on the card (the union of device intervals)."""


def read(t):
    d = t.device
    if d is None or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
