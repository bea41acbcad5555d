"""device_idle_share: the share of the profiled sub-window's wall in which
no kernel, copy or set ran on the card, in %."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
