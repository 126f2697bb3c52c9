"""The share of the traced sub-window in which no kernel ran on the device."""


def read(run):
    tr = run.rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100 * (1 - tr.busy_s / tr.window_s)
