"""Share of the traced window (%) in which no operation ran on the
device: 1 − (union of the device's operation intervals) / window."""


def read(cell, win):
    t = win.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
