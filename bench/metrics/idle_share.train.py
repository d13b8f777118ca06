"""The share of the traced window in which no operation ran on the
device: 1 - (union of the device's intervals) / window, from the
profiler's trace of a few train units run after the window."""


def read(run):
    t = run.traced
    if run.kind != "train" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
