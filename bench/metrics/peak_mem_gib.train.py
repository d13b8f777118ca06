"""The device memory the train window held at its peak
(``max_memory_allocated`` after a reset at the window's start)."""


def read(run):
    if run.kind != "train" or run.window_peak_bytes <= 0:
        return None
    return run.window_peak_bytes / 2 ** 30
