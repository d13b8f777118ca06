"""Training throughput: the tokens of every step of the window, over
the window (host clock, the device synchronised at both ends)."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
