"""Prefill throughput: the prompt tokens of every batch of the window,
over the window, which runs to the last batch's first tokens on the
host."""


def read(run):
    if run.kind != "prefill" or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
