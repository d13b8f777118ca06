"""The 90th percentile of time to first token over every request of
the window (nearest rank): a request's time runs from its batch's
submission until the batch's first tokens are on the host."""
from bench.lib.core import quantile_weighted


def read(run):
    if run.kind != "prefill" or not run.ttft_s:
        return None
    return 1e3 * quantile_weighted(run.ttft_s, run.ttft_n, 0.9)
