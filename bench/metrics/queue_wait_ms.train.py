"""The host's wait for a batch inside the data pipeline: the length
of the program's ``data.wait`` spans (``PrefetchIterator`` blocked on
its queue) over their number, in the traced steps
(``bench/lib/spans.py``)."""
from bench.lib import spans


def read(run):
    got = spans.of(run) if run.kind == "train" else None
    if got is None or not got["data_waits"]:
        return None
    return 1e3 * got["data_wait_s"] / got["data_waits"]
