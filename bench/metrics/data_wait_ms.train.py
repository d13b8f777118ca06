"""The host's wait on the data pipeline: the host clock around the
benchmark's ``next()`` on the prefetched stream, mean per step of the
window."""


def read(run):
    if run.kind != "train" or run.units == 0:
        return None
    return 1e3 * run.data_wait_s / run.units
