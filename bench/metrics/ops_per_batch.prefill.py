"""Device operations (kernels, copies, fills) a prefill batch
launches, counted in the profiler's trace of the traced batches."""


def read(run):
    t = run.traced
    if run.kind != "prefill" or not t or t["device_ops"] == 0:
        return None
    return t["device_ops"] / t["units"]
