"""Device operations (kernels, copies, fills) a training step
launches, counted in the profiler's trace of the traced steps."""


def read(run):
    t = run.traced
    if run.kind != "train" or not t or t["device_ops"] == 0:
        return None
    return t["device_ops"] / t["units"]
