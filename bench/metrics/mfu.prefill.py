"""Model flops utilization of the prefill window: the configuration's
model flops of the window's work (its formula in
``bench/configs/<config>.py``, from the shapes alone: no
recomputation, no masked work) over the window and the H100's dense
bfloat16 peak."""


def read(run):
    if run.kind != "prefill" or run.window_s <= 0:
        return None
    return 100.0 * run.model_flops / (run.window_s * run.peak_flops)
