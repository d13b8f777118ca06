"""The device's idle time inside the host intervals of the program's
``serve.init_state`` spans (the decode state's allocation and zeroing),
a batch, in the traced batches (``bench/lib/spans.py``)."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "prefill", "init_state_idle_s",
                             "serve.init_state")
