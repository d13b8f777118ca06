"""Of a train step's backward device time, what was launched under a
``model.layer`` span inside ``train.backward``: the activation
checkpoint's recomputation (``bench/lib/spans.py``), in the traced
steps."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "train", "recompute_s", "model.layer")
