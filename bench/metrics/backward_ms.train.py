"""Device time a train step launched under the program's
``train.backward`` span, the autograd's device thread and the
recomputation of the checkpointed layers included
(``bench/lib/spans.py``), in the traced steps."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "train", "backward_s", "train.backward")
