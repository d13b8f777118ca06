"""Device time a train step launched under, or caused by, the program's
``model.cast`` span: the stacked parameters' cast to the compute dtype
and its backward, the gradients' cast back (``bench/lib/spans.py``),
in the traced steps."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "train", "cast_s", "model.cast")
