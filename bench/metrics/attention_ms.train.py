"""Device time a train step launched under, or caused by, the program's
``layer.attention`` spans: the self-attention's forward, its
recomputation and its backward (``bench/lib/spans.py``), in the traced
steps."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "train", "attention_s", "layer.attention")
