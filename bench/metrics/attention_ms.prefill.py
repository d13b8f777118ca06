"""Device time a prefill batch launched under the program's
``layer.attention`` spans: the self-attention and its cache write
(``bench/lib/spans.py``), in the traced batches."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "prefill", "attention_s",
                             "layer.attention")
