"""Device time a prefill batch launched under the program's
``layer.ssm`` spans: the Mamba2 mixers, their state writes included
(``bench/lib/named_spans.py``), in the traced batches.  No value where
the window opened none (a model without Mamba2 layers, or a program
without the span)."""
from bench.lib import named_spans


def read(run):
    return named_spans.per_unit_ms(run, "prefill", "layer.ssm")
