"""Device time a train step launched under the program's
``train.optimizer`` span: the schedule and AdamW
(``bench/lib/spans.py``), in the traced steps."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "train", "optimizer_s", "train.optimizer")
