"""Device time a train step launched under, or caused by, the program's
``model.head`` and ``model.loss`` spans: the final norm, the logits,
the cross-entropy and their backward (``bench/lib/spans.py``), in the
traced steps."""
from bench.lib import spans


def read(run):
    return spans.per_unit_ms(run, "train", "head_loss_s", "model.loss")
