"""Program spans for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler is running, and otherwise one shared no-op context, so that
with no profiler a span costs one flag check.  The profiler being on is
the only switch: no setting, no environment variable.  The spans land
in the profiler's own trace (``export_chrome_trace``) as
``user_annotation`` events, on the clock of the kernels they launch.

``SPANS`` names every span the port opens:

  * ``train.forward``, ``train.backward``, ``train.optimizer``: the
    three phases of a train step (``launch/steps.py``);
  * ``model.cast``: the cast of the stacked parameters to the compute
    dtype in ``models/model.loss_fn``;
  * ``model.layer``: one layer (group) body, inside its activation
    checkpoint, so that its recomputation in the backward opens it
    again;
  * ``layer.attention``: a block's self-attention sublayer, its cache
    write included (``models/blocks.apply_block``);
  * ``model.head``, ``model.loss``: the final norm and the logits; the
    cross-entropy and its masked mean;
  * ``serve.init_state``: ``models/model.init_decode_state``;
  * ``data.wait``: ``data/pipeline.PrefetchIterator``'s wait for a
    batch.

``SSM_SPANS`` names the published Mamba2 mixer's two
(``models/blocks.apply_interleaved``, ``models/ssm.mamba2_apply``):

  * ``layer.ssm``: a layer's Mamba2 mixer, its state write included;
  * ``ssm.scan``: the SSD scan inside it (``ssm.ssd_chunked``).
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

SPANS = ("train.forward", "train.backward", "train.optimizer",
         "model.cast", "model.layer", "layer.attention", "model.head",
         "model.loss", "serve.init_state", "data.wait")
SSM_SPANS = ("layer.ssm", "ssm.scan")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the running profiler's trace;
    the shared no-op where no profiler runs."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
