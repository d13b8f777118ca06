"""Launchers.  ``serve_stack`` is the serving facade: ``ServeConfig``
names every serving knob once and ``build_serving_stack`` wires executor
-> cache -> planner -> engine -> controller -> window -> fleet ->
ingestor in one call.  ``serve`` is the LM zoo's serving driver
(batched prefill + cached decode), ``train`` its training driver (the
similarity curriculum, checkpoints and resume) and ``steps`` their step
functions; the JAX package's mesh, spec and dry-run launchers are not
ported yet."""
from repro_torch.launch.serve_stack import (  # noqa: F401
    Ingestor,
    ServeConfig,
    ServingStack,
    build_serving_stack,
)
