"""Launchers.  ``serve_stack`` is the serving facade: ``ServeConfig``
names every serving knob once and ``build_serving_stack`` wires executor
-> cache -> planner -> engine -> controller -> window -> fleet ->
ingestor in one call.  The LM launchers of the JAX package's
``launch/`` are not ported yet."""
from repro_torch.launch.serve_stack import (  # noqa: F401
    Ingestor,
    ServeConfig,
    ServingStack,
    build_serving_stack,
)
