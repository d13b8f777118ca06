"""Checkpointing on the JAX package's layout: atomic commit, chunked
leaves, async writes and retention."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    save_checkpoint,
    restore_checkpoint,
    latest_step,
)
