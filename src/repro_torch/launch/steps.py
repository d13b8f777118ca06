"""Step functions of the serving path: ``make_prefill_step`` /
``make_decode_step`` wrap the model's serving entry points.  (The
training step and the sharding trees of the JAX package's module wait
for the training and distributed slices.)"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, state):
        return M.prefill(params, tokens, cfg, state)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, state):
        return M.decode_step(params, token, cfg, state)
    return decode_step
