"""AdamW with dtype-policy moments and optional 8-bit state.

Moments live in fp32 (default), bf16 (half the optimizer memory) or
blockwise-quantized int8 ("q8", a quarter).  The update math always
runs in fp32; only storage is compressed.  Plain functions on trees of
tensors, the JAX package's math op for op: decay is added to the Adam
direction after the moments (``torch.optim.AdamW`` decays first), the
bias corrections are ``b ** step`` in fp32, and only leaves with
``ndim >= 2`` are decayed.  That rule reads the stacked tree (layers
along a leading axis, ``models.model.param_defs``): a layer's norm
scale is ``[L, d]`` there and is decayed, ``final_norm`` ``[d]`` is
not.  So the training state is that tree, never the per-layer views.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.optimizer.quantized import Q8State, q8_dequantize, q8_quantize
from repro_torch.utils.trees import (
    tree_global_norm,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # "float32" | "bfloat16" | "q8"
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor   # int32 []
    m: Any               # tree matching params (tensors or Q8State leaves)
    v: Any


def _store(x: torch.Tensor, state_dtype: str):
    if state_dtype == "q8":
        return q8_quantize(x)
    if state_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def _load(x, ref_shape) -> torch.Tensor:
    if isinstance(x, Q8State):
        return q8_dequantize(x, ref_shape)
    return x.float()


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype`` on each parameter's device."""
    def zeros(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), cfg.state_dtype)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _is_q8(x) -> bool:
    return isinstance(x, Q8State)


def adamw_update(params, grads, opt_state: OptState, cfg: AdamWConfig,
                 lr_scale: "torch.Tensor | float" = 1.0,
                 gnorm: "torch.Tensor | None" = None):
    """Returns (new_params, new_opt_state, metrics dict).  ``gnorm``,
    the clipping norm, is ``tree_global_norm(grads)`` unless given (the
    sharded step passes the whole gradient's norm; ``grads`` are then
    local shards)."""
    if gnorm is None:
        gnorm = tree_global_norm(grads)
    # a tensor divided, not ``scalar / tensor`` (torch takes that as a
    # reciprocal and a product: two roundings)
    clip_coef = (torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                             / torch.clamp(gnorm, min=1e-9), max=1.0)
                 if cfg.grad_clip > 0 else 1.0)
    step = opt_state.step + 1
    step_f = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), step_f)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), step_f)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)

    def upd(p, g, m_s, v_s):
        g = g.float() * clip_coef
        m = _load(m_s, p.shape) * cfg.b1 + (1 - cfg.b1) * g
        v = _load(v_s, p.shape) * cfg.b2 + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:   # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, _store(m, cfg.state_dtype), _store(v, cfg.state_dtype)

    flat_p = tree_leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, tree_leaves(grads),
               tree_leaves(opt_state.m, is_leaf=_is_q8),
               tree_leaves(opt_state.v, is_leaf=_is_q8))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(step, new_m, new_v), metrics

