"""Step functions: ``make_train_step`` builds loss -> grad ->
(micro-batched accumulation) -> AdamW update; ``make_prefill_step`` /
``make_decode_step`` wrap the model's serving entry points.  (The
sharding trees of the JAX package's module wait for the distributed
slice.)"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optimizer.adamw import AdamWConfig, adamw_update
from repro_torch.optimizer.schedules import cosine_warmup_schedule
from repro_torch.utils.trees import tree_leaves, tree_unflatten


def _value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, gradient tree of ``params``) of ``M.loss_fn``; a leaf the
    loss does not reach gets a zero gradient, as JAX gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = M.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, total_steps: int = 10000,
                    warmup_steps: int = 200,
                    accum_dtype: Optional[torch.dtype] = None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics) over the stacked parameter tree.  With
    ``microbatches`` > 1 the batch is split along its first axis and the
    gradients are summed in ``accum_dtype`` (default fp32) in batch
    order, then divided by ``microbatches``; the loss is the mean of the
    micro-batches' losses.  The lr scale is the cosine-warmup schedule
    at ``opt_state.step`` before the update (so the first update of a
    run with ``warmup_steps`` > 0 has lr 0).  ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-dim tensors on the device
    (reading one synchronises)."""
    acc_dt = accum_dtype or torch.float32

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, grads = _value_and_grad(params, batch, cfg)
        else:
            def part(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]
            acc = None
            losses = []
            for i in range(microbatches):
                mb = {k: part(v, i) for k, v in batch.items()}
                loss_i, g = _value_and_grad(params, mb, cfg)
                g = [x.to(acc_dt) for x in tree_leaves(g)]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                losses.append(loss_i)
            grads = tree_unflatten(params, [a / microbatches for a in acc])
            loss = torch.stack(losses).mean()
        lr_scale = cosine_warmup_schedule(
            opt_state.step, warmup_steps=warmup_steps,
            total_steps=total_steps)
        params, opt_state, metrics = adamw_update(
            params, grads, opt_state, opt_cfg, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, state):
        return M.prefill(params, tokens, cfg, state)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, state):
        return M.decode_step(params, token, cfg, state)
    return decode_step
