"""Mixture-of-Experts MLP with capacity-based dense dispatch.

Top-k routing (llama4 configs use top-1) with one-hot dispatch/combine
einsums.  Tokens over capacity are dropped (the residual passes
through).  Capacity is computed per dispatch group of at most
``MAX_DISPATCH_GROUP`` tokens, and a token's place in its expert's
queue is a cumsum in token order, as in the reference.

Ties in the router: ``jax.lax.top_k`` prefers the lower expert index;
``torch.topk`` promises no order among equal values, so ``route`` picks
the experts with a stable descending sort, which keeps the lower index
first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard_constraint
from repro_torch.models.layers import silu

MAX_DISPATCH_GROUP = 4096


def route(probs: torch.Tensor, k: int, capacity: int):
    """Routing of [G, t, E] router probabilities: each token's top-k
    experts (the lower index first among equal probabilities, as
    ``jax.lax.top_k``), its place in each chosen expert's queue (a
    cumsum in token order within its group) and whether it is kept
    (place < capacity).  Returns (gate values, zero where dropped,
    expert ids [G, t, k], one-hot [G, t, k, E], places, kept)."""
    n_groups, g_size, e = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    onehot = F.one_hot(expert_idx, e)                          # [G, t, k, E]
    flat = onehot.reshape(n_groups, g_size * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(
        n_groups, g_size, k, e)
    pos = (pos_in_expert * onehot).sum(-1)                     # [G, t, k]
    keep = pos < capacity
    return gate_vals * keep, expert_idx, onehot, pos, keep


def moe_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: [B, S, d_model] -> [B, S, d_model]."""
    bsz, s, d = x.shape
    e = cfg.n_experts
    k = cfg.top_k
    tokens = x.reshape(bsz * s, d)
    n_tok = tokens.shape[0]
    g_size = min(MAX_DISPATCH_GROUP, n_tok)
    # pad to a whole number of groups
    pad = (-n_tok) % g_size
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    n_groups = tokens.shape[0] // g_size
    tg = tokens.reshape(n_groups, g_size, d)
    capacity = max(1, int(cfg.capacity_factor * g_size * k / e))

    logits = (tg @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, _, onehot, pos, keep = route(probs, k, capacity)

    dtype = x.dtype
    pos_oh = F.one_hot(torch.where(keep, pos, capacity),
                       capacity + 1)[..., :capacity]           # [G, t, k, c]
    disp = torch.einsum("gtke,gtkc->gtec", onehot.to(dtype), pos_oh.to(dtype))
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot.float(),
                        pos_oh.float(), gate_vals.float()).to(dtype)

    # route tokens to experts: [E, G, c, d]
    xe = torch.einsum("gtec,gtd->egcd", disp, tg)
    xe = shard_constraint(xe, "experts", None, None, "d_model")
    gg = torch.einsum("egcd,edf->egcf", xe, p["w_gate"])
    uu = torch.einsum("egcd,edf->egcf", xe, p["w_up"])
    h = silu(gg) * uu
    h = shard_constraint(h, "experts", None, None, "d_ff")
    ye = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    out = torch.einsum("gtec,egcd->gtd", comb, ye)
    out = out.reshape(-1, d)
    if pad:
        out = out[:n_tok]
    return out.reshape(bsz, s, d)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f_i * P_i)."""
    tokens = x.reshape(-1, x.shape[-1])
    logits = (tokens @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(F.one_hot(top1, cfg.n_experts).float(), dim=0)
    prob_mean = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * prob_mean)
