"""Mixture-of-Experts MLP with capacity-based dispatch.

Top-k routing (llama4 configs use top-1).  Tokens over capacity are
dropped (the residual passes through).  Capacity is computed per
dispatch group of at most ``MAX_DISPATCH_GROUP`` tokens, and a token's
place in its expert's queue is a cumsum in token order, as in the
reference.  Each kept choice is copied into its (expert, group, place)
slot, the expert FFN runs on the ``[E, G, c, d]`` slots, and each token
takes its gates times its slots' outputs: the reference's one-hot
dispatch and combine einsums without their products by zero.

Ties in the router: ``jax.lax.top_k`` prefers the lower expert index;
``torch.topk`` promises no order among equal values, so ``top_k`` picks
the experts with a stable descending sort, which keeps the lower index
first.

The block is written for a contiguous slice of the micro-batch's
tokens and a range of its experts.  Unsharded, the slice is the whole
micro-batch with no peers, and the range is every expert.

**Expert parallelism** (the sharded train step passes a ``MoEShard``).
A rank holds a contiguous slice of the micro-batch's rows (split over
the batch axes) and the experts of its ``model`` coordinate, and
computes the reference's global-batch math for its slice:

  * routing over all ``E`` experts, on its own rows;
  * a token's place in its expert's queue: the counts of the batch
    peers before it in the same (group, expert) (``slice_counts``,
    gathered), plus the slice's own cumsum (``slice_places``); groups
    and capacity are the global micro-batch's, and the global padding
    lies after every real token, so a rank ignores it;
  * dispatch, FFN and combine over its experts only
    (``expert_range_output``), summed over ``model``: a top-1 token
    has one non-zero term, so the sum is exact;
  * the load-balancing statistics summed over the batch axes before
    their product (``aux_sums``, ``aux_from_sums``).

The batch is not split over ``model`` (the default rules), so every
``model`` rank routes the same rows and no all-to-all is needed; the
region's replicated inputs (the tokens, the router) sum their
gradients over ``model``, and the aux loss, computed whole on every
``model`` rank, does not.  On a mesh of one device every collective is
the identity, and the block is the unsharded one op for op.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import silu

MAX_DISPATCH_GROUP = 4096


class MoEShard(NamedTuple):
    """One rank's place in the sharded train step, for the MoE block:
    the ``MeshAxes``, the live batch axes (this rank holds rows
    ``[first_row, first_row + rows)`` of the micro-batch, in
    ``linear_rank(batch)`` order) and the live axes the expert dim is
    split over."""
    axes: Any
    batch: Tuple[str, ...]
    first_row: int
    experts: Tuple[str, ...]

    @property
    def batch_ranks(self) -> int:
        n = 1
        for a in self.batch:
            n *= self.axes.size[a]
        return n


def group_size(n_tok: int) -> int:
    """Dispatch group size of a micro-batch of ``n_tok`` tokens."""
    return min(MAX_DISPATCH_GROUP, n_tok)


def expert_capacity(cfg, g_size: int) -> int:
    return max(1, int(cfg.capacity_factor * g_size * cfg.top_k
                      / cfg.n_experts))


def router_probs(tokens: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """float32 softmax of ``tokens @ router`` over the experts."""
    return torch.softmax((tokens @ router).float(), dim=-1)


def top_k(probs: torch.Tensor, k: int):
    """(gate values, expert ids) of each row's ``k`` largest
    probabilities, the lower index first among equal ones."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_ids(first: int, n: int, n_tok: int,
              device=None) -> torch.Tensor:
    """[n] global dispatch group of each token of the slice ``[first,
    first + n)`` of a micro-batch of ``n_tok`` tokens."""
    return torch.div(torch.arange(first, first + n, device=device),
                     group_size(n_tok), rounding_mode="floor")


def slice_groups(first: int, n: int, n_tok: int) -> Tuple[int, int]:
    """(first group, groups) that the slice ``[first, first + n)`` of a
    micro-batch of ``n_tok`` tokens falls in: the slots it fills."""
    g = group_size(n_tok)
    return first // g, (first + n - 1) // g - first // g + 1


def slice_counts(expert_idx: torch.Tensor, grp: torch.Tensor,
                 n_groups: int, e: int) -> torch.Tensor:
    """[n_groups, E] int64: how many of the slice's (token, k) choices
    fall on each (group, expert)."""
    per_tok = F.one_hot(expert_idx, e).sum(1)                  # [n, E]
    return per_tok.new_zeros((n_groups, e)).index_add_(0, grp, per_tok)


def slice_places(expert_idx: torch.Tensor, grp: torch.Tensor,
                 before: torch.Tensor) -> torch.Tensor:
    """[n, k] place of each of the slice's choices in its expert's
    queue: ``before`` [n_groups, E] (the choices of the micro-batch
    before the slice, by group and expert) plus the slice's own cumsum
    within the group, in the order token, then k."""
    n, k = expert_idx.shape
    e = before.shape[1]
    onehot = F.one_hot(expert_idx, e)                          # [n, k, E]
    flat = onehot.reshape(n * k, e)
    excl = (torch.cumsum(flat, dim=0) - flat).reshape(n, k, e)
    local = slice_counts(expert_idx, grp, before.shape[0], e)
    start = torch.cumsum(local, dim=0) - local   # the slice's, before g
    base = (before - start)[grp]                               # [n, E]
    return ((excl + base[:, None, :]) * onehot).sum(-1)


def expert_range_output(w: dict, tokens: torch.Tensor,
                        gate_vals: torch.Tensor, expert_idx: torch.Tensor,
                        places: torch.Tensor, grp: torch.Tensor,
                        groups: Tuple[int, int], capacity: int,
                        e0: int) -> torch.Tensor:
    """[n, d]: the slice's MoE output from the experts ``[e0, e0 +
    E_loc)`` alone, whose weights ``w`` (``w_gate``, ``w_up``,
    ``w_down``) are ``[E_loc, ...]``: each kept choice on one of them
    is copied into its (expert, group, place) slot, the FFN runs on
    the ``[E_loc, G, c, d]`` slots as the reference's, and each token
    takes its gate (rounded to the compute dtype) times its slots'
    outputs, summed over its choices in float32.  ``groups`` is (first
    group, groups) of the slots: those the slice's tokens fall in
    (``slice_groups``)."""
    n, d = tokens.shape
    k = expert_idx.shape[1]
    e_loc = w["w_gate"].shape[0]
    g0, n_g = groups
    n_slots = e_loc * n_g * capacity
    mine = (places < capacity) & (expert_idx >= e0) & \
        (expert_idx < e0 + e_loc)
    slot = ((expert_idx - e0) * n_g + (grp - g0)[:, None]) * capacity + places
    slot = torch.where(mine, slot, n_slots).reshape(n * k)     # sink: n_slots
    src = tokens[:, None, :].expand(n, k, d).reshape(n * k, d)
    xe = tokens.new_zeros((n_slots + 1, d)).index_copy(0, slot, src)
    xe = xe[:n_slots].reshape(e_loc, n_g, capacity, d)
    gg = torch.einsum("egcd,edf->egcf", xe, w["w_gate"])
    uu = torch.einsum("egcd,edf->egcf", xe, w["w_up"])
    ye = torch.einsum("egcf,efd->egcd", silu(gg) * uu, w["w_down"])
    ye = torch.cat([ye.reshape(n_slots, d), ye.new_zeros((1, d))])
    yt = ye.index_select(0, slot).reshape(n, k, d)
    comb = (gate_vals * mine).to(tokens.dtype)
    return (comb.float()[..., None] * yt.float()).sum(1).to(tokens.dtype)


def aux_sums(probs: torch.Tensor) -> torch.Tensor:
    """[2, E]: the slice's top-1 counts and its sums of the router
    probabilities [n, E], the load-balancing loss's statistics."""
    top1 = torch.argmax(probs, dim=-1)
    return torch.stack([F.one_hot(top1, probs.shape[-1]).float().sum(0),
                        probs.sum(0)])


def aux_from_sums(sums: torch.Tensor, n_tok: int) -> torch.Tensor:
    """The load-balancing loss from the micro-batch's ``aux_sums``
    (summed over its slices) and its token count."""
    frac, prob_mean = sums[0] / n_tok, sums[1] / n_tok
    return sums.shape[1] * torch.sum(frac * prob_mean)


def moe_apply(p: dict, x: torch.Tensor, cfg, shard=None) -> torch.Tensor:
    """x: [B, S, d_model] -> [B, S, d_model]: the whole micro-batch, or
    with a ``MoEShard`` this rank's rows of it (module docstring)."""
    rows, s, d = x.shape
    n = rows * s
    tokens, router = x.reshape(n, d), p["router"]
    w = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
    first, n_tok, e0 = 0, n, 0
    if shard is not None:
        from repro_torch.distributed import collectives as C
        ax = shard.axes
        first, n_tok = shard.first_row * s, n * shard.batch_ranks
        e0 = ax.linear_rank(shard.experts) * w["w_gate"].shape[0]
        tokens = C.region_in(tokens, ax, shard.experts)
        router = C.region_in(router, ax, shard.experts)
    gate_vals, expert_idx = top_k(router_probs(tokens, router), cfg.top_k)
    g_size = group_size(n_tok)
    n_groups = -(-n_tok // g_size)
    grp = group_ids(first, n, n_tok, x.device)
    before = expert_idx.new_zeros((n_groups, cfg.n_experts))
    if shard is not None:
        counts = slice_counts(expert_idx, grp, n_groups, cfg.n_experts)
        peers = ax.all_gather_axes(counts, shard.batch, "count-all-gather")
        before = peers[:ax.linear_rank(shard.batch)].sum(0)
    out = expert_range_output(
        w, tokens, gate_vals, expert_idx,
        slice_places(expert_idx, grp, before), grp,
        slice_groups(first, n, n_tok), expert_capacity(cfg, g_size), e0)
    if shard is not None:
        out = C.region_out(out, ax, shard.experts)
    return out.reshape(rows, s, d)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg, shard=None) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f_i * P_i) over the
    micro-batch; with a ``MoEShard``, the slices' statistics are summed
    over the batch axes before the product."""
    tokens = x.reshape(-1, x.shape[-1])
    sums = aux_sums(router_probs(tokens, p["router"]))
    n_tok = tokens.shape[0]
    if shard is not None:
        from repro_torch.distributed.collectives import stat_all_reduce
        sums = stat_all_reduce(sums, shard.axes, shard.batch)
        n_tok *= shard.batch_ranks
    return aux_from_sums(sums, n_tok)
