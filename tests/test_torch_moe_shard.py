"""The MoE block's expert parallelism (``models/moe.py``) against the
JAX package's whole-batch MoE, with no process group: the peers'
contributions are passed as tensors, as the sharded train step's
collectives would hand them over.

  * Routing places: a micro-batch cut into contiguous token slices,
    each routed from the counts of the slices before it
    (``slice_counts``) plus its own cumsum (``slice_places``), gives
    the reference's places, kept flags and expert ids on the whole
    batch exactly (``jax_route``): top-1 and top-2, one group and
    several groups that slice boundaries cut, a token count that is
    not a multiple of the group (the reference's padding), and a
    capacity factor that drops tokens on a later slice.
  * Expert ranges: the slices' outputs summed over expert ranges
    (``expert_range_output``) against the reference's ``moe_apply``,
    and the aux loss from the slices' summed statistics
    (``aux_sums``, ``aux_from_sums``) against its ``moe_aux_loss``,
    within the tolerances of ``test_torch_lm_pieces.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import FP32, carried_params, configs, jax_route, rel_err
from repro.models import moe as Jmoe
from repro_torch.models import moe as Tmoe

# (top_k, tokens, capacity factor, slice boundaries)
ROUTE_CASES = [
    (1, 192, 1.25, (0, 40, 100, 192)),              # one group
    (2, 192, 1.25, (0, 40, 100, 192)),
    (1, 2 * 4096 + 300, 1.25, (0, 3000, 4500, 8300, 2 * 4096 + 300)),
    (2, 2 * 4096 + 300, 1.25, (0, 4096, 6000, 2 * 4096 + 300)),
    (1, 4096 + 700, 0.5, (0, 1500, 4096 + 100, 4096 + 700)),  # drops
    (2, 192, 0.5, (0, 64, 128, 192)),
]


def _whole_batch_probs(n_tok: int, e: int, seed: int):
    """The reference's [G, g, E] router probabilities of ``n_tok``
    random tokens padded with zero rows to whole groups, as its
    ``moe_apply`` makes them, and the real tokens' [n_tok, E]."""
    rng = np.random.default_rng(seed)
    d = 16
    x = rng.standard_normal((n_tok, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    g = min(Jmoe.MAX_DISPATCH_GROUP, n_tok)
    pad = (-n_tok) % g
    xp = np.concatenate([x, np.zeros((pad, d), np.float32)])
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(xp.reshape(-1, g, d)),
                        jnp.asarray(router))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return probs, np.array(probs).reshape(-1, e)[:n_tok]


@pytest.mark.parametrize("top_k,n_tok,cf,bounds", ROUTE_CASES)
def test_split_places_match_the_whole_batch(top_k, n_tok, cf, bounds):
    e = 8
    jprobs, flat = _whole_batch_probs(n_tok, e, seed=n_tok + top_k)
    g_size = Tmoe.group_size(n_tok)
    capacity = max(1, int(cf * g_size * top_k / e))
    _, jidx, jpos, jkeep = jax_route(jprobs, top_k, capacity)
    want = {"idx": np.asarray(jidx).reshape(-1, top_k)[:n_tok],
            "pos": np.asarray(jpos).reshape(-1, top_k)[:n_tok],
            "keep": np.asarray(jkeep).reshape(-1, top_k)[:n_tok]}
    n_groups = -(-n_tok // g_size)
    before = torch.zeros((n_groups, e), dtype=torch.long)
    drops = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        _, idx = Tmoe.top_k(torch.from_numpy(flat[a:b]), top_k)
        grp = Tmoe.group_ids(a, b - a, n_tok)
        places = Tmoe.slice_places(idx, grp, before)
        before = before + Tmoe.slice_counts(idx, grp, n_groups, e)
        np.testing.assert_array_equal(idx.numpy(), want["idx"][a:b])
        np.testing.assert_array_equal(places.numpy(), want["pos"][a:b])
        np.testing.assert_array_equal((places < capacity).numpy(),
                                      want["keep"][a:b])
        drops.append(int((places >= capacity).sum()))
    if cf < 1:
        assert any(drops[1:]), drops


def _slice_routing(tp: dict, tokens: torch.Tensor, bounds, cfg):
    """Each slice's (gates, expert ids, places, group ids), each from
    the counts of the slices before it."""
    n_tok = tokens.shape[0]
    n_groups = -(-n_tok // Tmoe.group_size(n_tok))
    before = torch.zeros((n_groups, cfg.n_experts), dtype=torch.long)
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        gates, idx = Tmoe.top_k(Tmoe.router_probs(tokens[a:b], tp["router"]),
                                cfg.top_k)
        grp = Tmoe.group_ids(a, b - a, n_tok)
        out.append((gates, idx, Tmoe.slice_places(idx, grp, before), grp))
        before = before + Tmoe.slice_counts(idx, grp, n_groups, cfg.n_experts)
    return out


# (top_k, capacity factor, expert ranges, batch rows x seq, slice bounds)
PARTIAL_CASES = [
    (1, 1.25, 2, (2, 24), (0, 10, 31, 48)),
    (1, 0.5, 4, (2, 24), (0, 10, 31, 48)),
    (2, 1.25, 2, (2, 24), (0, 10, 31, 48)),
    (2, 0.5, 1, (2, 24), (0, 10, 31, 48)),
    # two dispatch groups of 4096 (the second padded): one row a slice,
    # as 8 batch ranks hold them; the slice [3600, 4200) spans both
    # groups and [4200, 4800) starts in the second
    (1, 1.25, 2, (8, 600), tuple(range(0, 4801, 600))),
    (2, 0.5, 4, (8, 600), tuple(range(0, 4801, 600))),
]


@pytest.mark.parametrize("top_k,cf,ranges,shape,bounds", PARTIAL_CASES)
def test_expert_range_partials_sum_to_moe_apply(top_k, cf, ranges, shape,
                                                bounds):
    """Scout at smoke width (4 experts), fp32: a batch cut into token
    slices, each routed from its predecessors' counts and run over
    ``ranges`` expert ranges with the slots of the groups it falls in
    (``slice_groups``), summed, against the reference's ``moe_apply``
    (rel 1e-5) and, for top-1 (one non-zero term a token), the port's
    whole-batch ``moe_apply`` bit for bit; the aux loss from the
    slices' summed statistics against its ``moe_aux_loss`` (rtol
    1e-5)."""
    jc, tc = configs("llama4_scout_17b_a16e", FP32, top_k=top_k,
                     capacity_factor=cf)
    jp, tp = carried_params(jc, tc, seed=5)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tmoe = tp["layers"][0]["moe"]
    x = np.random.default_rng(11).standard_normal(shape + (64,)).astype(
        np.float32)
    n_tok = shape[0] * shape[1]
    tokens = torch.from_numpy(x).reshape(n_tok, 64)
    capacity = Tmoe.expert_capacity(tc, Tmoe.group_size(n_tok))
    e_loc = tc.n_experts // ranges
    parts = []
    for (gates, idx, places, grp), a, b in zip(
            _slice_routing(tmoe, tokens, bounds, tc), bounds[:-1], bounds[1:]):
        total = 0
        for r in range(ranges):
            w = {k: tmoe[k][r * e_loc:(r + 1) * e_loc]
                 for k in ("w_gate", "w_up", "w_down")}
            total = total + Tmoe.expert_range_output(
                w, tokens[a:b], gates, idx, places, grp,
                Tmoe.slice_groups(a, b - a, n_tok), capacity, r * e_loc)
        parts.append(total)
    got = torch.cat(parts).reshape(x.shape)
    want = Jmoe.moe_apply(jmoe, jnp.asarray(x), jc)
    assert rel_err(got, want) < 1e-5
    if top_k == 1:
        torch.testing.assert_close(got, Tmoe.moe_apply(tmoe,
                                                       torch.from_numpy(x),
                                                       tc), rtol=0, atol=0)
    sums = sum(Tmoe.aux_sums(Tmoe.router_probs(tokens[a:b], tmoe["router"]))
               for a, b in zip(bounds[:-1], bounds[1:]))
    np.testing.assert_allclose(float(Tmoe.aux_from_sums(sums, n_tok)),
                               float(Jmoe.moe_aux_loss(jmoe, jnp.asarray(x),
                                                       jc)),
                               rtol=1e-5)
