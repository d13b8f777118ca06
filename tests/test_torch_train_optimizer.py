"""The port's optimizer against the JAX package's on the same numpy
inputs: q8 codes and scales equal (a code may differ by one only where
the float32 input sits on a half-way point, counted), the round trip
within the reference's bound (absmax / 127 a block), the schedules
within 1 ulp, and ``adamw_update`` over several steps for the fp32,
bf16 and q8 states within 1e-6 of each leaf's largest entry (params
and moments: the global norms differ in their last bit, summed in
another order, and an entry near zero, a first moment that nearly
cancels, shows that relative to itself; a bf16 moment within one bf16
ulp, on under 1 % of entries), on a tree
with a stacked ``[L, d]`` leaf (decayed) and a ``[d]`` leaf (not).  The
weight-decay rule and the q8 blocking read the stacked training state
leaf for leaf as the reference's does, and ``train_state_from_arrays``
carries the reference's state into the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, npf, rel_err
from repro.models import model as JM
from repro.optimizer import adamw as JA
from repro.optimizer import quantized as JQ
from repro.optimizer import schedules as JS
from repro_torch.models import model as TM
from repro_torch.optimizer import adamw as TA
from repro_torch.optimizer import quantized as TQ
from repro_torch.optimizer import schedules as TS
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


def _halfway(x: np.ndarray) -> np.ndarray:
    """Entries of a flat float32 array whose ``x / scale`` lies within
    1e-6 of a half-integer (where one float32 rounding can pick either
    code)."""
    n = x.size
    pad = (-n) % TQ.BLOCK
    blocks = np.pad(x, (0, pad)).reshape(-1, TQ.BLOCK).astype(np.float64)
    scales = np.maximum(np.abs(blocks).max(axis=1), 1e-12) / 127.0
    r = blocks / scales[:, None]
    return (np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-6).reshape(-1)[:n]


@pytest.mark.parametrize("n,scale", [(1, 1.0), (255, 3.0), (256, 0.01),
                                     (1000, 100.0), (4097, 1e-3)])
def test_q8_codes_and_scales_match_reference(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * scale).astype(np.float32)
    j = JQ.q8_quantize(jnp.asarray(x))
    t = TQ.q8_quantize(torch.from_numpy(x))
    assert t.size == j.size == n
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    codes_t = t.codes.numpy().astype(np.int32).reshape(-1)[:n]
    codes_j = np.asarray(j.codes).astype(np.int32).reshape(-1)[:n]
    off = codes_t != codes_j
    assert np.abs(codes_t - codes_j).max(initial=0) <= 1
    assert not np.any(off & ~_halfway(x)), "a code differs off a half-way point"
    back = TQ.q8_dequantize(t, (n,)).numpy()
    np.testing.assert_array_equal(
        back[~off], np.asarray(JQ.q8_dequantize(j, (n,)))[~off])


@pytest.mark.parametrize("seed", range(4))
def test_q8_roundtrip_error_bounded(seed):
    """The reference's bound: per-block error <= absmax / 127."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    x = rng.normal(size=n).astype(np.float32) * rng.uniform(0.01, 100)
    back = TQ.q8_dequantize(TQ.q8_quantize(torch.from_numpy(x)), x.shape)
    err = np.abs(back.numpy() - x)
    assert err.max() <= np.abs(x).max() / 127.0 + 1e-6


def test_q8_state_is_two_leaves_and_size_is_static():
    s = TQ.q8_quantize(torch.arange(300, dtype=torch.float32))
    leaves = tree_leaves({"m": s})
    assert len(leaves) == 2 and leaves[0] is s.codes and leaves[1] is s.scales
    assert len(jax.tree_util.tree_leaves(JQ.q8_quantize(jnp.arange(300.0)))) == 2
    doubled = tree_map(lambda x: x * 2, s)
    assert isinstance(doubled, TQ.Q8State) and doubled.size == 300
    again = tree_unflatten(s, [s.codes, s.scales])
    assert again.size == 300 and again.codes is s.codes


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("warmup,total", [(1, 10), (200, 10000), (5, 5),
                                          (0, 50), (100, 3000)])
def test_schedules_match_reference(warmup, total):
    """Every step of a run and 30 past its end.  The linear warmup is
    bit for bit the reference's.  The cosine schedule is
    ``0.1 + 0.45 (1 + cos)``: its two float32 cosines (XLA's and the
    port's, a float64 cosine rounded once) differ by one ulp on about 1 %
    of arguments, and one ulp of a cosine near -1 (2^-24), times 0.45,
    is 3.6 ulps of the schedule near its floor 0.1.  So a step is held
    within one such cosine ulp times 0.45 plus one ulp of its own, and
    below 1 % of the steps may differ at all."""
    steps = np.arange(0, total + 30, dtype=np.int32)
    want = np.asarray(JS.cosine_warmup_schedule(
        jnp.asarray(steps), warmup_steps=warmup, total_steps=total))
    got = TS.cosine_warmup_schedule(torch.from_numpy(steps),
                                    warmup_steps=warmup, total_steps=total)
    assert got.dtype == torch.float32
    got = got.numpy()
    tol = 0.45 * 2.0 ** -23 + np.spacing(want)
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    assert (_ulps(got, want) > 0).mean() < 0.01
    lw = JS.linear_warmup_schedule(jnp.asarray(steps), warmup_steps=warmup)
    lt = TS.linear_warmup_schedule(torch.from_numpy(steps),
                                   warmup_steps=warmup)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lw))


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"layers": {"norm": rng.normal(size=(3, 40)).astype(np.float32),
                       "w": rng.normal(size=(3, 40, 24)).astype(np.float32)},
            "final_norm": rng.normal(size=(40,)).astype(np.float32),
            "emb": rng.normal(size=(50, 40)).astype(np.float32) * 0.1}


def _carried(tree):
    """A JAX params or moment tree as the port's, on the CPU (bf16 leaves
    through float32, a Q8State as the port's)."""
    if isinstance(tree, dict):
        return {k: _carried(v) for k, v in tree.items()}
    if isinstance(tree, JQ.Q8State):
        return TQ.Q8State(_carried(tree.codes), _carried(tree.scales),
                          tree.size)
    return TM._as_tensor(np.asarray(tree), torch.device("cpu"))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8"])
def test_adamw_update_matches_reference(state_dtype):
    """Four steps, each from the same numpy params, grads and state (the
    reference's after the step before), lr scale 0.5, 1.5, ..."""
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                  state_dtype=state_dtype)
    jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    js = JA.adamw_init(jp, jcfg)
    n_q8_codes = n_halfway = n_bf16 = n_bf16_off = 0
    for step in range(4):
        grads = _tree(10 + step)
        scale = np.float32(0.5 + step)
        tp = _carried(jp)
        ts = TA.OptState(torch.tensor(int(js.step), dtype=torch.int32),
                         _carried(js.m), _carried(js.v))
        tp, ts, tm = TA.adamw_update(
            tp, tree_map(torch.from_numpy, grads), ts, tcfg,
            torch.tensor(scale))
        jp, js, jm = JA.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), js, jcfg,
            jnp.float32(scale))
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert rel_err(got, want) < 1e-6
        if state_dtype == "q8":
            for tq, jq in zip(tree_leaves(ts.m, is_leaf=_is_q8) +
                              tree_leaves(ts.v, is_leaf=_is_q8),
                              jax.tree_util.tree_leaves(
                                  (js.m, js.v),
                                  is_leaf=lambda x: isinstance(x, JQ.Q8State))):
                assert rel_err(tq.scales, jq.scales) < 1e-6
                d = np.abs(tq.codes.numpy().astype(int)
                           - np.asarray(jq.codes).astype(int))
                assert d.max() <= 1
                n_q8_codes += d.size
                n_halfway += int((d > 0).sum())
            continue
        for got, want in zip(tree_leaves((ts.m, ts.v)),
                             jax.tree_util.tree_leaves((js.m, js.v))):
            if state_dtype == "float32":
                assert rel_err(got, want) < 1e-6
                continue
            # a float32 moment an ulp off may round to the other bf16
            # neighbour: one bf16 ulp (2^-7 relative), rare
            g, w = npf(got), npf(want)
            assert np.all(np.abs(g - w) <= np.abs(w) * 2.0 ** -7)
            n_bf16 += g.size
            n_bf16_off += int((g != w).sum())
    assert n_bf16_off <= n_bf16 * 1e-2, (n_bf16_off, n_bf16)
    # a q8 code off by one where two float32 roundings of a half-way
    # point differ: rare
    assert n_halfway <= n_q8_codes * 1e-3, (n_halfway, n_q8_codes)


def _is_q8(x):
    return isinstance(x, TQ.Q8State)


def test_weight_decay_and_q8_blocks_follow_the_stacked_tree():
    """On smollm's stacked training state, a zero gradient and lr 1:
    a leaf moves (decay) exactly where the reference's does, a stacked
    norm scale [L, d] included and final_norm [d] not; the q8 moments
    have the reference's block count a leaf."""
    jc, tc = configs("smollm_360m", n_layers=3)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp, _ = TM.train_state_from_arrays(tc, jax.tree_util.tree_map(np.asarray, jp),
                                       device="cpu")
    cfg_kw = dict(lr=1.0, weight_decay=0.5, grad_clip=0.0, state_dtype="q8")
    jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
    zj = jax.tree_util.tree_map(jnp.zeros_like, jp)
    zt = tree_map(torch.zeros_like, tp)
    jinit = jax.jit(JA.adamw_init, static_argnums=1)
    jn, js, _ = jax.jit(JA.adamw_update, static_argnums=3)(
        jp, zj, jinit(jp, jcfg), jcfg)
    tn, ts, _ = TA.adamw_update(tp, zt, TA.adamw_init(tp, tcfg), tcfg)
    moved_t = [bool((a != b).any()) for a, b in zip(tree_leaves(tn), tree_leaves(tp))]
    moved_j = [bool(np.any(np.asarray(a) != np.asarray(b))) for a, b in
               zip(jax.tree_util.tree_leaves(jn), jax.tree_util.tree_leaves(jp))]
    assert moved_t == moved_j
    assert not bool((tn["final_norm"] != tp["final_norm"]).any())
    assert tp["layers"]["norm1"].ndim == 2
    assert bool((tn["layers"]["norm1"] != tp["layers"]["norm1"]).any())
    blocks_t = [q.codes.shape for q in tree_leaves(ts.m, is_leaf=_is_q8)]
    blocks_j = [q.codes.shape for q in jax.tree_util.tree_leaves(
        js.m, is_leaf=lambda x: isinstance(x, JQ.Q8State))]
    assert blocks_t == blocks_j
    assert len(tree_leaves(ts)) == len(jax.tree_util.tree_leaves(js))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8"])
def test_train_state_from_arrays_carries_reference_state(state_dtype):
    jc, tc = configs("mamba2_780m", n_layers=3)
    jp = JM.init_params(jc, jax.random.PRNGKey(1))
    jcfg = JA.AdamWConfig(state_dtype=state_dtype)
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.01), jp)
    _, js, _ = jax.jit(JA.adamw_update, static_argnums=3)(
        jp, grads, jax.jit(JA.adamw_init, static_argnums=1)(jp, jcfg), jcfg)
    host = jax.tree_util.tree_map(np.asarray, (jp, js))
    tp, ts = TM.train_state_from_arrays(tc, *host, device="cpu")
    assert isinstance(ts, TA.OptState) and int(ts.step) == 1
    assert ts.step.dtype == torch.int32
    for got, want in zip(tree_leaves((tp, ts)), jax.tree_util.tree_leaves((jp, js))):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
            got = got.float()
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # the per-layer views of the same tree are the serving layout
    views = TM._unstack_params(tp)
    assert len(views["layers"]) == tc.n_layers
    assert views["layers"][0]["norm"].shape == (tc.d_model,)
    stacked, none = TM.train_state_from_arrays(tc, host[0], device="cpu")
    assert none is None and stacked["layers"]["norm"].shape == (
        tc.n_layers, tc.d_model)


def test_adamw_first_update_has_zero_lr_at_default_warmup():
    from repro_torch.launch.steps import make_train_step
    _, tc = configs("smollm_360m")
    tc = dataclasses.replace(tc, n_layers=1)
    params = TM.init_stacked_params(tc, torch.Generator().manual_seed(0), "cpu")
    ocfg = TA.AdamWConfig(weight_decay=0.0)
    step = make_train_step(tc, ocfg, total_steps=10)
    toks = torch.randint(0, tc.vocab_size, (1, 8), generator=torch.Generator().manual_seed(1))
    new, state, metrics = step(params, TA.adamw_init(params, ocfg),
                               {"tokens": toks, "labels": toks})
    assert float(metrics["lr"]) == 0.0 and int(state.step) == 1
    for a, b in zip(tree_leaves(new), tree_leaves(params)):
        assert torch.equal(a, b)
