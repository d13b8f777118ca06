"""The pieces of the LM path that break quietly, against the JAX
package's: the ring-buffer KV cache over 20 decode steps at a sliding
window of 8 (step by step), ``cache_pos_update`` / ``cache_update`` when
S_new >= S_max (exactly), MoE routing with forced ties in the router and
a tight capacity (expert ids and dropped tokens exactly), the SSD scan
with S not a multiple of the chunk and across several chunks, RoPE at
arbitrary positions, the chunked (flash-style) attention, the
``kv_valid_len`` mask and the causal conv's tail.  Float tolerances are
relative to the largest reference entry: 1e-4 for logits, 1e-5 for
single layers' outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (FP32, carried_params, configs, jax_route, kv_leaves,
                       npf, rel_err, tt)
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as Jmoe
from repro.models import ssm as Jssm
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as Tmoe
from repro_torch.models import ssm as Tssm


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("prompt", [0, 5, 11])
def test_ring_buffer_over_20_decode_steps(prompt):
    """Hymba at window 8: a prompt of 0, 5 (slots written in place) or
    11 tokens (S_new >= S_max: the tail rolled into place), then 20
    decode steps that wrap the ring twice; logits, positions and the
    caches against the reference after every step, and the port's last
    20 logits against its own windowed forward."""
    jc, tc = configs("hymba_1_5b", FP32, sliding_window=8)
    jp, tp = carried_params(jc, tc, seed=3)
    toks = np.random.default_rng(4).integers(
        0, jc.vocab_size, (1, prompt + 20)).astype(np.int32)
    jstate = JM.init_decode_state(jc, 1, 64)
    tstate = TM.init_decode_state(tc, 1, 64, device="cpu")
    assert tstate.pos.shape == (8,)
    jdec = jax.jit(JM.decode_step, static_argnums=2)
    if prompt:
        _, jstate = jax.jit(JM.prefill, static_argnums=2)(
            jp, jnp.asarray(toks[:, :prompt]), jc, jstate)
        _, tstate = TM.prefill(tp, tt(toks[:, :prompt]), tc, tstate)
    steps = []
    for t in range(prompt, prompt + 20):
        jl, jstate = jdec(jp, jnp.asarray(toks[:, t:t + 1]), jc, jstate)
        tl, tstate = TM.decode_step(tp, tt(toks[:, t:t + 1]), tc, tstate)
        steps.append(tl)
        assert tstate.length == int(jstate.length) == t + 1
        np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
        assert rel_err(tl, jl) < 1e-4
        for g, w in zip(kv_leaves(tstate), kv_leaves(jstate)):
            assert np.max(np.abs(g - w)) <= 1e-5 * (np.max(np.abs(w)) + 1e-9)
    full = TM.forward(tp, tt(toks), tc)[:, prompt:]
    assert rel_err(torch.stack(steps, dim=1), full) < 5e-3


@pytest.mark.parametrize("s_max,length,s_new", [
    (8, 0, 8), (8, 0, 11), (8, 3, 8), (8, 5, 13), (8, 21, 30), (6, 4, 1),
    (8, 6, 5), (8, 7, 1), (5, 0, 3)])
def test_cache_pos_update_and_cache_update_exactly(s_max, length, s_new):
    rng = np.random.default_rng(s_max * 100 + length * 10 + s_new)
    pos = rng.integers(-1, 50, s_max).astype(np.int32)
    want = JA.cache_pos_update(jnp.asarray(pos), jnp.asarray(length, jnp.int32),
                               s_new)
    got = TA.cache_pos_update(torch.from_numpy(pos), length, s_new)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(torch.from_numpy(pos), torch.from_numpy(pos.copy()))

    k0 = rng.standard_normal((2, s_max, 3, 4)).astype(np.float32)
    v0 = rng.standard_normal((2, s_max, 3, 4)).astype(np.float32)
    kn = rng.standard_normal((2, s_new, 3, 4)).astype(np.float32)
    vn = rng.standard_normal((2, s_new, 3, 4)).astype(np.float32)
    jc = JA.cache_update(JA.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                                    jnp.asarray(pos), jnp.asarray(length)),
                         jnp.asarray(kn), jnp.asarray(vn))
    tc = TA.cache_update(TA.KVCache(torch.from_numpy(k0.copy()),
                                    torch.from_numpy(v0.copy()),
                                    torch.from_numpy(pos), length),
                         torch.from_numpy(kn), torch.from_numpy(vn))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert tc.length == int(jc.length) == length + s_new


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_route_ties_and_capacity_exactly(top_k):
    """Four experts with equal router columns in pairs (0 = 2, 1 = 3):
    every token's probabilities tie, and the lower index must win; a
    capacity factor of 0.5 drops tokens.  Expert ids, places, kept flags and
    gates against the reference's routing exactly; moe_apply's output
    against the reference's, dropped tokens' rows exactly zero."""
    jc, tc = configs("llama4_scout_17b_a16e", FP32, top_k=top_k,
                     capacity_factor=0.5)
    jp, tp = carried_params(jc, tc, seed=5)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    router = np.asarray(jmoe["router"]).copy()
    router[:, 2] = router[:, 0]
    router[:, 3] = router[:, 1]
    jmoe = dict(jmoe, router=jnp.asarray(router))
    tmoe = dict(tp["layers"][0]["moe"], router=torch.from_numpy(router))
    x = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(np.float32)

    logits = np.einsum("btd,de->bte", x, router).reshape(1, 24, 4)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    capacity = max(1, int(0.5 * 24 * top_k / 4))
    jg, jidx, jpos, jkeep = jax_route(jnp.asarray(probs), top_k, capacity)
    tgates, tidx = Tmoe.top_k(torch.from_numpy(probs[0]), top_k)
    tpos = Tmoe.slice_places(tidx, Tmoe.group_ids(0, 24, 24),
                             torch.zeros((1, 4), dtype=torch.long))
    tkeep = tpos < capacity
    tg, tidx, tpos, tkeep = (t[None] for t in (tgates * tkeep, tidx, tpos,
                                               tkeep))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert set(np.unique(tidx[..., 0].numpy())) <= {0, 1}
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert 0 < tkeep.sum() < tkeep.numel()

    want = Jmoe.moe_apply(jmoe, jnp.asarray(x), jc)
    got = Tmoe.moe_apply(tmoe, torch.from_numpy(x), tc)
    assert rel_err(got, want) < 1e-5
    dropped = ~tkeep.numpy().any(-1).reshape(2, 12)
    assert dropped.any()
    assert not got.numpy()[dropped].any() and not np.asarray(want)[dropped].any()
    np.testing.assert_allclose(float(Tmoe.moe_aux_loss(tmoe, torch.from_numpy(x), tc)),
                               float(Jmoe.moe_aux_loss(jmoe, jnp.asarray(x), jc)),
                               rtol=1e-5)


@pytest.mark.parametrize("s,chunk,with_state", [
    (37, 16, False), (37, 16, True), (64, 16, True), (5, 32, True),
    (1, 16, True)])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    rng = np.random.default_rng(s * 7 + chunk)
    b, h, hd, n = 2, 3, 4, 5
    xin = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 2
    a_log = rng.standard_normal(h).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    st = (rng.standard_normal((b, h, hd, n)).astype(np.float32)
          if with_state else None)
    jy, jst = Jssm.ssd_chunked(
        *map(jnp.asarray, (xin, dt, a_log, bb, cc)), chunk,
        init_state=None if st is None else jnp.asarray(st))
    ty, tst = Tssm.ssd_chunked(
        *map(torch.from_numpy, (xin, dt, a_log, bb, cc)), chunk,
        init_state=None if st is None else torch.from_numpy(st))
    assert ty.shape == (b, s, h, hd) and tst.dtype == torch.float32
    assert rel_err(ty, jy) < 1e-5
    assert rel_err(tst, jst) < 1e-5
    assert np.isfinite(ty.numpy()).all()


def test_conv1d_tail_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for tl in (None, tail):
        jy, jt = Jssm._conv1d(jnp.asarray(x), jnp.asarray(w),
                              None if tl is None else jnp.asarray(tl))
        ty, tt_ = Tssm._conv1d(_t(x), _t(w), None if tl is None else _t(tl))
        assert rel_err(ty, jy) < 1e-6
        np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt))


@pytest.mark.parametrize("theta,hd", [(10000.0, 16), (10000.0, 64),
                                      (1000000.0, 128)])
def test_rope_at_arbitrary_positions(theta, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    positions = rng.integers(0, 100000, (2, 9)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = TL.apply_rope(_t(x), torch.from_numpy(positions), theta)
    assert rel_err(got, want) < 1e-5
    np.testing.assert_allclose(TL.rope_frequencies(hd, theta).numpy(),
                               np.asarray(JL.rope_frequencies(hd, theta)),
                               rtol=2e-7)     # float32 pow, within an ulp
    # split-half layout: the first half of each head pairs with the second
    y = TL.apply_rope(_t(x), torch.ones((2, 9), dtype=torch.long), theta)
    f = TL.rope_frequencies(hd, theta)
    x1, x2 = _t(x)[..., :hd // 2], _t(x)[..., hd // 2:]
    torch.testing.assert_close(y[..., :hd // 2],
                               x1 * torch.cos(f) - x2 * torch.sin(f))


@pytest.mark.parametrize("causal,window,offset,chunk", [
    (True, 0, 0, 8), (True, 5, 0, 8), (False, 0, 0, 16), (True, 0, 6, 8)])
def test_chunked_attention_matches_reference(causal, window, offset, chunk):
    rng = np.random.default_rng(chunk + window + offset)
    q = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=offset)
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), chunk=chunk, **kw)
    got = TA.chunked_attention(*map(_t, (q, k, v)), chunk=chunk, **kw)
    assert rel_err(got, want) < 1e-5
    dense = TA.dense_attention(*map(_t, (q, k, v)), **kw)
    assert rel_err(got, dense) < 1e-5


def test_dense_attention_kv_valid_len_matches_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
    valid = np.array([1, 6, 10], np.int32)
    want = JA.dense_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                              kv_valid_len=jnp.asarray(valid))
    got = TA.dense_attention(*map(_t, (q, k, v)), causal=False,
                             kv_valid_len=torch.from_numpy(valid))
    assert rel_err(got, want) < 1e-5
    # the first row sees only slot 0: its output is v[0] of each head
    torch.testing.assert_close(got[0, 0].reshape(2, 2, 8)[:, 0], _t(v)[0, 0])
    assert npf(got).shape == (3, 1, 4, 8)
