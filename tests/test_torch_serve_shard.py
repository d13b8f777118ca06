"""Context-parallel serving in one process: the cache's slots split over
``m`` ranks run in lockstep (``repro_torch.testing.lockstep``: every
rank runs the call, and the i-th collective of a pass answers from what
the ranks fed it in the pass before), against the JAX package.

  * Decode (``attention._decode_attention_slots``): each rank scores
    its slots and the softmax is joined by log-sum-exp; every rank's
    output is the reference's ``attention_apply`` decode step within
    ``_torch_lm.bound(SPLIT_TOL)``: GQA (smollm smoke, 4 heads on 2 KV
    heads); a ring that has wrapped (hymba smoke, window 32, a 32-slot
    ring after 45 tokens); lengths at which some ranks hold no valid
    slot (finite, no NaN).
  * Prefill (the query rows split, K/V of every row on every rank):
    the output and the ranks' slot chunks within the bound, ``pos``
    exactly.
  * ``cache_update`` of each rank's chunk (its first slot ``lo``): the
    slot ranges written by the ranks in turn equal the reference's
    ``cache_update`` state exactly, from the same new K/V (runs that
    wrap, and more tokens than slots).
  * The whole ``_forward_cached`` in lockstep (smollm: vocabulary,
    MLP and slots split; hymba with a state width whose ``in_proj``
    does not divide the split: the mixer whole, its state chunks
    gathered and written back) against the unsharded prefill and
    decode steps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import FP32, bound, configs, rel_err
from repro.models import attention as JA
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.testing import lockstep
from test_torch_tp import SPLIT_TOL, _weights

B = 2


def _chunks(t: torch.Tensor, m: int) -> list:
    n = t.shape[1] // m
    return [t[:, r * n:(r + 1) * n].clone() for r in range(m)]


def _ranks_step(pt, x, tc, cache: TA.KVCache, m: int, window: int):
    """One call of ``attention_apply`` on ``m`` lockstep ranks, each
    holding its chunk of ``cache``'s slots: (each rank's output, the
    ranks' new chunks of k and v joined, the new pos of rank 0)."""
    ks, vs = _chunks(cache.k, m), _chunks(cache.v, m)
    s = x.shape[1]
    positions = torch.arange(cache.length, cache.length + s)

    def rank(tp):
        chunk = TA.KVCache(ks[tp.rank].clone(), vs[tp.rank].clone(),
                           cache.pos.clone(), cache.length)
        out, new = TA.attention_apply(pt, x, cfg=tc, positions=positions,
                                      cache=chunk, window=window, tp=tp)
        return out, new
    runs = lockstep(rank, m)
    news = [new for _, new in runs]
    assert all(n.length == cache.length + s for n in news)
    assert all(torch.equal(n.pos, news[0].pos) for n in news)
    joined = TA.KVCache(torch.cat([n.k for n in news], 1),
                        torch.cat([n.v for n in news], 1), news[0].pos,
                        news[0].length)
    return [out for out, _ in runs], joined


# (arch, slots, ranks, prompt, decode steps): smollm's prompts leave
# ranks with no valid slot (10 tokens: ranks 1-3; 40: rank 3), hymba's
# 45-token prompt wraps its 32-slot window ring
DECODE_CASES = [("smollm_360m", 64, 4, 10, 3), ("smollm_360m", 64, 4, 40, 2),
                ("smollm_360m", 64, 2, 5, 2), ("hymba_1_5b", 32, 4, 45, 4)]


@pytest.mark.parametrize("arch,slots,m,prompt,steps", DECODE_CASES,
                         ids=[f"{a}-{s}slots-m{m}-len{p}"
                              for a, s, m, p, _ in DECODE_CASES])
def test_context_parallel_attention_matches_the_reference(arch, slots, m,
                                                          prompt, steps):
    jc, tc = configs(arch, FP32)
    window = tc.sliding_window if tc.family == "hybrid" else 0
    p = _weights(TB.attn_defs(tc), seed=1)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, prompt + steps, tc.d_model)) \
        .astype(np.float32)
    jcache = JA.init_kv_cache(B, slots, tc.n_kv_heads, tc.head_dim,
                              jnp.float32)
    cache = TA.init_kv_cache(B, slots, tc.n_kv_heads, tc.head_dim,
                             torch.float32, "cpu")
    tol = bound(SPLIT_TOL)
    for a, e in [(0, prompt)] + [(i, i + 1) for i in
                                 range(prompt, prompt + steps)]:
        want, jcache = JA.attention_apply(
            jp, jnp.asarray(x[:, a:e]), cfg=jc,
            positions=jnp.arange(a, e), cache=jcache, window=window)
        outs, cache = _ranks_step(pt, torch.from_numpy(x[:, a:e]), tc,
                                  cache, m, window)
        for out in outs:
            assert torch.isfinite(out).all()
            assert rel_err(out, want) < tol, (a, e)
        assert np.array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
        assert rel_err(cache.k, jcache.k) < tol
        assert rel_err(cache.v, jcache.v) < tol


def test_ranks_without_a_valid_slot_add_exact_zeros():
    """At length 1 only rank 0 holds a valid slot: the others' local
    max is NEG_INF, their exponentials against the split's max are
    exact zeros, and the joined output equals the one rank's
    attention over its slot (the value itself, one slot)."""
    jc, tc = configs("smollm_360m", FP32)
    p = _weights(TB.attn_defs(tc), seed=3)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 1, tc.d_model)).astype(np.float32))
    cache = TA.init_kv_cache(B, 16, tc.n_kv_heads, tc.head_dim,
                             torch.float32, "cpu")
    outs, joined = _ranks_step(pt, x, tc, cache, 4, 0)
    whole, _ = TA.attention_apply(
        pt, x, cfg=tc, positions=torch.arange(1),
        cache=TA.init_kv_cache(B, 16, tc.n_kv_heads, tc.head_dim,
                               torch.float32, "cpu"))
    for out in outs:
        assert torch.isfinite(out).all()
        assert torch.allclose(out, whole, rtol=0, atol=1e-6)
    assert torch.equal(joined.k[:, 1:], torch.zeros_like(joined.k[:, 1:]))


# (length before, new tokens, slots, ranks)
WRITE_CASES = [(0, 16, 64, 4), (60, 8, 64, 4), (5, 70, 64, 4), (33, 1, 32, 4),
               (0, 40, 32, 4), (31, 1, 32, 2), (7, 32, 32, 8)]


@pytest.mark.parametrize("length,s_new,slots,m", WRITE_CASES,
                         ids=[f"len{a}-new{b}-slots{c}-m{d}"
                              for a, b, c, d in WRITE_CASES])
def test_slot_writes_equal_the_reference_cache_update(length, s_new, slots,
                                                      m):
    rng = np.random.default_rng(length + s_new)
    k0, v0 = (rng.standard_normal((B, slots, 2, 8)).astype(np.float32)
              for _ in range(2))
    pos0 = np.full(slots, -1, np.int32)      # the ring after ``length``
    for p in range(max(0, length - slots), length):
        pos0[p % slots] = p
    kn, vn = (rng.standard_normal((B, s_new, 2, 8)).astype(np.float32)
              for _ in range(2))
    want = JA.cache_update(JA.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                                      jnp.asarray(pos0), jnp.int32(length)),
                           jnp.asarray(kn), jnp.asarray(vn))
    n = slots // m
    ks, vs = [], []
    for r in range(m):
        chunk = TA.KVCache(torch.from_numpy(k0[:, r * n:(r + 1) * n].copy()),
                           torch.from_numpy(v0[:, r * n:(r + 1) * n].copy()),
                           torch.from_numpy(pos0), length)
        new = TA.cache_update(chunk, torch.from_numpy(kn),
                              torch.from_numpy(vn), r * n)
        assert new.length == length + s_new
        assert np.array_equal(new.pos.numpy(), np.asarray(want.pos))
        ks.append(new.k)
        vs.append(new.v)
    assert np.array_equal(torch.cat(ks, 1).numpy(), np.asarray(want.k))
    assert np.array_equal(torch.cat(vs, 1).numpy(), np.asarray(want.v))


def _state_chunks(state: TM.DecodeState, m: int, rank: int):
    """Rank ``rank``'s part of an unsharded state: its slots of the
    caches, its heads of the SSM state and channels of the conv tail
    where they divide ``m`` (as ``decode_state_shardings`` places
    them)."""
    def part(t, dim):
        n = t.shape[dim] // m
        return t.narrow(dim, rank * n, n).clone() if t.shape[dim] % m == 0 \
            else t.clone()
    kv = None if state.kv is None else tuple(part(t, 2) for t in state.kv)
    ssm = None if state.ssm is None else (part(state.ssm[0], 2),
                                          part(state.ssm[1], 3))
    pos = None if state.pos is None else state.pos.clone()
    return TM.DecodeState(kv, ssm, pos, state.length, state.enc)


# (arch, ranks, config changes): hymba's state width 9 leaves in_proj's
# 282 columns whole over 4 ranks, so its mixer computes whole while the
# rank holds chunks of the state's 8 heads and 128 channels
MODEL_CASES = [("smollm_360m", 4, {}), ("mamba2_780m", 4, {}),
               ("hymba_1_5b", 4, {"ssm_state": 9})]


@pytest.mark.parametrize("arch,m,changes", MODEL_CASES,
                         ids=[a + ("-state9" if c else "")
                              for a, _, c in MODEL_CASES])
def test_forward_cached_in_lockstep_matches_the_unsharded_steps(arch, m,
                                                                changes):
    from repro_torch.models.ssm import ssm_split
    _, tc = configs(arch, FP32, **changes)
    if changes:
        assert ssm_split(tc, m) is None and tc.ssm_heads % m == 0
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tc.vocab_size, (B, 19)))
    whole = TM.init_decode_state(tc, B, 20, device="cpu")
    states = [_state_chunks(whole, m, r) for r in range(m)]
    tol = bound(SPLIT_TOL)
    for a, e in ((0, 16), (16, 17), (17, 18), (18, 19)):
        fn = TM.prefill if a == 0 else TM.decode_step
        want, whole = fn(params, toks[:, a:e], tc, whole)

        def rank(tp):
            st = states[tp.rank]
            st = TM.DecodeState(
                None if st.kv is None else tuple(t.clone() for t in st.kv),
                None if st.ssm is None else tuple(t.clone() for t in st.ssm),
                st.pos, st.length, st.enc)
            return TM._forward_cached(params, toks[:, a:e], tc, st, tp=tp)
        runs = lockstep(rank, m)
        for logits, _ in runs:
            assert logits.shape == want.shape
            assert rel_err(logits, want) < tol, (a, e)
        states = [st for _, st in runs]
        ref = [_state_chunks(whole, m, r) for r in range(m)]
        for got, exp in zip(states, ref):
            assert got.length == exp.length
            assert (got.pos is None and exp.pos is None) or \
                torch.equal(got.pos, exp.pos)
            for g, w in zip([*(got.kv or ()), *(got.ssm or ())],
                            [*(exp.kv or ()), *(exp.ssm or ())]):
                assert g.shape == w.shape
                assert rel_err(g, w) < tol, (a, e)
