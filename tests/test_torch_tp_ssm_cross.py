"""Tensor parallelism over ``model`` of the SSM (mamba2, hymba's branch)
and the cross-attention (the VLM, Whisper's decoder) in one process,
against the JAX package's unsplit sublayers.

As in ``test_torch_tp.py``: each rank's partial is computed in turn
with ``TPShard.simulated(rank, m)`` from the whole weights and joined
as the collectives would join it (outputs summed, or concatenated
along the decoder rows; the inputs' and weights' gradients summed),
then held against the reference's ``ssm_apply`` /
``cross_attention_apply`` and their ``jax.grad`` on the same numpy
inputs, fp32, within ``_torch_lm.bound(SPLIT_TOL)``:

  * the SSM at m = 2 and 4 (mamba2 and hymba smoke: 8 heads each): the
    rank's heads, its non-contiguous columns of ``in_proj`` (z, x, dt;
    B and C whole), its channels of ``conv_w`` and rows of
    ``out_proj``;
  * the SSM with a state: a prefill of 16 tokens, then 4 decode steps,
    each rank carrying its heads of the state and channels of the conv
    tail, the outputs summed and the state's chunks joined;
  * the cross-attention: the VLM at m = 2 (heads) and 4 (decoder rows,
    its 2 KV heads do not divide 4), Whisper at m = 2 and 4 (heads),
    ``enc``'s gradient the sum of the ranks' partials.

A split of one rank is the unsharded model bit for bit for all ten
archs: the forward (the SSM and cross-attention take the split too) and
a prefill with decode steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import ARCHS, FP32, bound, carried_params, configs, enc_states
from _torch_lm import inputs, rel_err, tt
from repro.models import attention as JA
from repro.models import ssm as JS
from repro_torch.distributed.collectives import TPShard
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.layers import materialize
from test_torch_tp import SPLIT_TOL, _check, _join, _reference, _weights

B = 2
SSM_ARCHS = ("mamba2_780m", "hymba_1_5b")


def _ssm_weights(tc, seed: int) -> dict:
    """``_weights`` of the SSM's leaves, ``a_log`` and ``dt_bias`` as
    drawn (std 0.1: decays near 1, step sizes near softplus(0))."""
    return _weights(TB.ssm_defs(tc), seed)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_partials_join_to_the_reference(arch, m):
    jc, tc = configs(arch, FP32)
    assert TS.ssm_split(tc, m) == "heads"
    p = _ssm_weights(tc, seed=1)
    rng = np.random.default_rng(2)
    s = 2 * tc.ssm_chunk + 5          # three chunks, the last one short
    x = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)

    def port(pt, xt, tp):
        return TS.ssm_apply(pt, xt, tc, tp=tp)[0]

    def ref(jp, jx):
        return JS.ssm_apply(jp, jx, jc)[0]
    _check(_join(port, p, x, ct, m, rows=False), _reference(ref, p, x, ct))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_state_chunks_join_to_the_reference(arch, m):
    """A prefill of 16 tokens, then 4 one-token steps: each rank's
    outputs summed and its state chunks (heads of ``state``, channels
    of ``conv``) concatenated equal the reference's incremental
    ``ssm_apply`` within the bound after every call."""
    jc, tc = configs(arch, FP32)
    p = _ssm_weights(tc, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 20, tc.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    jstate = JS.init_ssm_state(B, jc, jnp.float32)
    whole = TS.init_ssm_state(B, tc, torch.float32, "cpu")
    h, di = tc.ssm_heads // m, tc.d_inner // m
    states = [TS.SSMState(whole.state[:, r * h:(r + 1) * h].clone(),
                          whole.conv[..., r * di:(r + 1) * di].clone())
              for r in range(m)]
    tol = bound(SPLIT_TOL)
    for a, e in [(0, 16)] + [(i, i + 1) for i in range(16, 20)]:
        want, jstate = JS.ssm_apply(jp, jnp.asarray(x[:, a:e]), jc, jstate)
        outs = []
        for r in range(m):
            out, states[r] = TS.ssm_apply(pt, tt(x[:, a:e]), tc, states[r],
                                          tp=TPShard.simulated(r, m))
            outs.append(out)
        assert rel_err(sum(outs), want) < tol, (a, e)
        assert rel_err(torch.cat([st.state for st in states], 1),
                       jstate.state) < tol, (a, e)
        assert rel_err(torch.cat([st.conv for st in states], 2),
                       jstate.conv) < tol, (a, e)


def _join_cross(p: dict, x, enc, ct, tc, m: int, rows: bool):
    """(output, [x gradient, enc gradient], weight gradients) of ``m``
    ranks' partials of ``cross_attention_apply`` joined."""
    outs, gx, ge, gp = [], 0, 0, {k: 0 for k in p}
    n = x.shape[1] // m
    for r in range(m):
        pt = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        et = torch.from_numpy(enc).requires_grad_(True)
        out = TA.cross_attention_apply(pt, xt, et, cfg=tc,
                                       tp=TPShard.simulated(r, m))
        c = torch.from_numpy(ct[:, r * n:(r + 1) * n] if rows else ct)
        grads = torch.autograd.grad(out, [xt, et] + [pt[k] for k in p], c)
        outs.append(out.detach())
        gx, ge = gx + grads[0], ge + grads[1]
        for k, g in zip(p, grads[2:]):
            gp[k] = gp[k] + g
    return (torch.cat(outs, 1) if rows else sum(outs)), gx, ge, gp


# (arch, m, the split attention_split must choose)
CROSS_CASES = [("llama_3_2_vision_11b", 2, "heads"),
               ("llama_3_2_vision_11b", 4, "seq"),
               ("whisper_small", 2, "heads"), ("whisper_small", 4, "heads")]


@pytest.mark.parametrize("arch,m,split", CROSS_CASES,
                         ids=[f"{a}-m{m}-{s}" for a, m, s in CROSS_CASES])
def test_cross_attention_partials_join_to_the_reference(arch, m, split):
    jc, tc = configs(arch, FP32)
    s = 16
    assert TA.attention_split(tc, m, s) == split
    defs = TB.cross_defs(tc)
    p = _weights({k: defs[k] for k in ("wq", "wk", "wv", "wo")}, seed=5)
    t = tc.encoder_seq if tc.is_encdec else tc.vision_tokens
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, t, tc.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)
    out, gx, ge, gp = _join_cross(p, x, enc, ct, tc, m, rows=split == "seq")

    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(jp, jx, je):
        return jnp.sum(JA.cross_attention_apply(jp, jx, je, cfg=jc)
                       * jnp.asarray(ct))
    wgp, wgx, wge = jax.grad(f, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), jnp.asarray(enc))
    wout = JA.cross_attention_apply(jp, jnp.asarray(x), jnp.asarray(enc),
                                    cfg=jc)
    tol = bound(SPLIT_TOL)
    assert rel_err(out, wout) < tol
    assert rel_err(gx, wgx) < tol
    assert rel_err(ge, wge) < tol
    for k in gp:
        assert rel_err(gp[k], wgp[k]) < tol, k


@pytest.mark.parametrize("arch", ARCHS)
def test_split_of_one_rank_serves_as_the_unsharded_model(arch):
    """``TPShard.simulated(0, 1)`` through ``_forward_impl`` (every
    block, the SSM and cross-attention with it) and through
    ``_forward_cached`` (a prefill of 8 tokens and 2 decode steps):
    logits and the state bit for bit the unsharded ones."""
    jc, tc = configs(arch, FP32)
    jp, tparams = carried_params(jc, tc, seed=0)
    toks, enc = inputs(jc, b=B, s=10, seed=1)
    one = TPShard.simulated(0, 1)
    want = TM.forward(tparams, tt(toks[:, :8]), tc, enc_inputs=tt(enc))
    got, _ = TM._forward_impl(tparams, tt(toks[:, :8]), tc, tt(enc), tp=one)
    assert torch.equal(got, want)
    _, tenc = enc_states(jp, tparams, jc, tc, enc)
    runs = []
    for tp in (None, one):
        st = TM.init_decode_state(tc, B, 10, enc=tenc, device="cpu")
        outs = []
        for a, e in ((0, 8), (8, 9), (9, 10)):
            if tp is None:
                fn = TM.prefill if a == 0 else TM.decode_step
                logits, st = fn(tparams, tt(toks[:, a:e]), tc, st)
            else:
                logits, st = TM._forward_cached(tparams, tt(toks[:, a:e]),
                                                tc, st, tp=tp)
            outs.append(logits)
        runs.append((outs, st))
    (want_l, want_st), (got_l, got_st) = runs
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    from repro_torch.utils.trees import tree_leaves
    assert got_st.length == want_st.length
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got_st), tree_leaves(want_st))
               if isinstance(a, torch.Tensor))


class _Entered(TPShard):
    """A simulated rank that records the tensors entering its split
    through ``region_in`` (whose backward sums a rank's partial
    gradient over the split on a mesh)."""

    def __new__(cls, rank: int, size: int):
        self = super().__new__(cls, None, (), rank, size)
        self.entered = []
        return self

    def region_in(self, x):
        self.entered.append(x)
        return x


@pytest.mark.parametrize("arch,m,split", CROSS_CASES,
                         ids=[f"{a}-m{m}-{s}" for a, m, s in CROSS_CASES])
def test_cross_attention_inputs_enter_through_region_in(arch, m, split):
    """Under either split both ``x`` and ``enc`` enter through
    ``region_in``: a rank's gradient into Whisper's encoder output is a
    partial, which only a sum over the split makes whole (a
    single-process join sums it by hand and cannot see it missing)."""
    _, tc = configs(arch, FP32)
    defs = TB.cross_defs(tc)
    p = {k: torch.from_numpy(v) for k, v in _weights(
        {k: defs[k] for k in ("wq", "wk", "wv", "wo")}, seed=7).items()}
    t = tc.encoder_seq if tc.is_encdec else tc.vision_tokens
    x, enc = torch.randn(B, 16, tc.d_model), torch.randn(B, t, tc.d_model)
    tp = _Entered(0, m)
    TA.cross_attention_apply(p, x, enc, cfg=tc, tp=tp)
    assert any(e is x for e in tp.entered)
    assert any(e is enc for e in tp.entered)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_hybrid_mixer_input_enters_both_branches(arch):
    """The hybrid mixer's (or the SSM's) normed input enters each split
    branch through ``region_in``: the attention's and the SSM's partial
    gradients are each summed over the split."""
    _, tc = configs(arch, FP32)
    h = torch.randn(B, 16, tc.d_model)
    tp = _Entered(0, 2)
    if tc.family == "hybrid":
        p = materialize(TB.block_defs(tc, "hybrid"),
                           torch.Generator().manual_seed(0), torch.float32,
                           "cpu")
        TB.hybrid_mixer(p, h, tc, positions=torch.arange(16), tp=tp)
        assert sum(e is h for e in tp.entered) == 2
    else:
        p = materialize(TB.ssm_defs(tc), torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
        TS.ssm_apply(p, h, tc, tp=tp)
        assert sum(e is h for e in tp.entered) == 1
