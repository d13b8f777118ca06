"""The port's serving path, prefill then one cached decode step, against
the JAX package's, every architecture at its smoke config under the
fp32 policy, on carried parameters and the same numpy prompt: the
prefill's and the decode step's logits within 1e-4 of max |reference
logits; the ``DecodeState`` after each call, its ring positions and
length exactly, its KV and SSM tensors within 1e-5 of their largest
entry.  Where the reference moves further than that under a one-ulp
change of its parameters and encoder inputs, the bound is twice that
spread, never above 1e-3 (Whisper's, ``_torch_lm.bound``).  Then the port against
itself, as the reference's own test holds the reference: a
teacher-forced forward equals prefill + decode within 5e-3, MoE at
capacity_factor 64 (capacity is per dispatch group, so a tight factor
drops other tokens in a 1-token decode than in the full forward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (ARCHS, FP32, bound, carried_params, configs,
                       enc_states, inputs, jx, kv_leaves, npf, one_ulp,
                       rel_err, tt)
from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.utils.trees import tree_map

B, S, MAX_LEN = 2, 12, 32


def _state_err(got, want) -> float:
    """The largest error over the state's tensors, each scaled by its
    largest entry."""
    g, w = kv_leaves(got), kv_leaves(want)
    assert [a.shape for a in g] == [a.shape for a in w]
    return max(float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))
               for a, b in zip(g, w))


def _ref_serve(jc, toks):
    """The reference's prefill + decode step as one jitted function of
    its parameters and encoder inputs, as its ``launch/serve.py`` jits
    them: (prefill logits, state, decode logits, state)."""
    def run(params, enc):
        if jc.is_encdec:
            enc = JM.encode(params, enc, jc)
        state = JM.init_decode_state(jc, B, MAX_LEN, enc=enc)
        lp, state = JM.prefill(params, toks[:, :S - 1], jc, state)
        ld, state2 = JM.decode_step(params, toks[:, S - 1:], jc, state)
        return lp, state, ld, state2
    return jax.jit(run)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_state_match_reference(arch):
    jc, tc = configs(arch, FP32)
    jp, tp = carried_params(jc, tc, seed=1)
    toks, enc = inputs(jc, B, S, seed=2)
    _, tenc = enc_states(jp, tp, jc, tc, enc)
    ref = _ref_serve(jc, jnp.asarray(toks))
    jlp, jstate, jld, jstate2 = ref(jp, jx(enc))
    moved = ref(one_ulp(jp), None if enc is None else one_ulp(enc))
    logit_bound = bound(1e-4, rel_err(moved[0], jlp), rel_err(moved[2], jld))
    state_bound = bound(1e-5, _state_err(moved[1], jstate),
                        _state_err(moved[3], jstate2))

    tstate = TM.init_decode_state(tc, B, MAX_LEN, enc=tenc, device="cpu")
    tlp, tstate = TM.prefill(tp, tt(toks[:, :S - 1]), tc, tstate)
    # decode_step writes the caches in place: keep the prefill's state
    snap = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tstate)
    tld, tstate2 = TM.decode_step(tp, tt(toks[:, S - 1:]), tc, tstate)

    assert rel_err(tlp, jlp) < logit_bound
    assert rel_err(tld, jld) < logit_bound
    for got, want, n in ((snap, jstate, S - 1), (tstate2, jstate2, S)):
        assert got.length == int(want.length) == n
        if want.pos is None:
            assert got.pos is None
        else:
            np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        assert _state_err(got, want) < state_bound


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    jc, tc = configs(arch, FP32)
    if tc.family == "moe":
        jc, tc = configs(arch, FP32, capacity_factor=64.0)
    jp, tp = carried_params(jc, tc, seed=1)
    toks, enc = inputs(jc, B, S, seed=3)
    _, tenc = enc_states(jp, tp, jc, tc, enc)
    full = TM.forward(tp, tt(toks), tc, enc_inputs=tt(enc))
    state = TM.init_decode_state(tc, B, MAX_LEN, enc=tenc, device="cpu")
    _, state = TM.prefill(tp, tt(toks[:, :S - 1]), tc, state)
    dec, state = TM.decode_step(tp, tt(toks[:, S - 1:]), tc, state)
    assert state.length == S
    scale = np.max(np.abs(npf(full[:, -1]))) + 1e-9
    assert np.max(np.abs(npf(dec) - npf(full[:, -1]))) / scale < 5e-3
