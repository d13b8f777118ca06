"""The port's negative-sampling gradients and SGD steps against the JAX
package's on the same inputs.

The reference's Pallas kernel runs in interpret mode here, as its own
tests run it; the port's wrapper takes its plain version (CPU tensors).
Inputs are made with numpy from a seed.

Gradients: rtol=1e-5 and atol=1e-5 * t^2 (``grad_tol``).  The
reference holds its kernel to its oracle at rtol=1e-5, atol=1e-6, but
those two run the same XLA ops in the same order.  Two programs that
sum a dot product in different orders differ by float32 rounding of
its partial sums (up to ~1e-5 for dim <= 128 unit-variance inputs); a
logit carries that times t, and a gradient (sigmoid' <= 1/4, times t,
times an input entry) times t^2.  At (100, 64, 3, 8) the port's plain
version and the reference differ by up to 4.1e-5 on 15 of 6400 entries,
the size of the reference's own error against a float64 evaluation
(4.4e-5).  Steps: the same injected negatives on both sides (the
reference draws them from a threefry key inside the step; the test
draws them with that key and hands them to the port), with duplicate
doc, word and negative ids present; atol=1e-6 (float sums in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pv_dbow as jpv
from repro.kernels.negsamp import ops as jops
from repro.kernels.negsamp import ref as jref
from repro_torch.core import pv_dbow as tpv
from repro_torch.kernels.negsamp import ops as tops
from repro_torch.kernels.negsamp import ref as tref
from repro_torch.testing import NEGSAMP_SHAPES



def grad_tol(t: float) -> dict:
    return dict(rtol=1e-5, atol=1e-5 * t * t)


def _inputs(b, dim, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, dim)).astype(np.float32),
            rng.normal(size=(b, dim)).astype(np.float32),
            rng.normal(size=(b, k, dim)).astype(np.float32))


@pytest.mark.parametrize("b,dim,k,temp", NEGSAMP_SHAPES)
def test_negsamp_grads_match_reference(b, dim, k, temp):
    d, w, wn = _inputs(b, dim, k, b)
    got = tops.negsamp_grads(torch.from_numpy(d), torch.from_numpy(w),
                             torch.from_numpy(wn), temperature=temp)
    want_ref = jref.negsamp_grads_ref(jnp.asarray(d), jnp.asarray(w),
                                      jnp.asarray(wn), temperature=temp)
    want_kernel = jops.negsamp_grads(jnp.asarray(d), jnp.asarray(w),
                                     jnp.asarray(wn), temperature=temp)
    assert len(got) == 4
    for g, r, kk in zip(got, want_ref, want_kernel):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **grad_tol(temp))
        np.testing.assert_allclose(g.numpy(), np.asarray(kk),
                                   **grad_tol(temp))


@pytest.mark.parametrize("temp", [1.0, 8.0])
def test_negsamp_grads_match_autograd(temp):
    """The fused manual gradients == torch autograd of the summed loss."""
    d, w, wn = (torch.from_numpy(a).requires_grad_(True)
                for a in _inputs(32, 24, 4, 9))
    pos = (w * d).sum(-1) * temp
    neg = torch.einsum("bkd,bd->bk", wn, d) * temp
    loss = (tref.softplus(-pos) + tref.softplus(neg).sum(-1)).sum()
    gd_ad, gw_ad, gwn_ad = torch.autograd.grad(loss, (d, w, wn))
    row_loss, gd, gw, gwn = tops.negsamp_grads(d.detach(), w.detach(),
                                               wn.detach(), temperature=temp)
    torch.testing.assert_close(row_loss.sum(), loss.detach(), rtol=1e-5,
                               atol=1e-5)
    for g, want in ((gd, gd_ad), (gw, gw_ad), (gwn, gwn_ad)):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5)


def test_softplus_is_stable_and_matches_jax():
    x = np.array([-200.0, -30.0, -1.0, 0.0, 1e-3, 2.5, 30.0, 200.0],
                 np.float32)
    got = tref.softplus(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=0)


def _step_inputs(seed=4):
    """A tiny model and a batch with duplicate ids everywhere: 12 docs,
    20 words, 64 pairs, 5 negatives drawn by the reference's sampler."""
    rng = np.random.default_rng(seed)
    v, n_docs, dim, b, k = 20, 12, 16, 64, 5
    wv = rng.normal(size=(v, dim)).astype(np.float32)
    dv = rng.normal(size=(n_docs, dim)).astype(np.float32)
    wv /= np.linalg.norm(wv, axis=1, keepdims=True)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    doc_ids = rng.integers(0, n_docs, b).astype(np.int32)
    word_ids = rng.integers(0, v, b).astype(np.int32)
    p = np.bincount(word_ids, minlength=v).astype(np.float64) + 1.0
    cdf = np.cumsum(p ** 0.75 / (p ** 0.75).sum()).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    negs = np.array(jpv.sample_negatives(key, jnp.asarray(cdf), (b, k)))
    for ids in (doc_ids, word_ids, negs.reshape(-1)):
        assert len(np.unique(ids)) < len(ids)      # duplicates present
    return wv, dv, doc_ids, word_ids, cdf, key, negs, k


@pytest.mark.parametrize("unit_norm", [True, False])
@pytest.mark.parametrize("port_step", ["negsamp_step", "sgns_step"])
def test_steps_match_reference_steps(port_step, unit_norm):
    wv, dv, doc_ids, word_ids, cdf, key, negs, k = _step_inputs()
    kw = dict(negatives=k, lr=0.05, unit_norm=unit_norm, temperature=8.0)
    jmodel = jpv.PVDBOWModel(jnp.asarray(wv), jnp.asarray(dv))
    jargs = (jmodel, key, jnp.asarray(doc_ids), jnp.asarray(word_ids),
             jnp.asarray(cdf))
    want = {"negsamp_step": jops.negsamp_step(*jargs, **kw),
            "sgns_step": jpv.sgns_step(*jargs, **kw)}
    tmodel = tpv.model_from_arrays(wv, dv, "cpu")
    step = tops.negsamp_step if port_step == "negsamp_step" else tpv.sgns_step
    got, loss = step(tmodel, torch.from_numpy(negs).long(),
                     torch.from_numpy(doc_ids).long(),
                     torch.from_numpy(word_ids).long(), lr=0.05,
                     unit_norm=unit_norm, temperature=8.0)
    np.testing.assert_array_equal(tmodel.word_vecs.numpy(), wv)  # not mutated
    for (jm, jloss) in want.values():
        np.testing.assert_allclose(got.word_vecs.numpy(),
                                   np.asarray(jm.word_vecs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.doc_vecs.numpy(),
                                   np.asarray(jm.doc_vecs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
