"""The port's PV-DBOW training and inference against the JAX package's.

JAX's threefry draws (the initial tables, each step's negatives,
inference's initial vector and noise words) cannot be made in torch, so
the test draws them in JAX exactly as the reference's functions do and
hands them to the port through its parity-only injection points; the
pair batches come from numpy's RNG in both packages.  Tolerances:
``corpus_pairs`` and the negative sampler bit for bit; 10 training steps
within atol=1e-5 (float sums in another order, 10 steps of lr 0.01);
inference within atol=1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import pv_dbow as jpv
from repro.core.lsh import LSHConfig as JLSHConfig
from repro_torch.core import index as tindex
from repro_torch.core import pv_dbow as tpv
from repro_torch.core.lsh import LSHConfig as TLSHConfig
from repro_torch.data.store import ShardedCorpus as TCorpus
from repro_torch.kernels.negsamp import kernel as tkernel


@pytest.fixture(scope="module")
def port_corpus(small_corpus):
    return TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)


@pytest.fixture(scope="module")
def port_trained(port_corpus):
    """The conftest ``pv_model`` recipe, trained by the port on the CPU,
    with its loss curve."""
    cfg = tpv.PVDBOWConfig(dim=24, steps=400, batch_pairs=2048, lr=0.01,
                           temperature=8.0, seed=5)
    losses = []
    model = tpv.train_pv_dbow(port_corpus, cfg, device="cpu",
                              callback=lambda s, loss: losses.append(loss))
    return model, cfg, losses


def _port_cfg(jcfg) -> tpv.PVDBOWConfig:
    """The port's config from the reference's: the same fields, less
    ``use_kernel`` (the port's route follows the device)."""
    return tpv.PVDBOWConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                               if k != "use_kernel"})


@pytest.mark.parametrize("subsample_t", [0.0, 1e-3])
def test_corpus_pairs_bit_identical(small_corpus, port_corpus, subsample_t):
    want = jpv.corpus_pairs(small_corpus, 0.75, subsample_t, seed=4)
    got = tpv.corpus_pairs(port_corpus, 0.75, subsample_t, seed=4)
    for name in ("doc_of_token", "word_of_token", "noise_cdf"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_sample_negatives_is_left_searchsorted():
    """torch.rand from the generator, then the left-side inverse CDF and a
    clip to V - 1; the CDF holds some of the drawn uniforms exactly, so
    a right-side search would differ."""
    shape = (64, 5)
    u = torch.rand(shape, generator=torch.Generator().manual_seed(3)).numpy()
    cdf = np.sort(np.concatenate([u.reshape(-1)[:12],
                                  np.linspace(0.05, 0.9, 9, dtype=np.float32)]))
    cdf = cdf.astype(np.float32)       # last entry < 1: the clip matters
    got = tpv.sample_negatives(torch.Generator().manual_seed(3),
                               torch.from_numpy(cdf), shape)
    want = np.clip(np.searchsorted(cdf, u, "left"), 0, cdf.shape[0] - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.searchsorted(cdf, u, "right") != np.searchsorted(cdf, u, "left")).any()
    assert (got.numpy() == cdf.shape[0] - 1).any()


def _reference_draws(corpus, jcfg):
    """The reference trainer's threefry draws: ``init_model`` on
    PRNGKey(seed), then ``key, sub = split(key)`` and
    ``sample_negatives(sub, ...)`` per step."""
    pairs = jpv.corpus_pairs(corpus, jcfg.noise_power, jcfg.subsample_t,
                             jcfg.seed)
    key = jax.random.PRNGKey(jcfg.seed)
    init = jpv.init_model(key, corpus.vocab_size, corpus.n_docs, jcfg.dim)
    cdf = jnp.asarray(pairs.noise_cdf)
    negs = []
    for _ in range(jcfg.steps):
        key, sub = jax.random.split(key)
        negs.append(np.array(jpv.sample_negatives(
            sub, cdf, (jcfg.batch_pairs, jcfg.negatives))))
    return init, negs


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_matches_reference_on_injected_draws(small_corpus, port_corpus,
                                                   use_kernel):
    """``use_kernel`` varies the reference side only (its autograd step
    or its Pallas step): the port trains on the CPU through the plain
    version of row 11 either way, and must match both."""
    jcfg = jpv.PVDBOWConfig(dim=16, steps=10, batch_pairs=512, lr=0.01,
                            temperature=8.0, seed=2, use_kernel=use_kernel)
    jl, tl = [], []
    want = jpv.train_pv_dbow(small_corpus, jcfg,
                             callback=lambda s, loss: jl.append((s, loss)))
    init, negs = _reference_draws(small_corpus, jcfg)
    launches = tkernel.negsamp_grads_kernel.launches
    got = tpv.train_pv_dbow(
        port_corpus, _port_cfg(jcfg), device="cpu",
        init=tpv.model_from_arrays(np.asarray(init.word_vecs),
                                   np.asarray(init.doc_vecs), "cpu"),
        negatives=lambda step: negs[step],
        callback=lambda s, loss: tl.append((s, loss)))
    assert tkernel.negsamp_grads_kernel.launches == launches  # CPU: plain
    np.testing.assert_allclose(got.word_vecs.numpy(),
                               np.asarray(want.word_vecs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.doc_vecs.numpy(),
                               np.asarray(want.doc_vecs), rtol=0, atol=1e-5)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 9]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=1e-5)


def test_port_configs_have_no_use_kernel():
    """The device picks the route, so neither training config carries a
    ``use_kernel`` flag; a reference config converts by dropping it."""
    from repro_torch.core import allocation as talloc
    for cls in (tpv.PVDBOWConfig, talloc.KMeansConfig):
        assert "use_kernel" not in {f.name for f in dataclasses.fields(cls)}
    jcfg = jpv.PVDBOWConfig(dim=16, steps=3, use_kernel=True)
    got = _port_cfg(jcfg)
    assert got == tpv.PVDBOWConfig(dim=16, steps=3)


def test_train_callback_every_step(port_corpus):
    """``log_every=1`` reads the loss at every step; the default reads it
    every 100 steps and after the last, the same values at those steps."""
    cfg = tpv.PVDBOWConfig(dim=8, steps=12, batch_pairs=256, lr=0.01,
                           temperature=8.0, seed=1)
    every, default = [], []
    tpv.train_pv_dbow(port_corpus, cfg, device="cpu", log_every=1,
                      callback=lambda s, loss: every.append((s, loss)))
    tpv.train_pv_dbow(port_corpus, cfg, device="cpu",
                      callback=lambda s, loss: default.append((s, loss)))
    assert [s for s, _ in every] == list(range(12))
    assert default == [every[0], every[-1]]


def test_training_reduces_loss(port_trained):
    _, _, losses = port_trained
    assert len(losses) == 5
    assert losses[-1] < losses[0] * 0.85


def test_vectors_unit_norm(port_trained):
    model, _, _ = port_trained
    for t in (model.word_vecs, model.doc_vecs):
        assert torch.isfinite(t).all()
        np.testing.assert_allclose(torch.linalg.norm(t, dim=1).numpy(), 1.0,
                                   atol=1e-4)


def test_infer_doc_vector_matches_reference(small_corpus, pv_model):
    model, jcfg = pv_model
    tokens = small_corpus.shards[0].document(0).tokens
    steps = 30
    want = np.asarray(jpv.infer_doc_vector(model, tokens, jcfg, steps=steps))
    key = jax.random.PRNGKey(jcfg.seed + 1)
    init = np.array(jax.random.normal(key, (1, jcfg.dim), jnp.float32)
                    / np.sqrt(jcfg.dim))
    subs = jpv._split_chain(key, steps)
    v = model.word_vecs.shape[0]
    kneg = [np.array(jax.random.randint(subs[i], (tokens.shape[0],
                                                   jcfg.negatives), 0, v))
            for i in range(steps)]
    tmodel = tpv.model_from_arrays(np.asarray(model.word_vecs),
                                   np.asarray(model.doc_vecs), "cpu")
    got = tpv.infer_doc_vector(tmodel, tokens, _port_cfg(jcfg), steps=steps,
                               init_vec=torch.from_numpy(init),
                               negatives=lambda i: kneg[i])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_infer_unseen_document_lands_near_its_doc(small_corpus, port_trained):
    """An existing doc's tokens infer a vector in the top quartile of
    that doc's trained neighbours (paper Sec. V), on the port's own
    draws."""
    model, cfg, _ = port_trained
    doc = small_corpus.shards[0].document(0)
    vec = tpv.infer_doc_vector(model, doc.tokens, cfg, steps=100)
    sims = model.doc_vecs @ vec
    assert int((sims > sims[doc.doc_id]).sum()) < model.doc_vecs.shape[0] * 0.25


def test_infer_batch_equals_per_doc_bitwise(small_corpus, port_trained):
    model, cfg, _ = port_trained
    docs = [small_corpus.shards[s].document(i).tokens
            for s, i in ((0, 0), (1, 2), (3, 1), (0, 0))]
    batch = tpv.infer_doc_vectors(model, docs, cfg, steps=10)
    assert batch.dtype == np.float32 and batch.shape == (4, cfg.dim)
    for i, toks in enumerate(docs):
        one = tpv.infer_doc_vector(model, toks, cfg, steps=10).numpy()
        np.testing.assert_array_equal(batch[i], one)
    np.testing.assert_array_equal(batch[0], batch[3])
    assert tpv.infer_doc_vectors(model, [], cfg).shape == (0, cfg.dim)


def test_model_from_arrays_round_trip(small_corpus, port_corpus, pv_model):
    model, jcfg = pv_model
    wv, dv = np.asarray(model.word_vecs), np.asarray(model.doc_vecs)
    tmodel = tpv.model_from_arrays(wv, dv, "cpu")
    assert tmodel.word_vecs.dtype == torch.float32 and tmodel.dim == jcfg.dim
    np.testing.assert_array_equal(tmodel.word_vecs.numpy(), wv)
    np.testing.assert_array_equal(tmodel.doc_vecs.numpy(), dv)
    again = tpv.model_from_arrays(tmodel.word_vecs, tmodel.doc_vecs, "cpu")
    np.testing.assert_array_equal(again.doc_vecs.numpy(), dv)
    # build_index takes the tensors as it takes the reference's arrays
    ref = jindex.build_index(small_corpus, model, JLSHConfig(bits=64),
                             temperature=jcfg.temperature)
    got = tindex.build_index(port_corpus, tmodel, TLSHConfig(bits=64),
                             temperature=jcfg.temperature, planes=ref.planes,
                             device="cpu")
    for name in ("word_vecs", "doc_vecs", "shard_vecs"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    want_q = np.asarray(jpv.query_vector(model, [3, 5, 9]))
    np.testing.assert_allclose(tpv.query_vector(tmodel, [3, 5, 9]).numpy(),
                               want_q, rtol=0, atol=1e-6)
