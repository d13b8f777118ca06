"""Recommendation queries (paper Sec. IV-C, VII-D) and the review corpus
in the port against the JAX package.

  * ``generate_review_corpus``: identical data from one seed (every
    user document, rating, user/item id and topic vector).
  * ``ApproxIndex.vector_shard_similarities(_batch)`` and
    ``vector_doc_similarities``: within rtol=1e-4 of the reference (the
    similarity kernels' tolerance), asym and sym mode; ``nbytes`` equal.
  * ``recommend_query``: identical predictions and top-k at rate 1.0;
    below 1.0, with the reference's shard similarities injected into
    both, identical samples, predictions and top-k (numpy's RNG drives
    both samplers).  ``mse`` and ``precision_at_k`` equal.

The index vectors are a seeded stand-in (no training): the queries only
read vectors and signatures."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import index as jindex
from repro.core.lsh import LSHConfig
from repro.core.queries import recommend as jrec
from repro.data import corpus as jcorpus
from repro.data.store import ShardedCorpus as JCorpus
from repro_torch.core import index as tindex
from repro_torch.core.queries import recommend as trec
from repro_torch.data import corpus as tcorpus
from repro_torch.data.store import ShardedCorpus as TCorpus

RTOL = 1e-4


def _same_review_data(a, b):
    assert len(a.user_docs) == len(b.user_docs)
    for x, y in zip(a.user_docs, b.user_docs):
        assert x.doc_id == y.doc_id
        assert x.tokens.dtype == y.tokens.dtype
        np.testing.assert_array_equal(x.tokens, y.tokens)
    for name in ("ratings", "user_of", "item_of", "user_topics",
                 "item_topics"):
        u, v = getattr(a, name), getattr(b, name)
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    assert a.vocab_size == b.vocab_size
    np.testing.assert_array_equal(a.ratings_matrix(), b.ratings_matrix())


@pytest.mark.parametrize("kw", [
    dict(n_users=120, n_items=60, vocab_size=1024, n_topics=6, seed=3),
    dict(n_users=64, n_items=200, seed=9, reviews_per_user_mean=5),
])
def test_review_corpus_is_identical(kw):
    _same_review_data(
        tcorpus.generate_review_corpus(tcorpus.ReviewCorpusConfig(**kw)),
        jcorpus.generate_review_corpus(jcorpus.ReviewCorpusConfig(**kw)))


@pytest.fixture(scope="module", params=["asym", "sym"])
def rec_world(request, tmp_path_factory):
    cfg = dict(n_users=120, n_items=60, vocab_size=1024, n_topics=6, seed=3)
    data = jcorpus.generate_review_corpus(jcorpus.ReviewCorpusConfig(**cfg))
    pdata = tcorpus.generate_review_corpus(tcorpus.ReviewCorpusConfig(**cfg))
    jc = JCorpus.from_documents(data.user_docs, 1024, shard_tokens=4096)
    tc = TCorpus.from_documents(pdata.user_docs, 1024, shard_tokens=4096)
    rng = np.random.default_rng(5)
    topics = np.asarray(data.user_topics, np.float64)
    emb = rng.normal(size=(topics.shape[1], 16))
    model = SimpleNamespace(
        word_vecs=rng.normal(size=(1024, 16)).astype(np.float32),
        doc_vecs=(topics @ emb + 0.1 * rng.normal(size=(len(topics), 16))
                  ).astype(np.float32))
    ji = jindex.build_index(jc, model, LSHConfig(bits=128), temperature=8.0,
                            lsh_mode=request.param)
    path = tmp_path_factory.mktemp("rec") / "index.npz"
    ji.save(str(path))
    ti = tindex.ApproxIndex.load(str(path), device="cpu")
    assert ti.lsh_mode == request.param
    return SimpleNamespace(data=data, pdata=pdata, jc=jc, tc=tc, ji=ji,
                           ti=ti, mode=request.param)


def test_vector_similarities_match_the_reference(rec_world):
    w = rec_world
    users = np.asarray([0, 3, 17, 50, 119])
    vecs = w.ji.doc_vecs[users]
    got = w.ti.vector_shard_similarities_batch(vecs)
    assert got.shape == (5, w.tc.n_shards) and got.dtype == np.float64
    np.testing.assert_allclose(
        got, w.ji.vector_shard_similarities_batch(vecs), rtol=RTOL)
    for u in users:
        v = w.ji.doc_vecs[u]
        np.testing.assert_allclose(w.ti.vector_shard_similarities(v),
                                   w.ji.vector_shard_similarities(v),
                                   rtol=RTOL)
        np.testing.assert_allclose(w.ti.vector_doc_similarities(v),
                                   w.ji.vector_doc_similarities(v),
                                   rtol=RTOL)
    assert w.ti.nbytes() == w.ji.nbytes()
    stripped = dataclasses.replace(w.ti, doc_vecs=None, doc_sig=None)
    with pytest.raises(ValueError, match="document vectors"):
        stripped.vector_doc_similarities(vecs[0])


def _rec_record(r):
    return (sorted(r.predictions.items()), r.top_k.tolist(),
            r.sample.shard_ids.tolist(), r.shards_read, r.n_shards)


@pytest.mark.parametrize("user", [3, 40, 101])
def test_recommend_at_census_is_identical(rec_world, user):
    w = rec_world
    mask = w.data.user_of == user
    bought, held = w.data.item_of[mask], w.data.item_of[mask][:2]
    exclude = np.setdiff1d(bought, held)
    want = jrec.recommend_query(w.jc, w.ji, w.data, user, 1.0, k=10,
                                exclude_items=exclude)
    got = trec.recommend_query(w.tc, w.ti, w.pdata, user, 1.0, k=10,
                               exclude_items=exclude)
    assert _rec_record(got) == _rec_record(want)
    assert got.predictions and all(1.0 <= p <= 5.0
                                   for p in got.predictions.values())
    truth = w.data.ratings[mask][:2]
    assert trec.mse(got.predictions, held, truth) == \
        jrec.mse(want.predictions, held, truth)
    assert trec.precision_at_k(got.top_k, held, 10) == \
        jrec.precision_at_k(want.top_k, held, 10)
    cand = [int(i) for i in w.data.item_of[:30]]
    assert _rec_record(trec.recommend_query(
        w.tc, w.ti, w.pdata, user, 1.0, candidate_items=cand)) == \
        _rec_record(jrec.recommend_query(w.jc, w.ji, w.data, user, 1.0,
                                         candidate_items=cand))


@pytest.mark.parametrize("method,rate", [("emapprox", 0.25),
                                         ("emapprox", 0.5), ("srcs", 0.3)])
def test_recommend_below_census_on_injected_similarities(rec_world, method,
                                                         rate):
    w = rec_world
    sims = {u: w.ji.vector_shard_similarities(w.ji.doc_vecs[u])
            for u in range(w.ji.doc_vecs.shape[0])}

    def inject(index):
        index = dataclasses.replace(index)
        lookup = {v.tobytes(): s for v, s in
                  ((w.ji.doc_vecs[u], s) for u, s in sims.items())}
        index.vector_shard_similarities = lambda vec: lookup[
            np.asarray(vec, np.float32).tobytes()]
        return index

    ji, ti = inject(w.ji), inject(w.ti)
    for user in (3, 40, 101):
        want = jrec.recommend_query(w.jc, ji, w.data, user, rate,
                                    method=method,
                                    rng=np.random.default_rng(user))
        got = trec.recommend_query(w.tc, ti, w.pdata, user, rate,
                                   method=method,
                                   rng=np.random.default_rng(user))
        assert _rec_record(got) == _rec_record(want)
        assert got.data_fraction == want.data_fraction
    with pytest.raises(ValueError, match="unknown method"):
        trec.recommend_query(w.tc, ti, w.pdata, 3, 0.5, method="nope")


def test_recommend_needs_a_vector(rec_world):
    w = rec_world
    with pytest.raises(ValueError, match="target_vector"):
        trec.recommend_query(w.tc, None, w.pdata, 3, 1.0)
    vec = w.ji.doc_vecs[7]
    got = trec.recommend_query(w.tc, w.ti, w.pdata, 7, 1.0,
                               target_vector=vec)
    want = jrec.recommend_query(w.jc, w.ji, w.data, 7, 1.0,
                                target_vector=vec)
    assert _rec_record(got) == _rec_record(want)
    assert np.isnan(trec.mse({}, np.zeros(0), np.zeros(0)))
    assert trec.precision_at_k(np.zeros(0, np.int64), np.asarray([1])) == 0.0
