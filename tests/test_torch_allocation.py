"""The port's k-means assignment, spherical k-means and corpus
allocation against the JAX package's, and the whole offline build
(pre-index -> allocate -> index -> ``QueryBatch``) on the same model.

The reference's Pallas assignment kernel runs in interpret mode here;
the port's wrapper takes its plain version (CPU tensors).  Assignments
are integers and must match exactly (inputs with no near-ties:
random unit rows, clustered data with a margin); best scores and
centroids agree to float rounding (rtol=1e-5 / atol=1e-5).  The k-means
initial centroid ids are the reference's threefry draw
(``jax.random.choice``), handed to the port through ``init_ids``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocation as jalloc
from repro.core import index as jindex
from repro.core.lsh import LSHConfig as JLSHConfig
from repro.core.queries import batch as jbatch
from repro.core.queries.retrieval import parse_boolean as j_parse
from repro.kernels.kmeans import ops as jops
from repro.kernels.kmeans import ref as jref
from repro_torch.core import allocation as talloc
from repro_torch.core import index as tindex
from repro_torch.core import pv_dbow as tpv
from repro_torch.core.lsh import LSHConfig as TLSHConfig
from repro_torch.core.queries import batch as tbatch
from repro_torch.core.queries.retrieval import parse_boolean as t_parse
from repro_torch.data.store import ShardedCorpus as TCorpus
from repro_torch.kernels.kmeans import kernel as tkernel
from repro_torch.kernels.kmeans import ops as tops
from repro_torch.kernels.kmeans import ref as tref
from repro_torch.testing import KMEANS_SHAPES


def _unit(rng, n, dim):
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _init_ids(seed, n, k):
    """The reference's initial centroid draw (allocation.py:44-45)."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,),
                                      replace=False))


@pytest.fixture(scope="module")
def port_corpus(small_corpus):
    return TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)


@pytest.mark.parametrize("n,k,dim", KMEANS_SHAPES)
def test_assign_matches_reference(n, k, dim):
    rng = np.random.default_rng(n)
    x, c = _unit(rng, n, dim), _unit(rng, k, dim)
    launches = tkernel.assign_kernel.launches
    ids, best = tops.assign_with_scores(torch.from_numpy(x),
                                        torch.from_numpy(c))
    assert tkernel.assign_kernel.launches == launches      # CPU: plain
    assert ids.dtype == torch.int32 and best.dtype == torch.float32
    want_ids, want_best = jref.assign_ref(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(
        tops.assign(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(jops.assign(jnp.asarray(x), jnp.asarray(c))))
    np.testing.assert_allclose(best.numpy(), np.asarray(want_best), rtol=1e-5,
                               atol=1e-6)


def test_duplicated_centroids_give_the_first_index():
    rng = np.random.default_rng(5)
    x, c = _unit(rng, 300, 16), _unit(rng, 9, 16)
    c[4], c[7], c[8] = c[1], c[1], c[6]       # later copies of 1 and 6
    got = tops.assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert set(np.unique(got)) & {1, 6}       # the duplicated ones win rows
    assert not set(np.unique(got)) & {4, 7, 8}
    np.testing.assert_array_equal(
        got, np.asarray(jref.assign_ref(jnp.asarray(x), jnp.asarray(c))[0]))


def test_chunked_plain_assignment_equals_whole(monkeypatch):
    """Row chunks (the plain version's guard against forming [N, K]
    whole) change no row's result."""
    rng = np.random.default_rng(8)
    x, c = torch.from_numpy(_unit(rng, 1000, 32)), torch.from_numpy(_unit(rng, 50, 32))
    whole = tref.assign_ref(x, c)
    monkeypatch.setattr(tref, "ROW_BYTES", 4 * 50 * 7)     # 7 rows a chunk
    assert tref.chunk_rows(50) == 7
    chunked = tref.assign_ref(x, c)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


def _clustered(seed=0, n=480, k=6, dim=16, noise=0.08):
    """Unit rows around k well-separated unit centers."""
    rng = np.random.default_rng(seed)
    centers = _unit(rng, k, dim)
    lab = rng.integers(0, k, n)
    return centers[lab] + noise * rng.normal(size=(n, dim)).astype(np.float32)


@pytest.mark.parametrize("balanced", [False, True])
def test_spherical_kmeans_matches_reference(balanced):
    x = _clustered()
    cfg = dict(n_clusters=6, iters=25, seed=3, balanced=balanced)
    want_a, want_c = jalloc.spherical_kmeans(x, jalloc.KMeansConfig(**cfg))
    got_a, got_c = talloc.spherical_kmeans(
        x, talloc.KMeansConfig(**cfg), device="cpu",
        init_ids=_init_ids(3, x.shape[0], 6))
    assert got_a.dtype == np.int64 and got_c.dtype == np.float32
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)


def test_spherical_kmeans_draws_its_own_init():
    x = _clustered(seed=1)
    cfg = talloc.KMeansConfig(n_clusters=6, balanced=False)
    a1, c1 = talloc.spherical_kmeans(x, cfg, device="cpu")
    a2, _ = talloc.spherical_kmeans(x, cfg, device="cpu")
    np.testing.assert_array_equal(a1, a2)          # seeded generator
    assert a1.shape == (x.shape[0],) and c1.shape == (6, 16)
    assert 0 <= a1.min() and a1.max() < 6


def test_update_equals_a_loop_over_the_sorted_rows():
    """The centroid update's sums are, bit for bit, each cluster's rows
    added one after another in row order from 0.0; the counts exact; a
    dead cluster takes the reference's (1, ..., 1) direction."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(600, 8)).astype(np.float32) * 30)
    assign = torch.from_numpy(rng.integers(0, 40, 600))
    assign[assign == 7] = 8                          # cluster 7 is dead
    sums, counts = talloc.cluster_sums(x, assign, 41)   # so is 40
    xs, a = x.numpy(), assign.numpy()
    for c in range(41):
        want = np.zeros(8, np.float32)
        for i in np.nonzero(a == c)[0]:
            want = want + xs[i]
        assert np.array_equal(sums[c].numpy(), want)
        assert counts[c] == (a == c).sum()
    cent = talloc._update(x, assign, 41)
    dead = torch.full((8,), 8 ** -0.5)
    torch.testing.assert_close(cent[7], dead, rtol=0, atol=1e-7)
    torch.testing.assert_close(cent[40], dead, rtol=0, atol=1e-7)
    np.testing.assert_allclose(cent[8].numpy(),
                               sums[8].numpy() / np.linalg.norm(sums[8]),
                               rtol=1e-6)


def test_spherical_kmeans_callback_follows_each_assignment(monkeypatch):
    """``callback(i)`` runs after every assignment: 0 for the initial one,
    then once per iteration, and assign is called exactly as often."""
    x = _clustered(seed=2)
    calls, seen = [], []
    inner = tops.assign

    def counting(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(tops, "assign", counting)
    a, _ = talloc.spherical_kmeans(
        x, talloc.KMeansConfig(n_clusters=6, balanced=False), device="cpu",
        init_ids=_init_ids(3, x.shape[0], 6), callback=seen.append)
    assert seen == list(range(len(seen))) and len(seen) == len(calls) >= 2
    assert len(seen) <= 26
    want, _ = talloc.spherical_kmeans(
        x, talloc.KMeansConfig(n_clusters=6, balanced=False), device="cpu",
        init_ids=_init_ids(3, x.shape[0], 6))
    np.testing.assert_array_equal(a, want)


def test_assign_away_from_ties_helper():
    """``testing.assert_assign_away_from_ties`` passes the plain
    assignment, fails one changed on a clear row, and counts the clear
    rows; one centroid has no runner-up and must match exactly."""
    from repro_torch.testing import assert_assign_away_from_ties
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_unit(rng, 200, 16))
    c = torch.from_numpy(_unit(rng, 9, 16))
    ids, _ = tref.assign_ref(x, c)
    assert assert_assign_away_from_ties(ids, x, c, "plain") == 200
    bad = ids.clone()
    bad[0] = (bad[0] + 1) % 9
    with pytest.raises(AssertionError):
        assert_assign_away_from_ties(bad, x, c, "changed")
    one = torch.zeros(200, dtype=torch.int32)
    assert assert_assign_away_from_ties(one, x, c[:1], "one") == 200
    with pytest.raises(AssertionError):
        assert_assign_away_from_ties(one + 1, x, c[:1], "one")


def test_rebalance_is_the_reference():
    rng = np.random.default_rng(2)
    x = _unit(rng, 200, 8)
    cent = _unit(rng, 5, 8)
    assign = np.where(rng.random(200) < 0.7, 0, rng.integers(0, 5, 200))
    want = jalloc._rebalance(x, cent, assign.astype(np.int64), 5)
    got = talloc._rebalance(x, cent, assign.astype(np.int64), 5)
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=5).max() <= int(np.ceil(200 / 5 * 1.25))
    assert (got != assign).any()


@pytest.fixture(scope="module")
def pre_index(small_corpus, pv_model):
    model, pcfg = pv_model
    return jindex.build_index(small_corpus, model, JLSHConfig(bits=128),
                              use_lsh=False, temperature=pcfg.temperature)


def _assert_same_shards(got, want):
    assert (got.n_shards, got.n_docs, got.n_tokens) == (want.n_shards,
                                                        want.n_docs,
                                                        want.n_tokens)
    for ts, js in zip(got.shards, want.shards):
        for name in ("tokens", "offsets", "doc_ids"):
            np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


def test_allocate_corpus_reallocates_like_reference(small_corpus, port_corpus,
                                                    pre_index):
    want = jalloc.allocate_corpus(small_corpus, pre_index.doc_vecs)
    got = talloc.allocate_corpus(
        port_corpus, pre_index.doc_vecs, device="cpu",
        init_ids=_init_ids(3, small_corpus.n_docs, small_corpus.n_shards))
    _assert_same_shards(got, want)
    # reallocate alone, on one assignment
    assign = np.random.default_rng(0).integers(0, 7, small_corpus.n_docs)
    _assert_same_shards(port_corpus.reallocate(assign, 7),
                        small_corpus.reallocate(assign, 7))


def _queries(mod, parse):
    return [mod.BatchQuery.count([5]), mod.BatchQuery.ranked([3, 8, 11], k=5),
            mod.BatchQuery.boolean(parse([4, "or", 9, "and", 12])),
            mod.BatchQuery.count([7, 2]), mod.BatchQuery.ranked([1, 2], k=8)]


def test_offline_build_then_serve_matches_reference(small_corpus, port_corpus,
                                                    pv_model, pre_index):
    """examples/serve_queries.py's build order on both packages, from the
    same trained model, k-means init and planes: the pre-index's vectors,
    the allocated corpus, the index's signatures and a served batch."""
    model, pcfg = pv_model
    tmodel = tpv.model_from_arrays(np.asarray(model.word_vecs),
                                   np.asarray(model.doc_vecs), "cpu")
    tpre = tindex.build_index(port_corpus, tmodel, TLSHConfig(bits=128),
                              use_lsh=False, temperature=pcfg.temperature,
                              device="cpu")
    np.testing.assert_allclose(tpre.doc_vecs, pre_index.doc_vecs, rtol=0,
                               atol=1e-6)
    jc = jalloc.allocate_corpus(small_corpus, pre_index.doc_vecs)
    tc = talloc.allocate_corpus(
        port_corpus, tpre.doc_vecs, device="cpu",
        init_ids=_init_ids(3, small_corpus.n_docs, small_corpus.n_shards))
    _assert_same_shards(tc, jc)
    jidx = dataclasses.replace(
        jindex.build_index(jc, model, JLSHConfig(bits=256),
                           temperature=pcfg.temperature, granularity="doc"),
        use_kernel=True).attach_corpus(jc)
    tidx = tindex.build_index(tc, tmodel, TLSHConfig(bits=256),
                              temperature=pcfg.temperature, granularity="doc",
                              planes=jidx.planes,
                              device="cpu").attach_corpus(tc)
    for name in ("word_sig", "shard_sig", "doc_sig"):
        np.testing.assert_array_equal(getattr(tidx, name),
                                      getattr(jidx, name), err_msg=name)
    jq, tq = _queries(jbatch, j_parse), _queries(tbatch, t_parse)
    jeng, teng = jbatch.QueryBatch(jc, jidx), tbatch.QueryBatch(tc, tidx)
    for g, w in zip(teng._probability_rows(tq, tc, tidx),
                    jeng._probability_rows(jq, jc, jidx)):
        np.testing.assert_allclose(g, w, rtol=1e-4)
    for g, w in zip(teng.execute(tq, 1.0), jeng.execute(jq, 1.0)):
        if hasattr(w, "doc_ids"):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        else:
            assert g.estimate.value == w.estimate.value
