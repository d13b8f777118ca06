"""Live ingest in the port against the JAX package: the store's
copy-on-write append path, the incremental index refresh, the content
fence, and the ``Ingestor``.

Tolerances: corpus shards, CSR postings, doc frequencies and every
untouched row exactly (bit for bit); the appended documents' vectors
within atol=1e-5 of the reference's on the reference's threefry draws
(frozen-model inference, ``tests/test_torch_pv_dbow.py``), and their
signatures exactly; a refreshed doc-granular index plans within
rtol=1e-4 of the unfused route over its own new arrays (the fused
kernels' tolerance).  The background ``Ingestor`` is awaited through
the event its ``step`` sets, with a time limit of its own, never by
polling its counters."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import port_corpus, port_index
from repro.core import index as jindex
from repro.core import pv_dbow as jpv
from repro.data import store as jstore
from repro_torch.core import index as tindex
from repro_torch.core import lsh as tlsh
from repro_torch.core import pv_dbow as tpv
from repro_torch.core.queries import BatchQuery, QueryBatch
from repro_torch.data import store as tstore
from repro_torch.launch.serve_stack import ServeConfig, build_serving_stack
from repro_torch.runtime.generation import Generation, GenerationClock
from repro_torch.runtime.qcache import SemanticQueryCache

STORES = {"jax": jstore, "port": tstore}
WAIT_S = 60.0     # the background writer's own time limit


def _rand_docs(rng, n, vocab, mean_len=30):
    return [rng.integers(0, vocab, size=int(rng.integers(5, mean_len * 2)))
            .astype(np.int32) for _ in range(n)]


def _shards(corpus):
    return [(s.shard_id, s.tokens, s.offsets, s.doc_ids)
            for s in corpus.shards]


def _assert_same_shards(a, b):
    assert len(a.shards) == len(b.shards)
    for x, y in zip(_shards(a), _shards(b)):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def _assert_same_postings(a, b):
    for name in ("indptr", "doc_idx", "tf"):
        u, v = getattr(a, name), getattr(b, name)
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def _port_cfg(jcfg):
    return tpv.PVDBOWConfig(**{k: v for k, v in
                               dataclasses.asdict(jcfg).items()
                               if k != "use_kernel"})


def _reference_draws(jcfg, docs, steps, vocab):
    """The reference inference's threefry draws for ``docs``: the
    initial vector (one for every document: the key restarts) and each
    document's [len, k] noise words per step."""
    key = jax.random.PRNGKey(jcfg.seed + 1)
    init = np.array(jax.random.normal(key, (1, jcfg.dim), jnp.float32)
                    / np.sqrt(jcfg.dim))
    subs = jpv._split_chain(key, steps)
    kneg = {(i, s): np.array(jax.random.randint(
        subs[s], (len(d), jcfg.negatives), 0, vocab))
        for i, d in enumerate(docs) for s in range(steps)}
    return torch.from_numpy(init), lambda i, s: kneg[(i, s)]


@pytest.fixture(scope="module")
def port_world(small_corpus, built_index, pv_model, tmp_path_factory):
    model, jcfg = pv_model
    path = tmp_path_factory.mktemp("ingest") / "index.npz"
    return dict(corpus=port_corpus(small_corpus),
                index=port_index(built_index, path),
                model=tpv.model_from_arrays(np.asarray(model.word_vecs),
                                            np.asarray(model.doc_vecs),
                                            "cpu"),
                cfg=_port_cfg(jcfg))


# ----------------------------------------------------------------------
# the store's append path, in both packages
# ----------------------------------------------------------------------
def test_append_unbounded_grows_the_open_shard_bit_for_bit():
    out = {}
    for name, st in STORES.items():
        rng = np.random.default_rng(0)
        base = _rand_docs(rng, 40, vocab=64)
        corpus = st.ShardedCorpus.from_documents(
            [st.Document(i, t) for i, t in enumerate(base)], 64,
            shard_tokens=512)
        for s in corpus.shards:
            st.shard_postings(s)
        grown, new_ids, affected = corpus.append_documents(
            _rand_docs(rng, 15, vocab=64))
        assert grown.n_shards == corpus.n_shards
        assert affected == [corpus.n_shards - 1]
        np.testing.assert_array_equal(new_ids, np.arange(40, 55))
        for sid in range(corpus.n_shards - 1):
            assert grown.shards[sid] is corpus.shards[sid]
        open_shard = grown.shards[-1]
        assert open_shard._postings is not None
        _assert_same_postings(open_shard._postings, st.build_postings(
            st.DocShard.from_documents(open_shard.shard_id,
                                       list(open_shard.iter_documents()))))
        out[name] = grown
    _assert_same_shards(out["port"], out["jax"])
    _assert_same_postings(out["port"].shards[-1]._postings,
                          out["jax"].shards[-1]._postings)


@pytest.mark.parametrize("budget", [64, 256, 4096])
def test_append_budgeted_spills_like_from_documents(budget):
    out = {}
    for name, st in STORES.items():
        rng = np.random.default_rng(1)
        base, extra = _rand_docs(rng, 30, 32), _rand_docs(rng, 30, 32)
        corpus = st.ShardedCorpus.from_documents(
            [st.Document(i, t) for i, t in enumerate(base)], 32,
            shard_tokens=budget)
        grown, new_ids, affected = corpus.append_documents(
            extra, shard_tokens=budget)
        oracle = st.ShardedCorpus.from_documents(
            [st.Document(i, t) for i, t in enumerate(base + extra)], 32,
            shard_tokens=budget)
        _assert_same_shards(grown, oracle)
        assert grown.n_docs == 60 and affected
        out[name] = (grown, list(affected), new_ids)
    _assert_same_shards(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])


def test_append_empty_is_identity_and_postings_merge_widens():
    corpus = tstore.ShardedCorpus.from_documents(
        [tstore.Document(i, t) for i, t in
         enumerate(_rand_docs(np.random.default_rng(2), 5, 16))], 16,
        shard_tokens=128)
    same, ids, affected = corpus.append_documents([])
    assert same is corpus and len(ids) == 0 and affected == []
    merged = {}
    for name, st in STORES.items():
        old_docs = [st.Document(0, np.asarray([1, 1, 2], np.int32))]
        new_docs = [st.Document(1, np.asarray([5, 2], np.int32))]
        old = st.build_postings(st.DocShard.from_documents(0, old_docs))
        delta = st.build_postings(st.DocShard.from_documents(0, new_docs))
        merged[name] = st.merge_postings(old, 1, delta)
        _assert_same_postings(merged[name], st.build_postings(
            st.DocShard.from_documents(0, old_docs + new_docs)))
    _assert_same_postings(merged["port"], merged["jax"])


@pytest.mark.parametrize("words", [[3], [3, 7], [2, 9, 11], [2047], []])
def test_docs_matching_all_and_its_scan(small_corpus, words):
    corpus = port_corpus(small_corpus)
    for js, ts in zip(small_corpus.shards, corpus.shards):
        want = jstore.docs_matching_all(js, words)
        np.testing.assert_array_equal(tstore.docs_matching_all(ts, words),
                                      want)
        np.testing.assert_array_equal(
            tstore.docs_matching_all_scan(ts, words), want)


# ----------------------------------------------------------------------
# refresh_appended
# ----------------------------------------------------------------------
@pytest.mark.parametrize("budget", [None, 4096])
def test_refresh_appended_matches_the_reference(small_corpus, built_index,
                                                pv_model, port_world,
                                                budget):
    model, jcfg = pv_model
    steps = 5
    # two document lengths: the reference compiles its inference step
    # once per length
    rng = np.random.default_rng(4)
    extra = [rng.integers(0, small_corpus.vocab_size, 24 + 16 * (i % 2))
             .astype(np.int32) for i in range(12)]
    jgrown, _, jaff = small_corpus.append_documents(extra,
                                                    shard_tokens=budget)
    want = jindex.refresh_appended(built_index, jgrown, model, jcfg, extra,
                                   jaff, infer_steps=steps)
    pidx = port_world["index"]
    grown, _, affected = port_world["corpus"].append_documents(
        extra, shard_tokens=budget)
    assert list(affected) == list(jaff)
    init, negs = _reference_draws(jcfg, extra, steps, small_corpus.vocab_size)
    walls = {}
    got = tindex.refresh_appended(pidx, grown, port_world["model"],
                                  port_world["cfg"], extra, affected,
                                  infer_steps=steps, timings=walls,
                                  init_vec=init, negatives=negs)
    n0, s0 = pidx.n_docs, pidx.shard_vecs.shape[0]
    assert set(walls) == {"infer_s", "sign_s", "centroids_s", "doc_freq_s"}
    # old rows and untouched shard rows: byte-identical
    np.testing.assert_array_equal(got.doc_vecs[:n0], pidx.doc_vecs)
    np.testing.assert_array_equal(got.doc_sig[:n0], pidx.doc_sig)
    untouched = [s for s in range(s0) if s not in set(affected)]
    np.testing.assert_array_equal(got.shard_vecs[untouched],
                                  pidx.shard_vecs[untouched])
    np.testing.assert_array_equal(got.shard_sig[untouched],
                                  pidx.shard_sig[untouched])
    # new doc vectors: the reference's within inference tolerance;
    # their signatures exactly the reference's
    np.testing.assert_allclose(got.doc_vecs[n0:], want.doc_vecs[n0:],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.doc_sig, want.doc_sig)
    # touched rows: the build ops over the new membership, bit for bit,
    # and their signatures the reference's
    touched = sorted(set(affected) | set(range(s0, grown.n_shards)))
    for sid in touched:
        mean = got.doc_vecs[grown.shards[sid].doc_ids].mean(axis=0)
        np.testing.assert_array_equal(got.shard_vecs[sid], mean)
    np.testing.assert_array_equal(
        got.shard_sig[touched],
        tindex._sign_rows(got.shard_vecs[touched],
                          torch.from_numpy(got.planes)))
    np.testing.assert_allclose(got.shard_vecs, want.shard_vecs, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.shard_sig, want.shard_sig)
    # the appended rows are signed as the reference signs them
    np.testing.assert_array_equal(
        got.doc_sig[n0:], tlsh.sign_vectors_np(got.doc_vecs[n0:], got.planes))
    np.testing.assert_array_equal(got.doc_freq, want.doc_freq)
    assert (got.n_docs, got.avg_doc_len) == (want.n_docs, want.avg_doc_len)
    assert got.clock is pidx.clock and pidx.n_docs == small_corpus.n_docs
    for cache in ("_dev", "_shard_sort", "_megascan_pay"):
        assert getattr(got, cache, None) is None


def test_refresh_appended_refusals(small_corpus, port_world):
    pidx, corpus = port_world["index"], port_world["corpus"]
    extra = [np.asarray([1, 2, 3], np.int32)]
    grown, _, affected = corpus.append_documents(extra)
    stripped = dataclasses.replace(pidx, doc_vecs=None, doc_sig=None)
    with pytest.raises(ValueError, match="keep_doc_vectors"):
        tindex.refresh_appended(stripped, grown, port_world["model"],
                                port_world["cfg"], extra, affected)
    with pytest.raises(ValueError, match="line up"):
        tindex.refresh_appended(pidx, grown, port_world["model"],
                                port_world["cfg"], extra + extra, affected)
    assert tindex.refresh_appended(pidx, grown, port_world["model"],
                                   port_world["cfg"], [], []) is pidx


def test_refreshed_doc_granular_index_builds_fresh_device_state(port_world):
    """A doc-granular index planned once (caches built), then refreshed
    with a spill: the new index plans through the fused route over the
    NEW arrays (equal to its unfused route within rtol 1e-4), and its
    megascan sums over the new and the touched shards are bit for bit
    the per-shard route's."""
    from repro_torch.kernels.megascan import MegascanSpec
    from repro_torch.runtime.executor import ShardTaskExecutor

    corpus = port_world["corpus"]
    old = dataclasses.replace(port_world["index"],
                              granularity="doc").attach_corpus(corpus)
    qs = [[3, 7], [5], [2, 9, 11]]
    old.shard_similarities_batch(qs)
    old.megascan_payload(tuple(range(corpus.n_shards)))
    extra = _rand_docs(np.random.default_rng(8), 40, corpus.vocab_size)
    grown, _, affected = corpus.append_documents(extra, shard_tokens=2048)
    assert grown.n_shards > corpus.n_shards
    new = tindex.refresh_appended(old, grown, port_world["model"],
                                  port_world["cfg"], extra, affected,
                                  infer_steps=3)
    fused = new.shard_similarities_batch(qs)
    assert fused.shape == (len(qs), grown.n_shards)
    np.testing.assert_allclose(fused, new.shard_similarities_batch(
        qs, fused=False), rtol=1e-4)
    assert new._fused_device_arrays()["offsets"].shape[0] == \
        grown.n_shards + 1
    touched = sorted(set(affected) | set(range(corpus.n_shards,
                                               grown.n_shards)))
    spec = MegascanSpec(new, new.query_vectors(qs))
    plans = [touched] * len(qs)
    with ShardTaskExecutor(workers=2) as ex:
        group = ex.map_shard_batch(grown, plans, spec.scan_fns(),
                                   megakernel=True)
        per = ex.map_shard_batch(grown, plans, spec.scan_fns(),
                                 megakernel=False)
    assert group == per and all(set(g) == set(touched) for g in group)


# ----------------------------------------------------------------------
# the content fence and the generation
# ----------------------------------------------------------------------
def test_qcache_fences_on_content_change(port_world):
    corpus = port_world["corpus"]
    index = dataclasses.replace(port_world["index"]).use_clock(
        GenerationClock())
    cache = SemanticQueryCache()
    engine = QueryBatch(corpus, index, cache=cache)
    q = BatchQuery.count((3, 7))
    assert engine._generation() == Generation(0, 0)
    r0 = engine.execute([q], 0.5, np.random.default_rng(9))[0]
    r1 = engine.execute([q], 0.5, np.random.default_rng(10))[0]
    assert cache.stats["hits"] == 1
    assert r1.estimate.value == r0.estimate.value
    index.attach_corpus(corpus)
    assert engine._generation() == Generation(0, 1)
    engine.execute([q], 0.5, np.random.default_rng(11))
    assert cache.stats["hits"] == 1 and cache.stats["stale_epoch"] >= 1
    assert engine._cache_epoch() == 0


# ----------------------------------------------------------------------
# the Ingestor
# ----------------------------------------------------------------------
def test_serve_config_ingest_validation(port_world):
    model, cfg = port_world["model"], port_world["cfg"]
    for kw, match in ((dict(ingest=True), "ingest_model"),
                      (dict(ingest_model=model), "ingest=False"),
                      (dict(refresh_docs=0), "refresh_docs"),
                      (dict(refresh_interval_s=0.0), "refresh_interval_s"),
                      (dict(ingest_infer_steps=0), "ingest_infer_steps"),
                      (dict(ingest_yield_s=-0.001), "ingest_yield_s"),
                      (dict(ingest_shard_tokens=0), "ingest_shard_tokens")):
        full = dict(ingest=True, ingest_model=model, ingest_pv_cfg=cfg)
        full.update(kw)
        if "ingest" in kw or "ingest_model" in kw:
            full = kw
        with pytest.raises(ValueError, match=match):
            ServeConfig(**full)
    ok = ServeConfig(ingest=True, ingest_model=model, ingest_pv_cfg=cfg,
                     ingest_yield_s=0.0)
    assert ok.ingest and ok.refresh_docs == 64


def test_ingestor_step_swaps_then_bumps(small_corpus, pv_model, built_index,
                                        port_world):
    """The same documents through both packages' stacks: the census
    count grows by exactly the appended occurrences, the generation
    records agree, and an empty step neither swaps nor bumps."""
    from repro.launch.serve_stack import build_serving_stack as jbuild
    from repro.core.queries import BatchQuery as JQuery

    model, jcfg = pv_model
    v = small_corpus.vocab_size
    phrase = (v - 2, v - 1)
    rng = np.random.default_rng(5)
    new_docs = [np.concatenate([np.asarray(phrase, np.int32),
                                rng.integers(0, v - 2, 20).astype(np.int32)])
                for _ in range(10)]
    recs = {}
    with jbuild(small_corpus, built_index, cache=True, ingest=True,
                ingest_model=model, ingest_pv_cfg=jcfg,
                ingest_infer_steps=2) as stack:
        c0 = stack.engine.execute([JQuery.count(phrase)], 1.0)[0]
        rec = stack.ingestor.step(new_docs)
        c1 = stack.engine.execute([JQuery.count(phrase)], 1.0)[0]
        recs["jax"] = (c0.estimate.value, c1.estimate.value, rec,
                       stack.ingestor.step([]), stack.generation.record())
    with build_serving_stack(
            port_world["corpus"], dataclasses.replace(port_world["index"]),
            cache=True, ingest=True, ingest_model=port_world["model"],
            ingest_pv_cfg=port_world["cfg"],
            ingest_infer_steps=2) as stack:
        c0 = stack.engine.execute([BatchQuery.count(phrase)], 1.0)[0]
        assert stack.generation == Generation(0, 0)
        rec = stack.ingestor.step(new_docs)
        assert stack.ingestor.swapped.is_set()
        c1 = stack.engine.execute([BatchQuery.count(phrase)], 1.0)[0]
        assert stack.corpus is stack.engine.corpus
        assert stack.index is stack.engine.index
        ing = stack.ingestor.record()
        assert ing["swaps"] == 1 and ing["docs_appended"] == 10
        recs["port"] = (c0.estimate.value, c1.estimate.value, rec,
                        stack.ingestor.step([]), stack.generation.record())
    assert recs["port"] == recs["jax"]
    assert recs["port"][1] == recs["port"][0] + 10
    assert recs["port"][4] == dict(placement=0, content=1)


def test_ingestor_spill_extends_the_placement(port_world):
    corpus = port_world["corpus"]
    extra = _rand_docs(np.random.default_rng(12), 60, corpus.vocab_size)
    with build_serving_stack(
            corpus, dataclasses.replace(port_world["index"]), hosts=2,
            replicas=1, ingest=True, ingest_model=port_world["model"],
            ingest_pv_cfg=port_world["cfg"], ingest_infer_steps=2,
            ingest_shard_tokens=1024, ingest_yield_s=0.0) as stack:
        rec = stack.ingestor.step(extra)
        assert rec["new_shards"] > 0
        assert stack.executor.placement.n_shards == stack.corpus.n_shards
        assert rec["generation"] == dict(placement=1, content=1)
        res = stack.engine.execute([BatchQuery.count((3,))], 1.0)[0]
        assert res.estimate.value == stack.corpus.count_phrase((3,))
        assert res.shards_read == stack.corpus.n_shards


def test_ingestor_background_source_signals_its_step(port_world):
    fed = threading.Event()
    rng = np.random.default_rng(6)
    vocab = port_world["corpus"].vocab_size

    def source(n):
        if fed.is_set():
            return []
        fed.set()
        return _rand_docs(rng, 5, vocab)

    with build_serving_stack(
            port_world["corpus"], dataclasses.replace(port_world["index"]),
            ingest=True, ingest_model=port_world["model"],
            ingest_pv_cfg=port_world["cfg"], ingest_source=source,
            refresh_interval_s=0.01, ingest_infer_steps=2) as stack:
        assert stack.ingestor.running
        assert stack.ingestor.swapped.wait(timeout=WAIT_S)
        rec = stack.ingestor.record()
        assert rec["docs_appended"] == 5 and rec["errors"] == []
        stack.ingestor.close()
        assert not stack.ingestor.running
        stack.ingestor.close()


def test_a_read_racing_the_swap_is_pre_or_post(port_world):
    """While ``step`` swaps the world, every concurrent batch returns
    bit for bit the pre-append or the post-append answer."""
    corpus, model, cfg = (port_world["corpus"], port_world["model"],
                          port_world["cfg"])
    index = port_world["index"]
    extra = _rand_docs(np.random.default_rng(7), 30, corpus.vocab_size)
    queries = [BatchQuery.count((3, 7)), BatchQuery.ranked((11, 23), k=5),
               BatchQuery.count((5,))]
    seeds = list(range(40, 44))

    def run_one(engine, s):
        res = engine.execute(queries, 0.5, np.random.default_rng(s))
        return tuple((r.estimate.value if r.estimate is not None else None,
                      tuple(np.asarray(getattr(r, "doc_ids", []),
                                       np.int64).tolist())) for r in res)

    with build_serving_stack(corpus, dataclasses.replace(index)) as ref:
        pre = {s: run_one(ref.engine, s) for s in seeds}
    grown, _, affected = corpus.append_documents(extra)
    post_index = tindex.refresh_appended(dataclasses.replace(index), grown,
                                         model, cfg, extra, affected,
                                         infer_steps=3)
    with build_serving_stack(grown, post_index) as ref:
        post = {s: run_one(ref.engine, s) for s in seeds}
    with build_serving_stack(corpus, dataclasses.replace(index), ingest=True,
                             ingest_model=model, ingest_pv_cfg=cfg,
                             ingest_infer_steps=3) as stack:
        start = threading.Barrier(2)

        def writer():
            start.wait()
            stack.ingestor.step(extra)

        t = threading.Thread(target=writer)
        t.start()
        observed = []
        start.wait()
        for _ in range(10):
            for s in seeds:
                observed.append((s, run_one(stack.engine, s)))
        t.join()
        after = {s: run_one(stack.engine, s) for s in seeds}
    assert after == post
    for s, got in observed:
        assert got == pre[s] or got == post[s], "torn batch during swap"
