"""``QueryBatch.execute`` on both packages: the JAX package's engine over
its doc-granular kernel index, and the port's engine over the port's
load of the same index, corpus and queries.

  * At rate 1.0 (a census) counts, Boolean doc ids and ranked ids are
    equal.
  * Below 1.0, with the same probability rows injected into both
    engines, the sampled plans and the estimates are bit for bit equal
    (numpy's RNG drives both samplers).
  * The probability rows each engine computes itself agree within
    rtol=1e-4, the tolerance of the fused kernels.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.queries import batch as jbatch
from repro.core.queries.retrieval import parse_boolean as j_parse
from repro.runtime.executor import ShardTaskExecutor as JExecutor
from repro_torch.core import index as tindex
from repro_torch.core.queries import batch as tbatch
from repro_torch.core.queries import aggregation as tagg
from repro_torch.core.queries import retrieval as tret
from repro_torch.core.queries.retrieval import parse_boolean as t_parse
from repro_torch.data.store import ShardedCorpus as TCorpus
from repro_torch.runtime.executor import ShardTaskExecutor as TExecutor
from repro_torch.runtime.qcache import SemanticQueryCache

RATES = [0.1, 0.3, 0.6]


def _queries(mod, parse):
    return [mod.BatchQuery.count([5]),
            mod.BatchQuery.ranked([3, 8, 11], k=5),
            mod.BatchQuery.boolean(parse([4, "or", 9, "and", 12])),
            mod.BatchQuery.count([7, 2]),
            mod.BatchQuery.ranked([1, 2], k=8),
            mod.BatchQuery.boolean(parse([6, "and", 3])),
            mod.BatchQuery.count([14])]


@pytest.fixture(scope="module")
def engines(small_corpus, built_index, tmp_path_factory):
    ref_index = dataclasses.replace(built_index, granularity="doc",
                                    use_kernel=True).attach_corpus(small_corpus)
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    ref_index.save(path)
    port_index = tindex.ApproxIndex.load(path, device="cpu")
    port_corpus = TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)
    port_index.attach_corpus(port_corpus)
    return ((small_corpus, ref_index), (port_corpus, port_index))


def _pair(engines, ref_exec=None, port_exec=None):
    (jc, ji), (tc, ti) = engines
    return (jbatch.QueryBatch(jc, ji, executor=ref_exec),
            tbatch.QueryBatch(tc, ti, executor=port_exec))


def _assert_same_results(got, want, exact=True):
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        np.testing.assert_array_equal(g.sample.shard_ids, w.sample.shard_ids)
        assert g.shards_read == w.shards_read
        if hasattr(w, "scores"):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
            np.testing.assert_array_equal(g.scores, w.scores)
        elif hasattr(w, "doc_ids"):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        else:
            assert g.estimate.value == w.estimate.value
            assert (g.estimate.error_bound == w.estimate.error_bound
                    or np.isinf(w.estimate.error_bound))


@pytest.mark.parametrize("use_executor", [False, True])
def test_census_results_equal(engines, use_executor):
    ref, port = _pair(engines,
                      JExecutor(workers=2) if use_executor else None,
                      TExecutor(workers=2) if use_executor else None)
    want = ref.execute(_queries(jbatch, j_parse), 1.0)
    got = port.execute(_queries(tbatch, t_parse), 1.0)
    _assert_same_results(got, want)
    assert got[0].estimate.value == float(engines[1][0].count_phrase([5]))


@pytest.mark.parametrize("rate", RATES)
def test_injected_rows_give_identical_plans_and_estimates(engines, rate):
    ref, port = _pair(engines)
    jq, tq = _queries(jbatch, j_parse), _queries(tbatch, t_parse)
    rows = ref._probability_rows(jq, *engines[0])
    ref._probability_rows = lambda *a: rows
    port._probability_rows = lambda *a: rows
    want = ref.execute(jq, rate, rng=np.random.default_rng(7))
    got = port.execute(tq, rate, rng=np.random.default_rng(7))
    for g, w in zip(port.last_report.plan, ref.last_report.plan):
        np.testing.assert_array_equal(g, w)
    _assert_same_results(got, want)


@pytest.mark.parametrize("rate", RATES)
def test_uninjected_rows_agree(engines, rate):
    ref, port = _pair(engines)
    want = ref._probability_rows(_queries(jbatch, j_parse), *engines[0])
    got = port._probability_rows(_queries(tbatch, t_parse), *engines[1])
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-4)
    # and the engine runs end to end on its own rows
    res = port.execute(_queries(tbatch, t_parse), rate,
                       rng=np.random.default_rng(3))
    assert len(res) == 7 and all(np.isfinite(r.elapsed_s) for r in res)


def test_executor_matches_inline_and_survives_faults(engines):
    faults = {"n": 0}

    def hook(sid, attempt):
        if sid % 3 == 0 and attempt == 1:
            faults["n"] += 1
            raise RuntimeError("injected")

    with TExecutor(workers=3, fault_hook=hook) as ex:
        _, pooled = _pair(engines, port_exec=ex)
        _, inline = _pair(engines)
        a = pooled.execute(_queries(tbatch, t_parse), 0.3,
                           rng=np.random.default_rng(5))
        b = inline.execute(_queries(tbatch, t_parse), 0.3,
                           rng=np.random.default_rng(5))
        assert faults["n"] > 0 and ex.stats["retries"] == faults["n"]
    _assert_same_results(a, b)


def test_single_query_entry_points_match_batch(engines):
    corpus, index = engines[1]
    rng = np.random.default_rng(11)
    single = [tagg.phrase_count_query(corpus, index, [5], 0.3, rng=rng),
              tret.ranked_query(corpus, index, [3, 8, 11], 0.3, k=5, rng=rng)]
    batch = tbatch.QueryBatch(corpus, index).execute(
        [tbatch.BatchQuery.count([5]), tbatch.BatchQuery.ranked([3, 8, 11], k=5)],
        0.3, rng=np.random.default_rng(11))
    np.testing.assert_allclose(batch[0].estimate.value,
                               single[0].estimate.value, rtol=1e-6)
    np.testing.assert_array_equal(batch[1].doc_ids, single[1].doc_ids)
    assert tret.recall(batch[1].doc_ids, single[1].doc_ids) == 1.0
    assert tret.precision_at_k(batch[1].doc_ids, single[1].doc_ids, 5) == 1.0


def test_semantic_cache_hits_replay_results(engines):
    corpus, index = engines[1]
    engine = tbatch.QueryBatch(corpus, index, cache=SemanticQueryCache())
    first = engine.execute(_queries(tbatch, t_parse), 0.3,
                           rng=np.random.default_rng(1))
    assert engine.last_report.cache["misses"] == 7
    again = engine.execute(_queries(tbatch, t_parse), 0.3,
                           rng=np.random.default_rng(2))
    assert engine.last_report.cache["hits"] == 7
    _assert_same_results(again, first)
