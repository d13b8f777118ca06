"""The paper-faithful sym (two-sided Hamming) mode of the port's index
and serving engine against the JAX package's, on the same state.

A JAX-built doc-granular sym index with its kernels on (Pallas in
interpret mode here) is saved and loaded by the port.  The port signs
sym queries on the host (``lsh.sign_vectors_np``), the reference with
jax; the two agree bit for bit on query vectors clear of every
hyperplane, so the queries here are drawn from those
(``repro_torch.testing.sign_clear``).  Then:

  * shard similarities (doc- and shard-granular, fused and unfused) and
    the Boolean word x shard rows agree within rtol=1e-4;
  * the sym doc top-k gives the reference's ids exactly, ties included:
    the value is a monotone function of the integer distance, so the
    order is (distance, doc index) in both packages;
  * ``QueryBatch.execute`` gives the reference's probability rows and,
    given the same rows, its plans and estimates bit for bit;
  * the Hamming megascan through the executor's group route equals the
    per-shard route bit for bit and the reference within rtol=1e-4.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.queries import batch as jbatch
from repro.core.queries.retrieval import parse_boolean as j_parse
from repro.kernels.megascan import MegascanSpec as JSpec
from repro.runtime.executor import ShardTaskExecutor as JExecutor
from repro_torch.core import index as tindex
from repro_torch.core.queries import batch as tbatch
from repro_torch.core.queries.retrieval import parse_boolean as t_parse
from repro_torch.data.store import ShardedCorpus as TCorpus
from repro_torch.kernels.hamming import kernel as hkernel
from repro_torch.kernels.megascan import MegascanSpec as TSpec
from repro_torch.kernels.megascan import ops as mops
from repro_torch.runtime.executor import ShardTaskExecutor as TExecutor
from repro_torch.testing import sign_clear

RATES = [0.1, 0.3, 0.6]


@pytest.fixture(scope="module")
def sym(small_corpus, built_index, tmp_path_factory):
    """((reference corpus, reference sym index), (port corpus, the
    port's load of it), clear query word sets, clear single words)."""
    ref = dataclasses.replace(built_index, granularity="doc", use_kernel=True,
                              lsh_mode="sym").attach_corpus(small_corpus)
    path = str(tmp_path_factory.mktemp("idx") / "sym.npz")
    ref.save(path)
    port = tindex.ApproxIndex.load(path, device="cpu")
    corpus = TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)
    port.attach_corpus(corpus)
    rng = np.random.default_rng(0)
    pool = [sorted(rng.choice(np.arange(1, 200), int(rng.integers(1, 4)),
                              replace=False).tolist()) for _ in range(40)]
    ok = sign_clear(port.query_vectors(pool), port.planes)
    sets = [p for p, c in zip(pool, ok) if c][:8]
    words = np.arange(1, 200)
    single = words[sign_clear(port.word_vecs[words], port.planes)][:12]
    assert len(sets) == 8 and len(single) == 12
    return (small_corpus, ref), (corpus, port), sets, [int(w) for w in single]


def test_sym_index_loads_as_sym(sym):
    (_, ref), (_, port), _, _ = sym
    assert port.lsh_mode == ref.lsh_mode == "sym"


def test_sym_query_signatures_equal_the_reference_signing(sym):
    (_, ref), (_, port), sets, _ = sym
    import jax.numpy as jnp
    from repro.core import lsh as jlsh
    vecs = ref.query_vectors(sets)
    want = np.asarray(jlsh.pack_bits(jlsh.signature_bits(
        jnp.asarray(vecs, jnp.float32), jnp.asarray(ref.planes))))
    got = port.query_sig_tensor(vecs).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [True, False])
def test_sym_doc_granular_shard_similarities_match(sym, fused):
    (_, ref), (_, port), sets, _ = sym
    want = ref.shard_similarities_batch(sets, fused=fused)
    got = port.shard_similarities_batch(sets, fused=fused)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4)
    singles = np.stack([port.shard_similarities(q) for q in sets])
    np.testing.assert_allclose(singles, want, rtol=1e-4)


def test_sym_fused_equals_unfused_within_the_port(sym):
    _, (_, port), sets, _ = sym
    np.testing.assert_allclose(port.shard_similarities_batch(sets),
                               port.shard_similarities_batch(sets,
                                                             fused=False),
                               rtol=1e-5)


def test_sym_shard_granular_and_word_rows_match(sym):
    (_, ref), (_, port), sets, words = sym
    r = dataclasses.replace(ref, granularity="shard")
    p = dataclasses.replace(port, granularity="shard")
    np.testing.assert_allclose(p.shard_similarities_batch(sets),
                               r.shard_similarities_batch(sets), rtol=1e-4)
    np.testing.assert_allclose(port.word_shard_similarities_batch(words),
                               ref.word_shard_similarities_batch(words),
                               rtol=1e-4)
    np.testing.assert_allclose(port.word_shard_similarity(words[3]),
                               ref.word_shard_similarity(words[3]),
                               rtol=1e-4)
    np.testing.assert_allclose(port.shard_probabilities(sets[0]),
                               ref.shard_probabilities(sets[0]), rtol=1e-4)


@pytest.mark.parametrize("k", [1, 10, 50, 10_000])
def test_sym_topk_ids_equal_exactly_ties_included(sym, k):
    (_, ref), (_, port), sets, _ = sym
    want_ids, want_vals = ref.topk_doc_similarities_batch(sets, k=k)
    ids, vals = port.topk_doc_similarities_batch(sets, k=k)
    assert ids.dtype == np.int64 and vals.dtype == np.float64
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4)
    if k >= 50:      # 600 docs over 129 distances: exact ties are there
        assert (np.diff(vals, axis=1) == 0).any()
    uids, _ = port.topk_doc_similarities_batch(sets, k=k, fused=False)
    np.testing.assert_array_equal(uids, ids)


def test_sym_cpu_index_launches_no_kernel(sym):
    _, (_, port), sets, words = sym
    before = (hkernel.hamming_similarity_kernel.launches,
              hkernel.hamming_segment_similarity_kernel.launches)
    port.shard_similarities_batch(sets)
    port.word_shard_similarities_batch(words)
    port.topk_doc_similarities_batch(sets, k=5)
    assert (hkernel.hamming_similarity_kernel.launches,
            hkernel.hamming_segment_similarity_kernel.launches) == before


# ----------------------------------------------------------------------
# the sym slice as a whole: QueryBatch.execute
# ----------------------------------------------------------------------
def _queries(mod, parse, sets, words):
    w = words
    return [mod.BatchQuery.count(sets[0]),
            mod.BatchQuery.ranked(sets[1], k=5),
            mod.BatchQuery.boolean(parse([w[0], "or", w[1], "and", w[2]])),
            mod.BatchQuery.count(sets[2]),
            mod.BatchQuery.ranked(sets[3], k=8),
            mod.BatchQuery.boolean(parse([w[3], "and", w[4]])),
            mod.BatchQuery.count(sets[4])]


def _engines(sym):
    (jc, ji), (tc, ti), sets, words = sym
    return (jbatch.QueryBatch(jc, ji), tbatch.QueryBatch(tc, ti),
            _queries(jbatch, j_parse, sets, words),
            _queries(tbatch, t_parse, sets, words))


@pytest.mark.parametrize("rate", RATES)
def test_sym_query_batch_rows_match_reference(sym, rate):
    ref, port, jq, tq = _engines(sym)
    want = ref._probability_rows(jq, *sym[0])
    got = port._probability_rows(tq, *sym[1][:2])
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-4)
    res = port.execute(tq, rate, rng=np.random.default_rng(3))
    assert len(res) == len(tq) and all(np.isfinite(r.elapsed_s) for r in res)


@pytest.mark.parametrize("rate", RATES)
def test_sym_query_batch_same_rows_same_estimates(sym, rate):
    ref, port, jq, tq = _engines(sym)
    rows = ref._probability_rows(jq, *sym[0])
    ref._probability_rows = lambda *a: rows
    port._probability_rows = lambda *a: rows
    want = ref.execute(jq, rate, rng=np.random.default_rng(7))
    got = port.execute(tq, rate, rng=np.random.default_rng(7))
    for g, w in zip(port.last_report.plan, ref.last_report.plan):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.sample.shard_ids, w.sample.shard_ids)
        if hasattr(w, "scores"):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
            np.testing.assert_array_equal(g.scores, w.scores)
        elif hasattr(w, "doc_ids"):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        else:
            assert g.estimate.value == w.estimate.value


def test_sym_query_batch_census_is_exact(sym):
    ref, port, jq, tq = _engines(sym)
    want = ref.execute(jq, 1.0)
    got = port.execute(tq, 1.0)
    corpus = sym[1][0]
    for q, g, w in zip(tq, got, want):
        if q.kind == "count":
            assert g.estimate.value == w.estimate.value == float(
                corpus.count_phrase(q.phrase))
        else:
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)


# ----------------------------------------------------------------------
# the Hamming megascan through the executor
# ----------------------------------------------------------------------
def _plans(n_queries, n_shards, rng):
    plans = []
    for i in range(n_queries):
        if i % 3 == 0:
            plans.append([int(rng.integers(n_shards))])
        elif i % 3 == 1:
            sub = rng.choice(n_shards, size=max(2, n_shards // 2),
                             replace=False)
            plans.append(sorted(int(s) for s in sub))
        else:
            plans.append(list(range(n_shards)))
    return plans


def test_sym_megascan_spec_signs_on_the_host(sym):
    _, (_, port), sets, _ = sym
    spec = TSpec(port, port.query_vectors(sets))
    assert spec.mode == "hamming"
    np.testing.assert_array_equal(
        spec.queries.numpy(),
        port.query_sig_tensor(port.query_vectors(sets)).numpy())
    with pytest.raises(ValueError):
        TSpec(port, port.query_vectors(sets), ranked_k=5)


def test_sym_megascan_group_equals_per_shard_and_reference(sym):
    (jc, ref), (corpus, port), sets, _ = sym
    plans = _plans(len(sets), corpus.n_shards, np.random.default_rng(7))
    spec = TSpec(port, port.query_vectors(sets))
    fns = spec.scan_fns()
    with TExecutor(workers=2) as ex:
        mega = ex.map_shard_batch(corpus, plans, fns, megakernel=True)
        assert spec.stats["group_launches"] == 1
        assert ex.stats["megascan_jobs"] == 1
        rec = ex.last_job["megascan"]
        assert rec["mode"] == "hamming" and rec["launches"] == 1
        assert rec["flops"] == (3 * len(sets) * rec["real_rows"] * 4
                                + len(sets) * rec["real_rows"])
        per = ex.map_shard_batch(corpus, plans, fns, megakernel=False)
    for g, w in zip(mega, per):
        assert g == w                              # bit for bit
    jspec = JSpec(ref, ref.query_vectors(sets))
    jex = JExecutor(workers=2)
    want = jex.map_shard_batch(jc, plans, jspec.scan_fns(), megakernel=True)
    jex.close()
    for g, w in zip(mega, want):
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[s] for s in g], [w[s] for s in g],
                                   rtol=1e-4)


def test_sym_megascan_equals_fused_planning(sym):
    """The full-fleet Hamming megascan gives the fused doc-granular
    planning's rows: the same per-slot sums over the same rows."""
    _, (corpus, port), sets, _ = sym
    pay = port.megascan_payload(tuple(range(corpus.n_shards)))
    qsig = port.query_sig_tensor(port.query_vectors(sets))
    for db in (False, True):
        got = mops.megascan_segment_sums(pay, qsig, None, port.bits,
                                         mode="hamming",
                                         temperature=port.temperature,
                                         double_buffer=db)
        np.testing.assert_array_equal(got,
                                      port.shard_similarities_batch(sets))
