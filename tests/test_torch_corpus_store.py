"""The port's corpus generator, sharded store, sampling and statistics
copies against the JAX package's numpy originals: same seed, same bits."""
import numpy as np
import pytest

from repro.core import sampling as jsamp
from repro.data import corpus as jcorpus
from repro.data import store as jstore
from repro.utils import stats as jstats
from repro_torch.core import sampling as tsamp
from repro_torch.data import corpus as tcorpus
from repro_torch.data import store as tstore
from repro_torch.utils import stats as tstats

CFG = dict(n_docs=300, vocab_size=512, n_topics=8, seed=3)


def _both(**over):
    kw = dict(CFG, **over)
    return (jcorpus.generate_text_corpus(jcorpus.SyntheticCorpusConfig(**kw)),
            tcorpus.generate_text_corpus(tcorpus.SyntheticCorpusConfig(**kw)))


@pytest.mark.parametrize("chunk", [97, 1 << 22])
@pytest.mark.parametrize("locality", [0.85, 0.0])
def test_generate_text_corpus_bit_identical(monkeypatch, chunk, locality):
    monkeypatch.setattr(tcorpus, "_TOPIC_CHUNK", chunk)
    (jdocs, jtop), (tdocs, ttop) = _both(topic_locality=locality)
    np.testing.assert_array_equal(ttop, jtop)
    assert len(tdocs) == len(jdocs)
    for a, b in zip(tdocs, jdocs):
        assert a.doc_id == b.doc_id
        assert a.tokens.dtype == b.tokens.dtype
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_sharded_corpus_and_postings_identical():
    (jdocs, _), (tdocs, _) = _both()
    jc = jstore.ShardedCorpus.from_documents(jdocs, 512, shard_tokens=2048)
    tc = tstore.ShardedCorpus.from_documents(tdocs, 512, shard_tokens=2048)
    assert (tc.n_shards, tc.n_docs, tc.n_tokens) == (jc.n_shards, jc.n_docs,
                                                     jc.n_tokens)
    np.testing.assert_array_equal(tc.doc_shard_map(), jc.doc_shard_map())
    np.testing.assert_array_equal(tc.shard_doc_counts(), jc.shard_doc_counts())
    for ts, js in zip(tc.shards, jc.shards):
        for name in ("tokens", "offsets", "doc_ids"):
            np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
        tp, jp = tstore.shard_postings(ts), jstore.shard_postings(js)
        for name in ("indptr", "doc_idx", "tf"):
            np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
        assert tstore.shard_postings(ts) is tp        # cached on the shard
    for phrase in ([5], [7, 2], [1, 2, 3]):
        assert tc.count_phrase(phrase) == jc.count_phrase(phrase)


def test_corpus_save_load_across_packages(tmp_path):
    (jdocs, _), (tdocs, _) = _both()
    tc = tstore.ShardedCorpus.from_documents(tdocs, 512, shard_tokens=2048)
    path = str(tmp_path / "c.npz")
    tc.save(path)
    back = jstore.ShardedCorpus.load(path)
    assert back.n_docs == tc.n_docs and back.vocab_size == 512
    again = tstore.ShardedCorpus.load(path)
    np.testing.assert_array_equal(again.shards[1].tokens, tc.shards[1].tokens)
    assert again.shards[1]._postings is not None


def test_segment_sum_by_offsets_matches():
    rng = np.random.default_rng(0)
    offsets = np.array([0, 0, 3, 3, 7, 10, 10], np.int64)   # empty docs
    vals = rng.integers(0, 9, 10)
    np.testing.assert_array_equal(tstore.segment_sum_by_offsets(vals, offsets),
                                  jstore.segment_sum_by_offsets(vals, offsets))


@pytest.mark.parametrize("rate", [0.05, 0.3, 1.5])
def test_samplers_and_estimators_identical(rate):
    p = np.random.default_rng(1).gamma(0.5, size=40)
    probs = tsamp.similarity_probabilities(p)
    np.testing.assert_array_equal(probs, jsamp.similarity_probabilities(p))
    for fn in ("pps_sample", "pps_sample_distinct"):
        a = getattr(tsamp, fn)(probs, rate, np.random.default_rng(9))
        b = getattr(jsamp, fn)(probs, rate, np.random.default_rng(9))
        np.testing.assert_array_equal(a.shard_ids, b.shard_ids)
    s = tsamp.pps_sample(probs, rate, np.random.default_rng(9))
    local = np.arange(len(s.shard_ids), dtype=np.float64)
    js = jsamp.SampleResult(s.shard_ids, s.probabilities, s.rate)
    assert tuple(tsamp.ht_estimate(local, s)) == tuple(jsamp.ht_estimate(local, js))
    assert (tuple(tsamp.bootstrap_estimate(local, s))
            == tuple(jsamp.bootstrap_estimate(local, js)))


@pytest.mark.parametrize("df", [1, 2, 5, 30])
def test_t_critical_values_identical(df):
    assert tstats.t_critical_value(df, 0.95) == jstats.t_critical_value(df, 0.95)
