"""The training data path against the JAX package's: ``LMBatchPipeline``
batches (the final padded batch included, shuffled and given shard
orders), ``SimilaritySampler`` draws, ``Vocab`` / ``HashTokenizer`` ids
all exactly equal; ``PrefetchIterator`` order, error propagation and
``close``; and the similarity curriculum: the JAX package's trained
PV-DBOW vectors and hyperplanes through the port's ``build_index``
give the reference's shard probabilities (rtol 1e-4, the reference's
tolerance for its kernels) and the same drawn shard order."""
import numpy as np
import pytest

from repro.data import pipeline as JP
from repro.data import tokenizer as JT
from repro_torch.core import index as tindex
from repro_torch.core.lsh import LSHConfig
from repro_torch.data import pipeline as TP
from repro_torch.data import tokenizer as TT
from repro_torch.data.store import ShardedCorpus as TCorpus

PROMPT = [3, 5, 9]


@pytest.fixture(scope="module")
def port_corpus(small_corpus):
    """The conftest corpus (the JAX package's store) rebuilt in the
    port's store from the same documents."""
    return TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)


def _batches(pipeline, epochs=(0, 1)):
    return [b for e in epochs for b in pipeline.iter_epoch(e)]


@pytest.mark.parametrize("batch,seq,order", [
    (4, 32, None), (3, 100, None), (5, 17, [2, 0, 0, 7, 1]), (2, 512, [4]),
])
def test_lm_batches_equal_reference(small_corpus, port_corpus, batch, seq,
                                    order):
    want = _batches(JP.LMBatchPipeline(small_corpus, batch, seq,
                                       shard_order=order, seed=3))
    got = _batches(TP.LMBatchPipeline(port_corpus, batch, seq,
                                      shard_order=order, seed=3))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"tokens", "labels", "mask"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == (batch, seq)
            np.testing.assert_array_equal(g[k], w[k])


def test_final_batch_is_padded(small_corpus, port_corpus):
    """Shard 4 (4219 tokens) at 2 x 513 a batch leaves 115 tokens: a
    last batch of 57 tokens a row, padded to 512."""
    got = list(TP.LMBatchPipeline(port_corpus, 2, 512,
                                  shard_order=[4]).iter_epoch())
    want = list(JP.LMBatchPipeline(small_corpus, 2, 512,
                                   shard_order=[4]).iter_epoch())
    last = got[-1]
    assert last["mask"].min() == 0.0 and last["mask"].max() == 1.0
    n = int(last["mask"][0].sum())
    assert np.all(last["tokens"][:, n:] == 0) and np.all(last["labels"][:, n:] == 0)
    for k in last:
        np.testing.assert_array_equal(last[k], want[-1][k])


@pytest.mark.parametrize("seed,n_draws", [(0, None), (5, 100)])
def test_similarity_sampler_draws_equal_reference(seed, n_draws):
    p = np.random.default_rng(1).random(37) ** 3
    want = JP.SimilaritySampler(p, seed=seed).draw_epoch_order(n_draws)
    got = TP.SimilaritySampler(p, seed=seed).draw_epoch_order(n_draws)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        TP.SimilaritySampler(-p)


def test_tokenizer_ids_equal_reference():
    texts = ["The quick brown fox's den, 42 times!", "a b a c the fox",
             "Unseen words: zyzzyva and qwxp"]
    jv, tv = JT.Vocab.build(texts[:2]), TT.Vocab.build(texts[:2])
    assert [tv.word(i) for i in range(len(tv))] == \
        [jv.word(i) for i in range(len(jv))]
    jt, tt_ = JT.HashTokenizer(jv, 64), TT.HashTokenizer(tv, 64)
    assert tt_.vocab_size == jt.vocab_size
    for t in texts:
        assert TT.simple_word_split(t) == JT.simple_word_split(t)
        np.testing.assert_array_equal(tt_.encode(t), jt.encode(t))
        assert tt_.encode(t).dtype == np.int32


def test_prefetch_iterator_order_errors_and_close():
    assert list(TP.PrefetchIterator(iter(range(20)), depth=3)) == list(range(20))

    def failing():
        yield 1
        raise KeyError("boom")
    it = TP.PrefetchIterator(failing())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)

    def endless():
        while True:
            yield np.zeros(4)
    it = TP.PrefetchIterator(endless(), depth=2)
    next(it)
    it.close(timeout=5.0)
    assert not it._thread.is_alive()


def test_similarity_order_equals_reference(small_corpus, port_corpus,
                                           pv_model, built_index):
    """The reference's trained vectors and planes through the port's
    shard-granular index on the CPU: the prompt's shard probabilities
    and the sampler's epoch order equal the reference's."""
    model, pcfg = pv_model
    model_np = type("Model", (), dict(word_vecs=np.asarray(model.word_vecs),
                                      doc_vecs=np.asarray(model.doc_vecs)))
    index = tindex.build_index(port_corpus, model_np, LSHConfig(bits=128),
                               temperature=pcfg.temperature,
                               planes=built_index.planes, device="cpu")
    want = built_index.shard_probabilities(PROMPT)
    got = index.shard_probabilities(PROMPT)
    assert got.shape == want.shape == (small_corpus.n_shards,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for seed in range(3):
        np.testing.assert_array_equal(
            TP.SimilaritySampler(got, seed=seed).draw_epoch_order(),
            JP.SimilaritySampler(want, seed=seed).draw_epoch_order())
