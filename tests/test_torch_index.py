"""The port's ApproxIndex against the JAX package's on the same state.

A JAX-built doc-granular kernel index is saved and loaded by the port
(``ApproxIndex.load``), and the serving interface — fused and unfused
shard similarities, Boolean word x shard rows, query signatures — is
compared with the reference's (whose Pallas kernels run in interpret
mode here).  ``build_index`` from the same model vectors and planes
gives the reference's signatures exactly.  Tolerance rtol=1e-4, as the
reference holds its fused kernels to."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.index import ApproxIndex as JIndex
from repro_torch.core import index as tindex
from repro_torch.core.lsh import LSHConfig
from repro_torch.data.store import ShardedCorpus as TCorpus
from repro_torch.kernels.asym import kernel as tkernel

QUERIES = [[3, 5, 9], [2], [10, 11], [7, 4, 5, 6]]
WORDS = [1, 2, 5, 17, 40]


@pytest.fixture(scope="module")
def pair(small_corpus, built_index, tmp_path_factory):
    """(reference doc-granular kernel index, the port's load of it)."""
    ref = dataclasses.replace(built_index, granularity="doc",
                              use_kernel=True).attach_corpus(small_corpus)
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    ref.save(path)
    return ref, tindex.ApproxIndex.load(path, device="cpu")


def test_load_carries_every_field(pair):
    ref, port = pair
    for name in ("word_vecs", "shard_vecs", "doc_vecs", "planes", "word_sig",
                 "shard_sig", "doc_sig", "doc_freq", "_doc_shard_ids",
                 "center_mean"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    for name in ("bits", "n_docs", "avg_doc_len", "use_lsh",
                 "lsh_mode", "granularity", "temperature"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_shard_similarities_batch_match(pair, fused):
    ref, port = pair
    want = ref.shard_similarities_batch(QUERIES, fused=fused)
    got = port.shard_similarities_batch(QUERIES, fused=fused)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_fused_matches_unfused_and_single_query(pair):
    _, port = pair
    fused = port.shard_similarities_batch(QUERIES, fused=True)
    np.testing.assert_allclose(
        fused, port.shard_similarities_batch(QUERIES, fused=False), rtol=1e-4)
    singles = np.stack([port.shard_similarities(q) for q in QUERIES])
    np.testing.assert_allclose(fused, singles, rtol=1e-4)
    np.testing.assert_allclose(
        port.shard_probabilities(QUERIES[0]),
        pair[0].shard_probabilities(QUERIES[0]), rtol=1e-4)


def test_word_shard_rows_and_signatures_match(pair):
    ref, port = pair
    np.testing.assert_allclose(port.word_shard_similarities_batch(WORDS),
                               ref.word_shard_similarities_batch(WORDS),
                               rtol=1e-4)
    np.testing.assert_allclose(port.word_shard_similarity(WORDS[1]),
                               ref.word_shard_similarity(WORDS[1]), rtol=1e-4)
    vecs = ref.query_vectors(QUERIES)
    np.testing.assert_array_equal(port.query_vectors(QUERIES), vecs)
    np.testing.assert_array_equal(port.query_signatures(vecs),
                                  ref.query_signatures(vecs))


@pytest.mark.parametrize("use_lsh,use_kernel", [(True, False), (False, False)])
def test_numpy_scoring_paths_match(pair, use_lsh, use_kernel):
    """The reference's numpy scoring (``use_kernel=False``) against the
    port's CPU index, which has no such flag: its LSH route is always
    the kernels' plain versions on the CPU."""
    ref, port = pair
    r = dataclasses.replace(ref, use_lsh=use_lsh, use_kernel=use_kernel)
    p = dataclasses.replace(port, use_lsh=use_lsh)
    np.testing.assert_allclose(p.shard_similarities_batch(QUERIES),
                               r.shard_similarities_batch(QUERIES), rtol=1e-6)


def test_from_arrays_and_round_trip(pair, tmp_path):
    ref, port = pair
    path = str(tmp_path / "port.npz")
    port.save(path)
    back = JIndex.load(path)                  # the reference reads it
    np.testing.assert_array_equal(back.doc_sig, ref.doc_sig)
    assert back.granularity == "doc" and back.use_kernel
    with np.load(path) as z:
        import json
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    again = tindex.ApproxIndex.from_arrays(arrays, meta, device="cpu")
    np.testing.assert_array_equal(
        again.shard_similarities_batch(QUERIES),
        port.shard_similarities_batch(QUERIES))


@pytest.mark.parametrize("flag", [False, True])
def test_meta_use_kernel_does_not_pick_the_route(pair, tmp_path, flag):
    """A JAX file saved with either ``use_kernel`` loads to an index that
    scores the same way: the device alone picks plain or kernel."""
    ref, port = pair
    path = str(tmp_path / "ref.npz")
    dataclasses.replace(ref, use_kernel=flag).save(path)
    got = tindex.ApproxIndex.load(path, device="cpu")
    assert not hasattr(got, "use_kernel")
    n = tkernel.asym_segment_sum_kernel.launches
    np.testing.assert_array_equal(got.shard_similarities_batch(QUERIES),
                                  port.shard_similarities_batch(QUERIES))
    assert tkernel.asym_segment_sum_kernel.launches == n


def test_device_cache_built_once_and_dropped_on_attach(pair, small_corpus):
    _, port = pair
    idx = dataclasses.replace(port)
    idx.attach_corpus(small_corpus)
    before = idx.clock.current().content
    idx.shard_similarities_batch(QUERIES)
    dev = idx._fused_device_arrays()
    assert dev["sig"].dtype == torch.int32 and dev["sig"].device.type == "cpu"
    offs = dev["offsets"]
    assert offs.dtype == torch.int32 and offs.shape == (small_corpus.n_shards + 1,)
    assert int(offs[-1]) == small_corpus.n_docs
    assert idx._fused_device_arrays() is dev
    idx.attach_corpus(small_corpus)
    assert not hasattr(idx, "_dev")
    assert idx.clock.current().content == before + 1


def test_cpu_index_launches_no_kernel(pair):
    _, port = pair
    n = (tkernel.asym_similarity_kernel.launches,
         tkernel.asym_segment_sum_kernel.launches)
    port.shard_similarities_batch(QUERIES)
    port.word_shard_similarities_batch(WORDS)
    assert (tkernel.asym_similarity_kernel.launches,
            tkernel.asym_segment_sum_kernel.launches) == n


def test_sym_mode_is_refused(pair):
    """Sym mode answers on the planning and top-k entry points, fused
    or not, through the Hamming kernels (``tests/test_torch_sym.py``
    holds it to the reference)."""
    _, port = pair
    sym = dataclasses.replace(port, lsh_mode="sym")
    fused = sym.shard_similarities_batch(QUERIES)
    assert fused.shape == (len(QUERIES), port.shard_vecs.shape[0])
    assert np.all(np.isfinite(fused)) and np.all(fused > 0)
    np.testing.assert_allclose(
        fused, sym.shard_similarities_batch(QUERIES, fused=False), rtol=1e-5)
    ids, vals = sym.topk_doc_similarities_batch(QUERIES, k=4)
    assert ids.shape == vals.shape == (len(QUERIES), 4)
    assert np.all(np.diff(vals, axis=1) <= 0)


def test_build_index_matches_reference_signatures(small_corpus, pv_model,
                                                  built_index):
    model, pcfg = pv_model
    corpus = TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)
    model_np = type("Model", (), dict(word_vecs=np.asarray(model.word_vecs),
                                      doc_vecs=np.asarray(model.doc_vecs)))
    got = tindex.build_index(corpus, model_np, LSHConfig(bits=128),
                             temperature=pcfg.temperature,
                             planes=built_index.planes, device="cpu")
    for name in ("word_vecs", "doc_vecs", "shard_vecs", "center_mean",
                 "planes", "word_sig", "shard_sig", "doc_sig", "doc_freq"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(built_index, name), err_msg=name)
    assert got.n_docs == built_index.n_docs
    assert got.avg_doc_len == built_index.avg_doc_len
    doc = tindex.build_index(corpus, model_np, LSHConfig(bits=128),
                             planes=built_index.planes, granularity="doc",
                             device="cpu")
    np.testing.assert_array_equal(doc._doc_shard_ids,
                                  small_corpus.doc_shard_map())


def test_build_index_draws_seeded_planes(small_corpus, pv_model):
    model, _ = pv_model
    model_np = type("Model", (), dict(word_vecs=np.asarray(model.word_vecs),
                                      doc_vecs=np.asarray(model.doc_vecs)))
    a = tindex.build_index(small_corpus, model_np, LSHConfig(bits=64, seed=2),
                           device="cpu")
    b = tindex.build_index(small_corpus, model_np, LSHConfig(bits=64, seed=2),
                           device="cpu")
    np.testing.assert_array_equal(a.planes, b.planes)
    np.testing.assert_array_equal(a.doc_sig, b.doc_sig)
    assert a.doc_sig.dtype == np.uint32 and a.doc_sig.shape[1] == 2
