"""A refreshed (grown) index on the card.  After an append with a
spill and ``refresh_appended``, the new index plans through row 2 over
its new arrays, scores words through row 1 and runs a megascan over the
touched shards through row 7, each against its plain version
(rtol=1e-4).  Needs an NVIDIA GPU and skips without one; imports no
JAX: ``python -m pytest -q -m cuda tests/test_torch_cuda*.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import lsh
from repro_torch.core.index import build_index
from repro_torch.data.corpus import SyntheticCorpusConfig, generate_text_corpus
from repro_torch.data.store import ShardedCorpus
from repro_torch.kernels.asym import kernel as tkernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_refreshed_index_scores_through_the_kernels(cuda_device):
    """Build on the card, plan once (device caches built), append with a
    spill and refresh: the new index plans through row 2 over its new
    arrays and scores words (row 1) and a megascan over the touched
    shards (row 7), each against its plain version (rtol 1e-4), and the
    megascan group route equals the per-shard route bit for bit."""
    from repro_torch.core import pv_dbow
    from repro_torch.core.index import refresh_appended
    from repro_torch.kernels.asym import ref as aref
    from repro_torch.kernels.megascan import MegascanSpec
    from repro_torch.kernels.megascan import kernel as mker
    from repro_torch.runtime.executor import ShardTaskExecutor

    cfg = SyntheticCorpusConfig(n_docs=400, vocab_size=512, n_topics=4,
                                seed=3)
    docs, _ = generate_text_corpus(cfg)
    corpus = ShardedCorpus.from_documents(docs, cfg.vocab_size,
                                          shard_tokens=2048)
    rng = np.random.default_rng(3)
    model = pv_dbow.model_from_arrays(
        rng.normal(size=(cfg.vocab_size, 32)).astype(np.float32),
        rng.normal(size=(corpus.n_docs, 32)).astype(np.float32),
        cuda_device)
    pcfg = pv_dbow.PVDBOWConfig(dim=32, lr=0.01, temperature=8.0, seed=2)
    idx = build_index(corpus, model, lsh.LSHConfig(bits=128),
                      granularity="doc").attach_corpus(corpus)
    queries = [[3, 5, 9], [2], [10, 11, 40]]
    idx.shard_similarities_batch(queries)
    extra = [rng.integers(0, cfg.vocab_size, 60).astype(np.int32)
             for _ in range(50)]
    grown, _, affected = corpus.append_documents(extra, shard_tokens=2048)
    assert grown.n_shards > corpus.n_shards
    new = refresh_appended(idx, grown, model, pcfg, extra, affected,
                           infer_steps=4)
    assert new.device.type == "cuda" and getattr(new, "_dev", None) is None
    n_seg = tkernel.asym_segment_sum_kernel.launches
    n_sim = tkernel.asym_similarity_kernel.launches
    rows = new.shard_similarities_batch(queries)
    w_rows = new.word_shard_similarities_batch([1, 2, 5])
    assert tkernel.asym_segment_sum_kernel.launches == n_seg + 1
    assert tkernel.asym_similarity_kernel.launches == n_sim + 1
    seg = np.asarray(grown.doc_shard_map())
    order = np.argsort(seg, kind="stable")
    planes = torch.as_tensor(new.planes, device=cuda_device)
    want = aref.asym_exp_segment_sum_ref(
        torch.as_tensor(new.query_vectors(queries), device=cuda_device),
        lsh.to_packed_tensor(new.doc_sig[order], cuda_device), planes,
        new.bits, torch.as_tensor(seg[order].astype(np.int32),
                                  device=cuda_device),
        grown.n_shards, new.temperature).cpu().numpy()
    np.testing.assert_allclose(rows, want, rtol=1e-4)
    cpu = dataclasses.replace(new, device="cpu")
    np.testing.assert_allclose(w_rows, cpu.word_shard_similarities_batch(
        [1, 2, 5]), rtol=1e-4)
    touched = sorted(set(affected) | set(range(corpus.n_shards,
                                               grown.n_shards)))
    spec = MegascanSpec(new, new.query_vectors(queries))
    plans = [touched] * len(queries)
    n_mega = mker.asym_megascan_segsum_kernel.launches
    with ShardTaskExecutor(workers=2) as ex:
        group = ex.map_shard_batch(grown, plans, spec.scan_fns(),
                                   megakernel=True)
        assert mker.asym_megascan_segsum_kernel.launches == n_mega + 1
        per = ex.map_shard_batch(grown, plans, spec.scan_fns(),
                                 megakernel=False)
    assert group == per
    dense = np.asarray([[g[s] for s in touched] for g in group])
    np.testing.assert_allclose(dense, want[:, touched], rtol=1e-4)
