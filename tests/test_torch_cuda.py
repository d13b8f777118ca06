"""The port's CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs an NVIDIA GPU and skips without one;
the file imports no JAX, so it runs on a machine that has only the
port: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerance rtol=1e-4, as for the reference's own fused kernels."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import lsh
from repro_torch.core.index import build_index
from repro_torch.data.corpus import SyntheticCorpusConfig, generate_text_corpus
from repro_torch.data.store import ShardedCorpus
from repro_torch.kernels.asym import kernel as tkernel
from repro_torch.kernels.asym import ops as tops
from repro_torch.kernels.asym import ref as tref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(b, m, dim, bits, seed, device):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.normal(size=(m, dim)).astype(np.float32)).to(device)
    planes = lsh.hyperplanes(lsh.LSHConfig(bits=bits), dim, device)
    db = lsh.pack_bits(lsh.signature_bits(x, planes))
    return rng, q, planes, db


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,s,dim,bits,temp", [
    (1, 7, 3, 24, 128, 1.0), (5, 613, 37, 48, 128, 8.0),
    (9, 300, 128, 32, 64, 4.0), (3, 1000, 5, 48, 256, 8.0),
    (48, 20000, 800, 64, 256, 8.0),
])
def test_cuda_kernels_match_plain(cuda_device, b, m, s, dim, bits, temp):
    rng, q, planes, db = _setup(b, m, dim, bits, b + m, cuda_device)
    n_sim = tkernel.asym_similarity_kernel.launches
    n_seg = tkernel.asym_segment_sum_kernel.launches
    sim = tops.asym_exp_similarity(q, db, planes, bits, temperature=temp)
    assert torch.equal(sim, tops.asym_exp_similarity(q, db, planes, bits,
                                                     temperature=temp))
    want = tref.asym_exp_similarity_ref(q, db, planes, bits, temp)
    torch.testing.assert_close(sim, want, rtol=1e-4, atol=0)
    seg = torch.from_numpy(rng.integers(-1, s + 2, m)).to(cuda_device)
    got = tops.asym_exp_segment_sum(q, db, planes, bits, seg, s,
                                    temperature=temp)
    again = tops.asym_exp_segment_sum(q, db, planes, bits, seg, s,
                                      temperature=temp)
    torch.cuda.synchronize()
    assert torch.equal(got, again)            # bitwise run to run
    want = tref.asym_exp_segment_sum_ref(q, db, planes, bits, seg, s, temp)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    assert tkernel.asym_similarity_kernel.launches == n_sim + 2
    assert tkernel.asym_segment_sum_kernel.launches == n_seg + 2


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_operands(cuda_device):
    _, q, planes, db = _setup(2, 10, 16, 64, 0, cuda_device)
    with pytest.raises(TypeError):
        tkernel.asym_similarity_kernel(q.double(), planes, db, 64)
    with pytest.raises(ValueError):
        tkernel.asym_similarity_kernel(q, planes, db, 96)
    with pytest.raises(ValueError):
        tops.asym_exp_similarity(q.cpu(), db, planes, 64)


@pytest.mark.cuda
def test_cuda_index_scores_through_the_kernels(cuda_device):
    """An index built with the default device scores every LSH query
    through the kernels, and agrees with the same index on the CPU."""
    cfg = SyntheticCorpusConfig(n_docs=80, vocab_size=300, n_topics=4, seed=0)
    docs, _ = generate_text_corpus(cfg)
    corpus = ShardedCorpus.from_documents(docs, cfg.vocab_size,
                                          shard_tokens=1024)
    rng = np.random.default_rng(0)
    model = SimpleNamespace(
        word_vecs=rng.normal(size=(cfg.vocab_size, 16)).astype(np.float32),
        doc_vecs=rng.normal(size=(corpus.n_docs, 16)).astype(np.float32))
    idx = build_index(corpus, model, lsh.LSHConfig(bits=64),
                      granularity="doc")
    assert idx.device.type == "cuda"
    cpu = dataclasses.replace(idx, device="cpu")
    queries, words = [[3, 5, 9], [2], [10, 11]], [1, 2, 5, 17]
    n_sim = tkernel.asym_similarity_kernel.launches
    n_seg = tkernel.asym_segment_sum_kernel.launches
    rows = idx.shard_similarities_batch(queries)
    w_rows = idx.word_shard_similarities_batch(words)
    single = idx.shard_similarities(queries[0])
    assert tkernel.asym_segment_sum_kernel.launches == n_seg + 1
    assert tkernel.asym_similarity_kernel.launches == n_sim + 2
    np.testing.assert_allclose(rows, cpu.shard_similarities_batch(queries),
                               rtol=1e-4)
    np.testing.assert_allclose(w_rows, cpu.word_shard_similarities_batch(words),
                               rtol=1e-4)
    np.testing.assert_allclose(single, cpu.shard_similarities(queries[0]),
                               rtol=1e-4)
