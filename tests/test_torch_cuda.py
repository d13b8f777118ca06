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
from repro_torch.testing import (KMEANS_SHAPES, NEGSAMP_SHAPES, SELECT_KS,
                                 assert_assign_away_from_ties,
                                 assert_ids_equal_away_from_ties,
                                 block_slots, hamming_warp_sums,
                                 ragged_segments, select_counts,
                                 topk_candidates_from_scores)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(b, m, dim, bits, seed, device, dup=False):
    """Queries, planes and packed rows from ``seed``; ``dup`` makes every
    odd row a copy of the even row before it (exact value ties)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(device)
    x = rng.normal(size=(m, dim)).astype(np.float32)
    if dup:
        x[1::2] = x[0::2][:m // 2]
    x = torch.from_numpy(x).to(device)
    planes = lsh.hyperplanes(lsh.LSHConfig(bits=bits), dim, device)
    db = lsh.pack_bits(lsh.signature_bits(x, planes))
    return rng, q, planes, db


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,s,dim,bits,temp", [
    (1, 7, 3, 24, 128, 1.0), (5, 613, 37, 48, 128, 8.0),
    (9, 300, 128, 32, 64, 4.0), (3, 1000, 5, 48, 256, 8.0),
    (48, 20000, 800, 64, 256, 8.0),
    # partly filled query tiles and bits 512 (row 2's table lookup);
    # dim 30 takes the projection's 4-byte loads
    (12, 4000, 150, 64, 256, 8.0), (1, 2000, 77, 64, 512, 8.0),
    (9, 3000, 100, 48, 512, 4.0), (12, 700, 20, 64, 512, 1.0),
    (12, 900, 40, 30, 96, 8.0),
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
@pytest.mark.parametrize("b", [1, 9, 48])
@pytest.mark.parametrize("m,dim,bits", [
    (7, 64, 256), (31, 64, 64), (1537, 64, 256), (2049, 48, 512),
    (3000, 30, 256), (39983, 64, 256), (300001, 64, 64),
])
def test_cuda_similarity_row_walk_matches_top_k_values(cuda_device, b, m,
                                                       dim, bits):
    """Row 1 where its row walk has edges: M under a warp, M off the
    block stride (SIM_ROWS rows a thread), several strides (the largest
    M), dim 30 (the projection's 4-byte loads), bits 64/256/512.  Within
    rtol 1e-4 of the plain version, bitwise run to run, and bit for bit
    the top-k kernel's values at its candidates: the two score one chain
    (doc_dots), which the top-k oracle relies on."""
    _, q, planes, db = _setup(b, m, dim, bits, b + m + bits, cuda_device)
    qn = tops._prep_queries(q)
    n = tkernel.asym_similarity_kernel.launches
    got = tkernel.asym_similarity_kernel(qn, planes, db, bits,
                                         temperature=8.0)
    again = tkernel.asym_similarity_kernel(qn, planes, db, bits,
                                           temperature=8.0)
    torch.cuda.synchronize()
    assert tkernel.asym_similarity_kernel.launches == n + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, tref.asym_exp_similarity_ref(q, db, planes, bits, 8.0),
        rtol=1e-4, atol=1e-6)
    vals, idx = tkernel.asym_topk_kernel(qn, planes, db, bits, min(10, m),
                                         temperature=8.0)
    real = torch.isfinite(vals)
    at = torch.gather(got, 1, idx.long().clamp(max=m - 1))
    assert bool(real.any()) and torch.equal(vals[real], at[real])


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


# ----------------------------------------------------------------------
# slice 2: the fused top-k and the megascan kernels
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,dim,bits,temp", [
    (3, 257, 10, 48, 128, 8.0), (5, 100, 100, 32, 64, 4.0),
    (2, 700, 300, 24, 128, 1.0), (2, 50, 7, 24, 64, 2.0),
    (48, 20000, 10, 64, 256, 8.0),
])
def test_cuda_topk_matches_plain(cuda_device, b, m, k, dim, bits, temp):
    _, q, planes, db = _setup(b, m, dim, bits, b + m + k, cuda_device)
    n = tkernel.asym_topk_kernel.launches
    idx, vals = tops.asym_exp_topk(q, db, planes, bits, k, temperature=temp)
    idx2, vals2 = tops.asym_exp_topk(q, db, planes, bits, k,
                                     temperature=temp)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx2) and torch.equal(vals, vals2)
    assert tkernel.asym_topk_kernel.launches == n + 2
    qn = tops._prep_queries(q)
    kk = min(k, m)
    cv, ci = tkernel.asym_topk_kernel(qn, planes, db, bits, kk,
                                      temperature=temp)
    rv, ri = tref.asym_topk_candidates_ref(qn, db, planes, bits, kk,
                                           tkernel.topk_tile(kk), temp)
    torch.testing.assert_close(cv, rv, rtol=1e-4, atol=0)
    assert_ids_equal_away_from_ties(ci, ri, rv)
    ridx, rvals = tref.asym_exp_topk_ref(qn, db, planes, bits, k, temp)
    torch.testing.assert_close(vals, rvals, rtol=1e-4, atol=0)
    assert_ids_equal_away_from_ties(idx, ridx, rvals)


RAGGED = (13, 8, 1, 0, 27, 64, 5)
# slots of 0, 1, 26 (the serving size), 33 and 300 rows
SLOT_SIZES = (0, 1, 26, 33, 300, 26, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("counts,tm,dup,b,bits", [
    (RAGGED, 8, False, 5, 64), (RAGGED, 16, False, 5, 64),
    ((300, 40, 9), 256, False, 5, 64), (RAGGED, 16, True, 5, 64),
    # row 7's table lookup: partly filled query tiles, bits 512
    (SLOT_SIZES, 32, False, 1, 256), (SLOT_SIZES, 32, False, 9, 512),
    (SLOT_SIZES, 256, False, 12, 256), (SLOT_SIZES * 40, 32, False, 32, 256),
    (SLOT_SIZES, 64, True, 12, 512),
])
def test_cuda_megascan_matches_plain_and_is_bitwise(cuda_device, counts, tm,
                                                    dup, b, bits):
    from repro_torch.kernels.megascan import kernel as mker
    from repro_torch.kernels.megascan import ops as mops
    from repro_torch.kernels.megascan import ref as mref
    segs, q, planes = ragged_segments(counts, 16, bits, tm + len(counts), dup,
                                      n_queries=b)
    pay = mops.build_payload(segs, tm=tm, device=cuda_device)
    n_sum = mker.asym_megascan_segsum_kernel.launches
    n_top = mker.asym_megascan_topk_kernel.launches
    got = mops.megascan_segment_sums(pay, q, planes, bits, temperature=4.0)
    assert np.array_equal(got, mops.megascan_segment_sums(
        pay, q, planes, bits, temperature=4.0))          # run to run
    streamed = mops.megascan_segment_sums(pay, q, planes, bits,
                                          temperature=4.0,
                                          double_buffer=False)
    assert np.array_equal(got, streamed)                  # schedules
    qn = tops._prep_queries(torch.from_numpy(q).to(cuda_device))
    tp = torch.from_numpy(planes).to(cuda_device)
    want = mref.asym_megascan_segsum_ref(qn, pay.sig, tp, bits,
                                         pay.row_start, pay.row_count, 4.0)
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-4)
    assert (got[:, np.asarray(counts) == 0] == 0).all()
    ids, vals = mops.megascan_topk(pay, q, planes, bits, 5, temperature=4.0)
    ids2, vals2 = mops.megascan_topk(pay, q, planes, bits, 5,
                                     temperature=4.0)
    assert np.array_equal(ids, ids2) and np.array_equal(vals, vals2)
    cpu = mops.build_payload(segs, tm=tm, device="cpu")
    rids, rvals = mops.megascan_topk(cpu, q, planes, bits, 5,
                                     temperature=4.0)
    finite = np.isfinite(rvals)
    assert np.array_equal(np.isfinite(vals), finite)
    np.testing.assert_allclose(vals[finite], rvals[finite], rtol=1e-4)
    for s in range(len(counts)):
        assert_ids_equal_away_from_ties(torch.from_numpy(ids[:, s]),
                                  torch.from_numpy(rids[:, s]),
                                  torch.from_numpy(rvals[:, s]))
    assert mker.asym_megascan_segsum_kernel.launches == n_sum + 2
    assert mker.asym_megascan_topk_kernel.launches == n_top + 2
    # group == single-shard payload, bit for bit, in both modes
    for s, seg in enumerate(segs[:16]):
        one = mops.build_payload([seg], tm=tm, device=cuda_device)
        single = mops.megascan_segment_sums(one, q, planes, bits,
                                            temperature=4.0)
        assert np.array_equal(got[:, s], single[:, 0])
        i1, v1 = mops.megascan_topk(one, q, planes, bits, 5, temperature=4.0)
        assert np.array_equal(ids[:, s], i1[:, 0])
        assert np.array_equal(vals[:, s], v1[:, 0])


@pytest.mark.cuda
def test_cuda_segment_sums_refuse_tables_that_do_not_fit(cuda_device):
    """Rows 2 and 7 raise, naming the bytes, where a block's lookup
    tables do not fit the device's shared memory (bits 2048: 320 KB)."""
    from repro_torch.kernels.megascan import kernel as mker
    _, q, planes, db = _setup(3, 50, 16, 2048, 0, cuda_device)
    qn = tops._prep_queries(q)
    offs = torch.tensor([0, 20, 50], dtype=torch.int32, device=cuda_device)
    n = (tkernel.asym_segment_sum_kernel.launches,
         mker.asym_megascan_segsum_kernel.launches)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tkernel.asym_segment_sum_kernel(qn, planes, db, offs, 2048)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        mker.asym_megascan_segsum_kernel(qn, planes, db, offs[:2].contiguous(),
                                         offs[1:].contiguous(), 2048)
    assert n == (tkernel.asym_segment_sum_kernel.launches,
                 mker.asym_megascan_segsum_kernel.launches)
    # the CPU route takes any size
    cpu = tops.asym_exp_segment_sum_csr(q.cpu(), db.cpu(), planes.cpu(), 2048,
                                        offs.cpu())
    assert cpu.shape == (3, 2) and bool(torch.isfinite(cpu).all())


def _hold_candidates(got, again, exact, plain, what):
    """Top-k candidates (values, ids): bitwise run to run, bitwise the
    oracle over the similarity kernel's scores, and within rtol=1e-4 of
    the plain version with ids equal away from near-ties."""
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), (
        f"{what}: not bitwise repeatable")
    assert torch.equal(got[0], exact[0]), f"{what}: values != oracle"
    assert torch.equal(got[1], exact[1]), f"{what}: ids != oracle"
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(plain[0]))
    fin = torch.isfinite(plain[0])
    torch.testing.assert_close(got[0][fin], plain[0][fin], rtol=1e-4, atol=0)
    assert_ids_equal_away_from_ties(got[1], plain[1], plain[0], what)


TOPK_SELECT = [(k, c) for k in SELECT_KS
               for c in select_counts(k, tkernel.topk_tile(k), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("k,last", TOPK_SELECT)
def test_cuda_topk_selection_is_exact(cuda_device, k, last, dup):
    """Row 3 over two tiles, the last with ``last`` docs (M ragged
    unless it is full), B=9 (a partial query tile), k on both sides of
    the warp selection."""
    tm = tkernel.topk_tile(k)
    _, q, planes, db = _setup(9, tm + last, 16, 64, k * 1000 + last,
                              cuda_device, dup)
    qn = tops._prep_queries(q)
    got = tkernel.asym_topk_kernel(qn, planes, db, 64, k, temperature=4.0)
    again = tkernel.asym_topk_kernel(qn, planes, db, 64, k, temperature=4.0)
    scores = tkernel.asym_similarity_kernel(qn, planes, db, 64,
                                            temperature=4.0)
    plain = tref.asym_topk_candidates_ref(qn, db, planes, 64, k, tm, 4.0)
    _hold_candidates(got, again, topk_candidates_from_scores(scores, k, tm),
                     plain, f"k={k} last={last} dup={dup}")


MEGA_SELECT = [(k, tm, scattered) for k in SELECT_KS for tm in (256, 512)
               if (tm == 256) == (k <= 256) for scattered in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("k,tm,scattered", MEGA_SELECT)
def test_cuda_megascan_topk_selection_is_exact(cuda_device, k, tm,
                                               scattered, dup):
    """Rows 9/10: one payload block per valid-row count (0, 1, k-1, k,
    k+1, 32, 33, 256), the valid rows first (the payload's layout) or
    scattered over the block, B=9."""
    from repro_torch.kernels.megascan import kernel as mker
    from repro_torch.kernels.megascan import ref as mref
    counts = select_counts(k, tm)
    rng, q, planes, sig = _setup(9, len(counts) * tm, 16, 64, k + tm,
                                 cuda_device, dup)
    qn = tops._prep_queries(q)
    slots = torch.from_numpy(block_slots(counts, tm, 5, scattered, rng)).to(
        cuda_device)
    got = mker.asym_megascan_topk_kernel(qn, planes, sig, slots, 64, k, 5, tm,
                                         temperature=4.0)
    again = mker.asym_megascan_topk_kernel(qn, planes, sig, slots, 64, k, 5,
                                           tm, temperature=4.0)
    scores = tkernel.asym_similarity_kernel(qn, planes, sig, 64,
                                            temperature=4.0)
    plain = mref.asym_megascan_topk_ref(qn, sig, slots, planes, 64, k, 5, tm,
                                        4.0)
    _hold_candidates(got, again,
                     topk_candidates_from_scores(scores, k, tm, slots < 5),
                     plain, f"k={k} tm={tm} scattered={scattered} dup={dup}")


# ----------------------------------------------------------------------
# slice 3: the Hamming (sym) kernels
# ----------------------------------------------------------------------
def _words(rng, n, w, device):
    return lsh.to_packed_tensor(
        rng.integers(0, 2**32, (n, w), dtype=np.uint32), device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,s,words,bits,temp", [
    (1, 7, 3, 4, 128, 1.0), (3, 512, 37, 4, 128, 8.0),
    (8, 513, 121, 8, 256, 4.0), (5, 64, 3, 2, 64, 1.0),
    (16, 1000, 128, 1, 32, 8.0), (48, 20000, 800, 8, 256, 8.0),
])
def test_cuda_hamming_kernels_match_plain(cuda_device, n, m, s, words, bits,
                                          temp):
    from repro_torch.kernels.hamming import kernel as hker
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    rng = np.random.default_rng(n + m + words)
    q, db = _words(rng, n, words, cuda_device), _words(rng, m, words,
                                                      cuda_device)
    counts = (hker.hamming_distance_kernel.launches,
              hker.hamming_similarity_kernel.launches,
              hker.hamming_segment_similarity_kernel.launches)
    dist = hops.hamming_distance(q, db)
    assert torch.equal(dist, href.hamming_distance_ref(q, db))    # exact
    sim = hops.hamming_similarity(q, db, bits, temperature=temp)
    assert torch.equal(sim, href.hamming_similarity_ref(q, db, bits, temp))
    seg = torch.from_numpy(rng.integers(-1, s + 2, m)).to(cuda_device)
    got = hops.hamming_segment_similarity(q, db, bits, seg, s,
                                          temperature=temp)
    again = hops.hamming_segment_similarity(q, db, bits, seg, s,
                                            temperature=temp)
    torch.cuda.synchronize()
    assert torch.equal(got, again)            # bitwise run to run
    want = href.hamming_segment_similarity_ref(q, db, bits, seg, s, temp)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    occupied = torch.zeros(s, dtype=torch.bool, device=cuda_device)
    occupied[seg[(seg >= 0) & (seg < s)]] = True
    assert bool((got[:, ~occupied] == 0).all())
    assert (hker.hamming_distance_kernel.launches,
            hker.hamming_similarity_kernel.launches,
            hker.hamming_segment_similarity_kernel.launches) == (
                counts[0] + 1, counts[1] + 1, counts[2] + 2)


@pytest.mark.cuda
def test_cuda_hamming_wrappers_reject_bad_operands(cuda_device):
    from repro_torch.kernels.hamming import kernel as hker
    rng = np.random.default_rng(0)
    q, db = _words(rng, 2, 4, cuda_device), _words(rng, 9, 4, cuda_device)
    with pytest.raises(TypeError):
        hker.hamming_distance_kernel(q.float(), db)
    with pytest.raises(ValueError):
        hker.hamming_distance_kernel(q[:, :2].contiguous(), db)
    with pytest.raises(ValueError):
        hker.hamming_similarity_kernel(q, db.cpu(), 128)


# slots of 26 (the served mean), 32 (a full warp) and 33 rows (a second
# pass of the warp) beside empty and one-row slots
HAMMING_SLOTS = (26, 32, 33, 0, 26, 1, 45, 26, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [5, 12, 16, 17, 32])
@pytest.mark.parametrize("counts,tm", [(RAGGED, 8), (RAGGED, 16),
                                       ((300, 40, 9), 256),
                                       (HAMMING_SLOTS, 64),
                                       (HAMMING_SLOTS * 40, 32)])
def test_cuda_hamming_megascan_matches_plain_and_is_bitwise(cuda_device, b,
                                                            counts, tm):
    """Row 8: one launch, bitwise run to run, == the streamed schedule
    (row 6), == ``testing.hamming_warp_sums`` (its exact model) and ==
    single-shard payloads bit for bit; the plain version within rtol
    1e-4; empty slots exactly 0.  B on both sides of the 16-query tile."""
    from repro_torch.kernels.megascan import kernel as mker
    from repro_torch.kernels.megascan import ops as mops
    from repro_torch.kernels.megascan import ref as mref
    segs, q, planes = ragged_segments(counts, 16, 64, tm + len(counts),
                                      n_queries=b)
    qsig = lsh.sign_vectors_np(q, planes)
    pay = mops.build_payload(segs, tm=tm, device=cuda_device)
    n = mker.hamming_megascan_segsum_kernel.launches
    got = mops.megascan_segment_sums(pay, qsig, None, 64, mode="hamming",
                                     temperature=4.0)
    assert mker.hamming_megascan_segsum_kernel.launches == n + 1
    assert np.array_equal(got, mops.megascan_segment_sums(
        pay, qsig, None, 64, mode="hamming", temperature=4.0))
    streamed = mops.megascan_segment_sums(pay, qsig, None, 64,
                                          mode="hamming", temperature=4.0,
                                          double_buffer=False)
    assert np.array_equal(got, streamed)
    want = mref.hamming_megascan_segsum_ref(
        lsh.to_packed_tensor(qsig, cuda_device), pay.sig, 64, pay.row_start,
        pay.row_count, 4.0)
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-4)
    model = hamming_warp_sums(lsh.to_packed_tensor(qsig, cuda_device),
                              pay.sig, pay.row_start, pay.row_count, 64, 4.0)
    assert np.array_equal(got, model.double().cpu().numpy())
    assert (got[:, np.asarray(counts) == 0] == 0).all()
    for s, seg in enumerate(segs[:12]):
        one = mops.build_payload([seg], tm=tm, device=cuda_device)
        single = mops.megascan_segment_sums(one, qsig, None, 64,
                                            mode="hamming", temperature=4.0)
        assert np.array_equal(got[:, s], single[:, 0])


@pytest.mark.cuda
def test_cuda_sym_index_scores_through_the_kernels(cuda_device):
    """A sym index on the card scores through the Hamming kernels and
    agrees with the same index on the CPU: per-value bit for bit (one
    table), the sums within rtol=1e-4, the top-k ids exactly."""
    from repro_torch.kernels.hamming import kernel as hker
    cfg = SyntheticCorpusConfig(n_docs=80, vocab_size=300, n_topics=4, seed=0)
    docs, _ = generate_text_corpus(cfg)
    corpus = ShardedCorpus.from_documents(docs, cfg.vocab_size,
                                          shard_tokens=1024)
    rng = np.random.default_rng(0)
    model = SimpleNamespace(
        word_vecs=rng.normal(size=(cfg.vocab_size, 16)).astype(np.float32),
        doc_vecs=rng.normal(size=(corpus.n_docs, 16)).astype(np.float32))
    idx = build_index(corpus, model, lsh.LSHConfig(bits=64),
                      granularity="doc", lsh_mode="sym")
    cpu = dataclasses.replace(idx, device="cpu")
    queries, words = [[3, 5, 9], [2], [10, 11]], [1, 2, 5, 17]
    n_sim = hker.hamming_similarity_kernel.launches
    n_seg = hker.hamming_segment_similarity_kernel.launches
    rows = idx.shard_similarities_batch(queries)
    w_rows = idx.word_shard_similarities_batch(words)
    ids, vals = idx.topk_doc_similarities_batch(queries, k=7)
    assert hker.hamming_segment_similarity_kernel.launches == n_seg + 1
    assert hker.hamming_similarity_kernel.launches == n_sim + 2
    np.testing.assert_allclose(rows, cpu.shard_similarities_batch(queries),
                               rtol=1e-4)
    assert np.array_equal(w_rows, cpu.word_shard_similarities_batch(words))
    cids, cvals = cpu.topk_doc_similarities_batch(queries, k=7)
    assert np.array_equal(ids, cids) and np.array_equal(vals, cvals)
    lsh_idx = lsh.LSHIndex.build(model.doc_vecs, lsh.LSHConfig(bits=64),
                                 device=cuda_device)
    sims = lsh_idx.similarities(model.word_vecs[3], temperature=8.0)
    assert sims.device.type == "cuda"
    cpu_lsh = lsh.LSHIndex(lsh_idx.packed.cpu(), lsh_idx.planes.cpu(), 64)
    assert torch.equal(sims.cpu(), cpu_lsh.similarities(model.word_vecs[3],
                                                        temperature=8.0))


# ----------------------------------------------------------------------
# the offline index build: rows 11 (negsamp) and 12 (k-means assign)
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("b,dim,k,temp",
                         NEGSAMP_SHAPES + [(4096, 64, 5, 8.0)])
def test_cuda_negsamp_matches_plain(cuda_device, b, dim, k, temp):
    """Row 11 against its plain version on N(0, 1) inputs: rtol=1e-5,
    atol=1e-5 * t^2 (the two sum the dot products in other orders;
    tests/test_torch_negsamp.py derives the bound), bitwise run to run."""
    from repro_torch.kernels.negsamp import kernel as nker
    from repro_torch.kernels.negsamp import ops as nops
    from repro_torch.kernels.negsamp import ref as nref
    rng = np.random.default_rng(b)
    d, w, wn = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .to(cuda_device) for s in ((b, dim), (b, dim), (b, k, dim)))
    n = nker.negsamp_grads_kernel.launches
    got = nops.negsamp_grads(d, w, wn, temperature=temp)
    again = nops.negsamp_grads(d, w, wn, temperature=temp)
    torch.cuda.synchronize()
    assert nker.negsamp_grads_kernel.launches == n + 2
    for g, a, r in zip(got, again, nref.negsamp_grads_ref(d, w, wn, temp)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5 * temp * temp)


@pytest.mark.cuda
def test_cuda_negsamp_unit_rows_at_the_step_shape(cuda_device):
    """Row 11 at the training step's shape (B=4096, K=5, dim=64, t=8) on
    unit rows, as training gives it: every dot is at most 1, and the
    reference's rtol=1e-5, atol=1e-6 holds."""
    from repro_torch.kernels.negsamp import ops as nops
    from repro_torch.kernels.negsamp import ref as nref
    rng = np.random.default_rng(11)
    d = _unit_rows(rng, 4096, 64, cuda_device)
    w = _unit_rows(rng, 4096, 64, cuda_device)
    wn = _unit_rows(rng, 4096 * 5, 64, cuda_device).reshape(4096, 5, 64)
    for g, r in zip(nops.negsamp_grads(d, w, wn, temperature=8.0),
                    nref.negsamp_grads_ref(d, w, wn, 8.0)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_negsamp_wrapper_rejects_bad_operands(cuda_device):
    from repro_torch.kernels.negsamp import kernel as nker
    from repro_torch.kernels.negsamp import ops as nops
    d = torch.zeros((4, 16), device=cuda_device)
    wn = torch.zeros((4, 3, 16), device=cuda_device)
    with pytest.raises(TypeError):
        nker.negsamp_grads_kernel(d.double(), d.double(), wn.double())
    with pytest.raises(ValueError):
        nker.negsamp_grads_kernel(d, d, wn[:, :, :8].contiguous())
    big = torch.zeros((4, 512), device=cuda_device)
    with pytest.raises(ValueError):
        nker.negsamp_grads_kernel(big, big, torch.zeros((4, 1, 512),
                                                        device=cuda_device))
    with pytest.raises(ValueError):
        nops.negsamp_grads(d.cpu(), d, wn)


def _unit_rows(rng, n, dim, device):
    x = rng.normal(size=(n, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,dim", KMEANS_SHAPES + [(5000, 300, 64),
                                                     (333, 129, 130)])
def test_cuda_kmeans_assign_matches_plain(cuda_device, n, k, dim):
    """Row 12 against its plain version: ids exactly away from near-ties
    (top two scores within 1e-4), best scores rtol=1e-5; bitwise run to
    run."""
    from repro_torch.kernels.kmeans import kernel as kker
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.kmeans import ref as kref
    rng = np.random.default_rng(n + k)
    x, c = _unit_rows(rng, n, dim, cuda_device), _unit_rows(rng, k, dim,
                                                            cuda_device)
    launches = kker.assign_kernel.launches
    ids, best = kops.assign_with_scores(x, c)
    ids2, best2 = kops.assign_with_scores(x, c)
    torch.cuda.synchronize()
    assert kker.assign_kernel.launches == launches + 2
    assert torch.equal(ids, ids2) and torch.equal(best, best2)
    want_ids, want_best = kref.assign_ref(x, c)
    assert_assign_away_from_ties(ids, x, c, "kmeans assign")
    assert_assign_away_from_ties(want_ids, x, c, "plain kmeans assign")
    torch.testing.assert_close(best, want_best, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_kmeans_assign_ties_take_the_first_index(cuda_device):
    from repro_torch.kernels.kmeans import ops as kops
    rng = np.random.default_rng(3)
    x = _unit_rows(rng, 4000, 64, cuda_device)
    c = _unit_rows(rng, 300, 64, cuda_device)
    c[200:] = c[:100]                       # every c[j >= 200] copies c[j - 200]
    c[150] = c[5]
    ids = kops.assign(x, c).cpu().numpy()
    assert not (ids >= 200).any() and not (ids == 150).any()
    assert (ids == 5).any()
    dead = torch.full((64, 64), 0.125, device=cuda_device)   # all equal rows
    ids = kops.assign(x, dead)
    assert bool((ids == 0).all())


@pytest.mark.cuda
def test_cuda_train_matches_cpu_on_injected_draws(cuda_device):
    """A few CUDA training steps (row 11, float-atomic scatter-adds)
    against the same steps on the CPU from the same initial tables and
    negatives: atol=1e-4."""
    from repro_torch.core import pv_dbow
    from repro_torch.kernels.negsamp import kernel as nker
    cfg = SyntheticCorpusConfig(n_docs=300, vocab_size=512, n_topics=4, seed=1)
    docs, _ = generate_text_corpus(cfg)
    corpus = ShardedCorpus.from_documents(docs, cfg.vocab_size,
                                          shard_tokens=2048)
    pcfg = pv_dbow.PVDBOWConfig(dim=16, steps=8, batch_pairs=512, lr=0.01,
                                temperature=8.0, seed=1)
    init = pv_dbow.init_model(torch.Generator().manual_seed(0),
                              cfg.vocab_size, corpus.n_docs, pcfg.dim)
    rng = np.random.default_rng(0)
    negs = [rng.integers(0, cfg.vocab_size, (512, pcfg.negatives))
            for _ in range(pcfg.steps)]
    n = nker.negsamp_grads_kernel.launches
    gpu = pv_dbow.train_pv_dbow(corpus, pcfg, device=cuda_device, init=init,
                                negatives=lambda s: negs[s])
    assert nker.negsamp_grads_kernel.launches == n + pcfg.steps
    cpu = pv_dbow.train_pv_dbow(corpus, pcfg, device="cpu", init=init,
                                negatives=lambda s: negs[s])
    for g, c in zip(gpu, cpu):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kmeans_update_is_deterministic(cuda_device):
    """The centroid update on 2^16 x 64 rows into 1000 clusters: two CUDA
    runs give the same bits, and the cluster sums are the CPU route's,
    bit for bit (each cluster's rows added in row order, no atomics)."""
    from repro_torch.core import allocation
    rng = np.random.default_rng(16)
    x = _unit_rows(rng, 1 << 16, 64, cuda_device)
    assign = torch.from_numpy(rng.integers(0, 1000, 1 << 16)).to(cuda_device)
    assign[assign == 3] = 4                          # a dead cluster
    first = allocation._update(x, assign, 1000)
    second = allocation._update(x, assign, 1000)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    sums, counts = allocation.cluster_sums(x, assign, 1000)
    cpu_sums, cpu_counts = allocation.cluster_sums(x.cpu(), assign.cpu(), 1000)
    assert torch.equal(sums.cpu(), cpu_sums)
    assert torch.equal(counts.cpu(), cpu_counts) and int(counts[3]) == 0
    torch.testing.assert_close(first.cpu(), allocation._update(
        x.cpu(), assign.cpu(), 1000), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_spherical_kmeans_matches_cpu(cuda_device):
    """Clustered data with a margin: the CUDA route (row 12, one launch
    per iteration plus the first) gives the CPU route's assignment."""
    from repro_torch.core import allocation
    from repro_torch.kernels.kmeans import kernel as kker
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 16)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 6, 480)] + 0.08 * rng.normal(
        size=(480, 16)).astype(np.float32)
    cfg = allocation.KMeansConfig(n_clusters=6, balanced=False)
    ids = rng.choice(480, 6, replace=False)
    n = kker.assign_kernel.launches
    gpu_a, gpu_c = allocation.spherical_kmeans(x, cfg, device=cuda_device,
                                               init_ids=ids)
    assert kker.assign_kernel.launches - n >= 2
    cpu_a, cpu_c = allocation.spherical_kmeans(x, cfg, device="cpu",
                                               init_ids=ids)
    assert np.array_equal(gpu_a, cpu_a)
    np.testing.assert_allclose(gpu_c, cpu_c, rtol=0, atol=1e-5)
