"""The port's one-launch megascan against the JAX package's
``kernels/megascan`` (Pallas in interpret mode on the CPU), on the same
inputs made with numpy: the block layout, the payload field for field,
the segment sums and the ranked candidates, the index's payload cache,
and the executor's megakernel route.  On the CPU the port's wrappers
take their plain versions; ``test_torch_cuda.py`` holds the CUDA
kernels against those on the card.

Within the port the reference's bitwise properties hold bit for bit:
streamed == pipelined schedule, group payload == single-shard payload,
megakernel route == per-shard route.  Against the reference, sums are
held to rtol=1e-4 (the tolerance it holds its own kernels to) and
ranked ids must be equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.data.store import plan_blocked_layout as j_plan
from repro.kernels.megascan import MegascanSpec as JSpec
from repro.kernels.megascan import ops as jops
from repro.kernels.megascan import ref as jref
from repro.runtime.executor import ShardTaskExecutor as JExecutor
from repro_torch.core import index as tindex
from repro_torch.data.store import ShardedCorpus as TCorpus
from repro_torch.data.store import plan_blocked_layout as t_plan
from repro_torch.kernels.megascan import MegascanSpec as TSpec
from repro_torch.kernels.megascan import ops as tops
from repro_torch.runtime.executor import ShardTaskExecutor as TExecutor

# the reference's ragged shard census: partial last blocks, a one-doc
# shard, an EMPTY shard, a shard count that is not a multiple of 2
RAGGED = (13, 8, 1, 0, 27, 64, 5)
QUERIES = [[3, 5, 9], [2], [10, 11], [7, 4, 5, 6]]


def _segments(counts, dim, bits, seed, dup=False):
    """Per-shard (packed signatures, doc ids) with globally unique ids,
    5 query vectors and the planes, all numpy.  ``dup`` repeats every
    signature row in place, so ranked values tie exactly."""
    rng = np.random.default_rng(seed)
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    segs, base = [], 0
    for c in counts:
        x = rng.normal(size=(c, dim)).astype(np.float32)
        if dup:
            x[1::2] = x[0::2][:c // 2]
        sig = np.array(jlsh.pack_bits(jlsh.signature_bits(
            jnp.asarray(x), jnp.asarray(planes))))
        segs.append((sig, np.arange(base, base + c, dtype=np.int64)))
        base += c
    q = rng.normal(size=(5, dim)).astype(np.float32)
    return segs, q, planes


def _signs(q, planes):
    """The reference's packed signatures of query vectors (uint32)."""
    return np.asarray(jlsh.pack_bits(jlsh.signature_bits(
        jnp.asarray(q), jnp.asarray(planes))))


def _both(segs, tm):
    return (jops.build_payload(segs, tm=tm),
            tops.build_payload(segs, tm=tm, device="cpu"))


# ----------------------------------------------------------------------
# layout planning + payload packing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("counts,block", [
    ([3, 0, 5, 4], 4), (list(RAGGED), 8), ([0, 0], 16), ([300, 40, 9], 256),
])
def test_plan_blocked_layout_matches_reference(counts, block):
    got = t_plan(np.array(counts), block)
    want = j_plan(np.array(counts), block)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_plan_blocked_layout_ragged():
    starts, blocks, total = t_plan(np.array([3, 0, 5, 4]), 4)
    np.testing.assert_array_equal(blocks, [1, 0, 2, 1])
    np.testing.assert_array_equal(starts, [0, 4, 4, 12])
    assert total == 16
    with pytest.raises(ValueError):
        t_plan(np.array([1]), 0)
    with pytest.raises(ValueError):
        t_plan(np.array([-1]), 4)


@pytest.mark.parametrize("counts,tm", [(RAGGED, 8), (RAGGED, 16),
                                       ((300, 40, 9), 256), ((0, 0), 8)])
def test_build_payload_field_for_field(counts, tm):
    segs, _, _ = _segments(counts, 16, 64, seed=3)
    jp, tp = _both(segs, tm)
    np.testing.assert_array_equal(tp.sig.numpy().view(np.uint32),
                                  np.asarray(jp.sig))
    np.testing.assert_array_equal(tp.slots.numpy(), np.asarray(jp.slots))
    for name in ("doc_idx", "counts", "block_slot"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    for name in ("shard_ids", "tm", "n_slots", "n_blocks", "n_rows",
                 "slot_pad"):
        assert getattr(tp, name) == getattr(jp, name), name
    starts, _, _ = j_plan(np.array(counts), tm)
    np.testing.assert_array_equal(tp.row_start.numpy(), starts)
    np.testing.assert_array_equal(tp.row_count.numpy(), counts)


def test_build_payload_rejects_bad_input():
    segs, _, _ = _segments(RAGGED, 16, 64, seed=3)
    with pytest.raises(ValueError):
        tops.build_payload(segs, tm=12, device="cpu")     # not a power of 2
    with pytest.raises(ValueError):
        tops.build_payload([], device="cpu")


# ----------------------------------------------------------------------
# segment sums
# ----------------------------------------------------------------------
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("counts,tm,seed", [(RAGGED, 8, 7), (RAGGED, 16, 8),
                                            ((300, 40, 9), 256, 9)])
def test_segment_sums_match_reference(counts, tm, seed, double_buffer):
    segs, q, planes = _segments(counts, 16, 64, seed)
    jp, tp = _both(segs, tm)
    want = jops.megascan_segment_sums(jp, jnp.asarray(q),
                                      jnp.asarray(planes), 64,
                                      temperature=4.0)
    oracle = jref.megascan_segment_sums_ref(jp, q, planes, 64,
                                            temperature=4.0)
    got = tops.megascan_segment_sums(tp, q, planes, 64, temperature=4.0,
                                     double_buffer=double_buffer)
    assert got.dtype == np.float64 and got.shape == (5, len(counts))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4)
    assert (got[:, np.asarray(counts) == 0] == 0).all()


@pytest.mark.parametrize("counts,tm,seed", [(RAGGED, 8, 11), (RAGGED, 32, 12),
                                            ((300, 40, 9), 256, 13)])
def test_streamed_equals_pipelined_bitwise(counts, tm, seed):
    segs, q, planes = _segments(counts, 16, 64, seed)
    tp = tops.build_payload(segs, tm=tm, device="cpu")
    streamed = tops.megascan_segment_sums(tp, q, planes, 64,
                                          double_buffer=False)
    pipelined = tops.megascan_segment_sums(tp, q, planes, 64,
                                           double_buffer=True)
    np.testing.assert_array_equal(streamed, pipelined)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_group_equals_single_shard_bitwise(double_buffer):
    segs, q, planes = _segments(RAGGED, 16, 64, seed=13)
    group = tops.megascan_segment_sums(
        tops.build_payload(segs, tm=8, device="cpu"), q, planes, 64,
        temperature=4.0, double_buffer=double_buffer)
    for s, seg in enumerate(segs):
        single = tops.megascan_segment_sums(
            tops.build_payload([seg], tm=8, device="cpu"), q, planes, 64,
            temperature=4.0, double_buffer=double_buffer)
        np.testing.assert_array_equal(group[:, s], single[:, 0])


def test_empty_payload_is_zeros_and_one_shard_host():
    segs, q, planes = _segments((0, 0), 16, 64, seed=1)
    tp = tops.build_payload(segs, tm=8, device="cpu")
    assert tp.n_rows == 0 and tp.n_blocks == 0
    np.testing.assert_array_equal(
        tops.megascan_segment_sums(tp, q, planes, 64), np.zeros((5, 2)))
    ids, vals = tops.megascan_topk(tp, q, planes, 64, 3)
    assert (ids == -1).all() and np.isneginf(vals).all()
    segs, q, planes = _segments((9,), 16, 64, seed=2)
    jp, tp = _both(segs, 8)
    np.testing.assert_allclose(
        tops.megascan_segment_sums(tp, q, planes, 64),
        jref.megascan_segment_sums_ref(jp, q, planes, 64), rtol=1e-4)


def test_hamming_mode_is_refused():
    """The Hamming sum runs on packed query signatures, and an unknown
    mode is refused, as in the reference."""
    segs, q, planes = _segments((9,), 16, 64, seed=2)
    tp = tops.build_payload(segs, tm=8, device="cpu")
    qsig = _signs(q, planes)
    got = tops.megascan_segment_sums(tp, qsig, None, 64, mode="hamming")
    assert got.shape == (5, 1) and np.all(got > 0)
    with pytest.raises(ValueError):
        tops.megascan_segment_sums(tp, q, planes, 64, mode="cosine")


# ----------------------------------------------------------------------
# Hamming (sym) segment sums
# ----------------------------------------------------------------------
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("counts,tm,seed", [(RAGGED, 8, 7), (RAGGED, 16, 8),
                                            ((300, 40, 9), 256, 9)])
def test_hamming_segment_sums_match_reference(counts, tm, seed,
                                              double_buffer):
    segs, q, planes = _segments(counts, 16, 64, seed)
    jp, tp = _both(segs, tm)
    qsig = _signs(q, planes)
    want = jops.megascan_segment_sums(jp, jnp.asarray(qsig), None, 64,
                                      mode="hamming", temperature=4.0)
    oracle = jref.megascan_segment_sums_ref(jp, qsig, planes, 64,
                                            mode="hamming", temperature=4.0)
    got = tops.megascan_segment_sums(tp, qsig, None, 64, mode="hamming",
                                     temperature=4.0,
                                     double_buffer=double_buffer)
    assert got.dtype == np.float64 and got.shape == (5, len(counts))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4)
    assert (got[:, np.asarray(counts) == 0] == 0).all()


@pytest.mark.parametrize("counts,tm,seed", [(RAGGED, 8, 11), (RAGGED, 32, 12),
                                            ((300, 40, 9), 256, 13)])
def test_hamming_streamed_equals_pipelined_bitwise(counts, tm, seed):
    segs, q, planes = _segments(counts, 16, 64, seed)
    tp = tops.build_payload(segs, tm=tm, device="cpu")
    qsig = _signs(q, planes)
    streamed = tops.megascan_segment_sums(tp, qsig, None, 64, mode="hamming",
                                          temperature=8.0,
                                          double_buffer=False)
    pipelined = tops.megascan_segment_sums(tp, qsig, None, 64,
                                           mode="hamming", temperature=8.0,
                                           double_buffer=True)
    np.testing.assert_array_equal(streamed, pipelined)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_hamming_group_equals_single_shard_bitwise(double_buffer):
    segs, q, planes = _segments(RAGGED, 16, 64, seed=13)
    qsig = _signs(q, planes)
    group = tops.megascan_segment_sums(
        tops.build_payload(segs, tm=8, device="cpu"), qsig, None, 64,
        mode="hamming", temperature=4.0, double_buffer=double_buffer)
    for s, seg in enumerate(segs):
        single = tops.megascan_segment_sums(
            tops.build_payload([seg], tm=8, device="cpu"), qsig, None, 64,
            mode="hamming", temperature=4.0, double_buffer=double_buffer)
        np.testing.assert_array_equal(group[:, s], single[:, 0])


def test_hamming_empty_payload_and_one_query_row():
    segs, q, planes = _segments((0, 0), 16, 64, seed=1)
    tp = tops.build_payload(segs, tm=8, device="cpu")
    qsig = _signs(q, planes)
    np.testing.assert_array_equal(
        tops.megascan_segment_sums(tp, qsig, None, 64, mode="hamming"),
        np.zeros((5, 2)))
    segs, q, planes = _segments(RAGGED, 16, 64, seed=2)
    tp = tops.build_payload(segs, tm=8, device="cpu")
    qsig = _signs(q, planes)
    one = tops.megascan_segment_sums(tp, qsig[2], None, 64, mode="hamming")
    all_ = tops.megascan_segment_sums(tp, qsig, None, 64, mode="hamming")
    np.testing.assert_array_equal(one[0], all_[2])


# ----------------------------------------------------------------------
# ranked megascan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("counts,tm,k,seed,dup", [
    (RAGGED, 16, 5, 17, False), (RAGGED, 8, 5, 18, False),
    ((300, 40, 9), 256, 7, 19, False), (RAGGED, 16, 5, 20, True),
])
def test_megascan_topk_matches_reference(counts, tm, k, seed, dup):
    segs, q, planes = _segments(counts, 16, 64, seed, dup=dup)
    jp, tp = _both(segs, tm)
    want_ids, want_vals = jops.megascan_topk(
        jp, jnp.asarray(q), jnp.asarray(planes), 64, k, temperature=4.0)
    ids, vals = tops.megascan_topk(tp, q, planes, 64, k, temperature=4.0)
    assert ids.dtype == np.int64 and vals.dtype == np.float64
    np.testing.assert_array_equal(ids, want_ids)
    finite = np.isfinite(want_vals)
    np.testing.assert_array_equal(np.isfinite(vals), finite)
    np.testing.assert_allclose(vals[finite], want_vals[finite], rtol=1e-4)
    rids, _ = jref.megascan_topk_ref(jp, q, planes, 64, k, temperature=4.0)
    np.testing.assert_array_equal(ids, rids)
    # a slot with fewer than k docs pads with -1 / -inf
    short = np.asarray(counts) < k
    for s in np.nonzero(short)[0]:
        assert (ids[:, s, counts[s]:] == -1).all()
        assert np.isneginf(vals[:, s, counts[s]:]).all()
    with pytest.raises(ValueError):
        tops.megascan_topk(tp, q, planes, 64, tm + 1)


def test_megascan_topk_group_equals_single_shard_bitwise():
    segs, q, planes = _segments(RAGGED, 16, 64, seed=21)
    ids, vals = tops.megascan_topk(
        tops.build_payload(segs, tm=16, device="cpu"), q, planes, 64, 6)
    for s, seg in enumerate(segs):
        i1, v1 = tops.megascan_topk(
            tops.build_payload([seg], tm=16, device="cpu"), q, planes, 64, 6)
        np.testing.assert_array_equal(ids[:, s], i1[:, 0])
        np.testing.assert_array_equal(vals[:, s], v1[:, 0])


def _reference_loop(cvals, cpos, block_slot, n_slots, k):
    """The reference's per-slot final reduction, literally
    (``megascan/ops.py::megascan_topk``), on positions."""
    b = cvals.shape[0]
    pos = np.full((b, n_slots, k), -1, np.int64)
    vals = np.full((b, n_slots, k), -np.inf, np.float64)
    lane = np.arange(k)
    for s in range(n_slots):
        blocks_s = np.nonzero(block_slot == s)[0]
        if blocks_s.size == 0:
            continue
        cols = (blocks_s[:, None] * k + lane[None, :]).ravel()
        v = cvals[:, cols]
        p = cpos[:, cols]
        kk = min(k, v.shape[1])
        order = np.argsort(-v, axis=1, kind="stable")[:, :kk]
        tv = np.take_along_axis(v, order, axis=1)
        tp = np.take_along_axis(p, order, axis=1)
        real = np.isfinite(tv)
        pos[:, s, :kk] = np.where(real, tp, -1)
        vals[:, s, :kk] = np.where(real, tv, -np.inf)
    return pos, vals


@pytest.mark.parametrize("seed", range(4))
def test_per_slot_topk_matches_reference_loop_on_ties(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 6))
    blocks = rng.integers(0, 4, 9)
    block_slot = np.repeat(np.arange(9, dtype=np.int32), blocks)
    nb = block_slot.shape[0]
    # quantised values force ties across and within blocks; some -inf
    cvals = rng.integers(0, 4, (3, nb * k)).astype(np.float32)
    cvals[rng.random(cvals.shape) < 0.2] = -np.inf
    cpos = rng.permutation(nb * k * 2)[:nb * k].astype(np.int32)
    cpos = np.broadcast_to(cpos, cvals.shape).copy()
    want_pos, want_vals = _reference_loop(cvals, cpos, block_slot, 9, k)
    vals, pos = tops.per_slot_topk(torch.from_numpy(cvals),
                                   torch.from_numpy(cpos), block_slot, 9, k)
    vals, pos = vals.numpy(), pos.numpy()
    real = np.isfinite(vals)
    np.testing.assert_array_equal(np.where(real, pos, -1), want_pos)
    np.testing.assert_array_equal(np.where(real, vals, -np.inf), want_vals)


# ----------------------------------------------------------------------
# index payload cache + executor megakernel route
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair(small_corpus, built_index, tmp_path_factory):
    """(reference doc-granular index and corpus, the port's load of the
    same index and its own corpus of the same documents)."""
    ref = dataclasses.replace(built_index,
                              granularity="doc").attach_corpus(small_corpus)
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    ref.save(path)
    port = tindex.ApproxIndex.load(path, device="cpu")
    corpus = TCorpus.from_documents(
        [d for s in small_corpus.shards for d in s.iter_documents()],
        small_corpus.vocab_size, shard_tokens=4096)
    port.attach_corpus(corpus)
    return (small_corpus, ref), (corpus, port)


def test_index_megascan_payload_cached_until_reattach(pair):
    (_, ref), (corpus, port) = pair
    idx = dataclasses.replace(port).attach_corpus(corpus)
    pay = idx.megascan_payload((0, 1, 2), tm=64)
    assert idx.megascan_payload((0, 1, 2), tm=64) is pay
    assert idx.megascan_payload((0, 1, 2), tm=128) is not pay
    assert pay.shard_ids == (0, 1, 2)
    want = ref.megascan_payload((0, 1, 2), tm=64)
    np.testing.assert_array_equal(pay.doc_idx, want.doc_idx)
    np.testing.assert_array_equal(pay.sig.numpy().view(np.uint32),
                                  np.asarray(want.sig))
    fresh = idx.attach_corpus(corpus)
    assert fresh.megascan_payload((0, 1, 2), tm=64) is not pay
    bare = dataclasses.replace(port, doc_sig=None, doc_vecs=None)
    with pytest.raises(ValueError):
        bare.megascan_payload((0,))
    with pytest.raises(ValueError):
        TSpec(bare, port.query_vectors(QUERIES))
    sym = dataclasses.replace(port, lsh_mode="sym")
    assert TSpec(sym, port.query_vectors(QUERIES)).mode == "hamming"
    with pytest.raises(ValueError):
        TSpec(sym, port.query_vectors(QUERIES), ranked_k=5)


def _ragged_plans(n_queries, n_shards, rng):
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


def _scan_dicts_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for s in g:
            if isinstance(g[s], dict):
                np.testing.assert_array_equal(g[s]["doc_ids"],
                                              w[s]["doc_ids"])
                np.testing.assert_array_equal(g[s]["values"],
                                              w[s]["values"])
            else:
                assert g[s] == w[s]


@pytest.mark.parametrize("ranked", [False, True])
def test_executor_megakernel_route_bitwise_parity(pair, ranked):
    (_, _), (corpus, port) = pair
    spec = TSpec(port, port.query_vectors(QUERIES),
                 ranked_k=6 if ranked else None)
    fns = spec.scan_fns()
    plans = _ragged_plans(len(QUERIES), corpus.n_shards,
                          np.random.default_rng(5))
    with TExecutor(workers=2) as ex:
        mega = ex.map_shard_batch(corpus, plans, fns, megakernel=True)
        assert spec.stats["group_launches"] == 1
        assert ex.stats["megascan_jobs"] == 1
        rec = ex.last_job["megascan"]
        assert rec["ranked"] == ranked
        # the sum scores by 4-bit table lookup, the top-k bit by bit
        b, rows, bits = len(QUERIES), rec["real_rows"], port.bits
        per_row = 2 * bits if ranked else bits // 4
        assert rec["flops"] == (2 * b * bits * spec.planes.shape[1]
                                + b * rows * (per_row + 1)
                                + (0 if ranked else 48 * b * (bits // 4)))
        per = ex.map_shard_batch(corpus, plans, fns, megakernel=False)
        assert spec.stats["shard_launches"] > 0
    _scan_dicts_equal(mega, per)


def test_executor_megakernel_retry_preserves_parity(pair):
    (_, _), (corpus, port) = pair
    spec = TSpec(port, port.query_vectors(QUERIES))
    fns = spec.scan_fns()
    plans = [[0, 1, 2]] * len(QUERIES)
    failed = []

    def flaky(shard_id, attempt):
        if shard_id == 1 and attempt == 1:
            failed.append(shard_id)
            raise RuntimeError("injected")

    with TExecutor(workers=2, fault_hook=flaky) as ex, \
            TExecutor(workers=2) as calm:
        mega = ex.map_shard_batch(corpus, plans, fns, megakernel=True)
        assert failed == [1] and ex.stats["retries"] >= 1
        per = calm.map_shard_batch(corpus, plans, fns, megakernel=False)
    _scan_dicts_equal(mega, per)


def test_run_shared_scan_megakernel_flag_validation(pair):
    (_, _), (corpus, port) = pair
    with TExecutor(workers=1) as ex:
        with pytest.raises(ValueError):
            ex.map_shard_batch(corpus, [[0]], [lambda shard: 0.0],
                               megakernel=True)
        # an executor built with megakernel=False pins the per-shard route
    spec = TSpec(port, port.query_vectors(QUERIES[:1]))
    with TExecutor(workers=1, megakernel=False) as ex:
        ex.map_shard_batch(corpus, [[0, 1]], spec.scan_fns())
        assert ex.stats["megascan_jobs"] == 0
        assert spec.stats["shard_launches"] == 2


@pytest.mark.parametrize("ranked", [False, True])
def test_port_and_reference_executors_agree(pair, ranked):
    (jcorpus, ref), (corpus, port) = pair
    plans = _ragged_plans(len(QUERIES), corpus.n_shards,
                          np.random.default_rng(7))
    k = 6 if ranked else None
    jspec = JSpec(ref, ref.query_vectors(QUERIES), ranked_k=k)
    tspec = TSpec(port, port.query_vectors(QUERIES), ranked_k=k)
    with TExecutor(workers=2) as tex:
        got = tex.map_shard_batch(corpus, plans, tspec.scan_fns(),
                                  megakernel=True)
    jex = JExecutor(workers=2)
    want = jex.map_shard_batch(jcorpus, plans, jspec.scan_fns(),
                               megakernel=True)
    jex.close()
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for s in g:
            if ranked:
                np.testing.assert_array_equal(g[s]["doc_ids"],
                                              w[s]["doc_ids"])
                np.testing.assert_allclose(g[s]["values"], w[s]["values"],
                                           rtol=1e-4)
            else:
                np.testing.assert_allclose(g[s], w[s], rtol=1e-4)
