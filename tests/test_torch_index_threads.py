"""Many threads planning on one fresh index at once.

A serving stack plans from several threads: the batching window's, the
ingest writer's, the executor's workers and direct ``execute`` calls,
and after every ingest swap the index they share is a fresh object
with empty device caches.  Each round here starts 8 threads behind a
barrier on a fresh CPU index; one plans straight away and the others
first upload another signature set and then plan.  The upload helper
(``lsh.to_packed_tensor``) is patched so that the first planner's
upload ends only while the others stand ready (spinning, with the
interpreter switching threads every microsecond), so they look into
the cache while the first planner publishes its operands.  Every
thread must get the rows a single thread gets, bit for bit, and none
may raise.  The race is timing-dependent, so the test runs many
rounds; an index that publishes its operands one by one fails it."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import lsh as lsh_mod
from repro_torch.core.index import ApproxIndex

THREADS = 8
ROUNDS = 80
QUERIES = [[1, 2, 3]]


@pytest.fixture(scope="module")
def base_index():
    rng = np.random.default_rng(0)
    n, v, dim, bits, shards = 300, 64, 16, 64, 24
    planes = rng.normal(size=(bits, dim)).astype(np.float32)
    wv = rng.normal(size=(v, dim)).astype(np.float32)
    dv = rng.normal(size=(n, dim)).astype(np.float32)
    sv = rng.normal(size=(shards, dim)).astype(np.float32)
    sig = lambda x: lsh_mod.sign_vectors_np(x, planes)  # noqa: E731
    return ApproxIndex(
        word_vecs=wv, shard_vecs=sv, doc_vecs=dv, planes=planes,
        word_sig=sig(wv), shard_sig=sig(sv), doc_sig=sig(dv), bits=bits,
        doc_freq=np.ones(v, np.int64), n_docs=n, avg_doc_len=1.0,
        granularity="doc", temperature=8.0, device="cpu",
        _doc_shard_ids=rng.integers(0, shards, n))


def _rounds(base, monkeypatch):
    want = dataclasses.replace(base).shard_similarities_batch(QUERIES)
    upload = lsh_mod.to_packed_tensor
    role = threading.local()
    go = [False]

    def slow_upload(sig, device="cpu"):
        out = upload(sig, device)
        if getattr(role, "first", False):
            time.sleep(0.002)
            go[0] = True
        else:
            # bounded: on a locked index a waiter may hold the lock
            limit = time.perf_counter() + 0.01
            while not go[0] and time.perf_counter() < limit:
                pass
        return out

    monkeypatch.setattr(lsh_mod, "to_packed_tensor", slow_upload)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    failures = []
    try:
        for r in range(ROUNDS):
            index = dataclasses.replace(base)
            go[0] = False
            barrier = threading.Barrier(THREADS)

            def plan(i):
                role.first = i == 0
                barrier.wait()
                try:
                    if i:
                        index._device_sig(index.word_sig, "word")
                    got = index.shard_similarities_batch(QUERIES)
                    if not np.array_equal(got, want):
                        failures.append((r, i, "rows differ"))
                except Exception as exc:  # noqa: BLE001 - the finding
                    failures.append((r, i, repr(exc)))

            threads = [threading.Thread(target=plan, args=(i,))
                       for i in range(THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    finally:
        sys.setswitchinterval(interval)
    return failures


def test_threads_on_a_fresh_index_get_identical_rows(base_index,
                                                     monkeypatch):
    failures = _rounds(base_index, monkeypatch)
    assert failures == [], failures[:5]


def test_caches_are_built_once_per_index(base_index, monkeypatch):
    calls = []
    upload = lsh_mod.to_packed_tensor

    def counting(sig, device="cpu"):
        calls.append(sig.shape)
        time.sleep(0.002)
        return upload(sig, device)

    monkeypatch.setattr(lsh_mod, "to_packed_tensor", counting)
    index = dataclasses.replace(base_index)
    barrier = threading.Barrier(THREADS)

    def plan():
        barrier.wait()
        index.shard_similarities_batch(QUERIES)

    threads = [threading.Thread(target=plan) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1            # the sorted doc signatures, once
    assert set(index._device_cache()) == {"sig", "seg", "offsets", "planes"}
