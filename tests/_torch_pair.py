"""Helpers shared by the port's serving-runtime tests: the two packages
side by side, the same corpus and index in each, and comparisons of
their results.

``PKG["jax"]`` and ``PKG["port"]`` hold each package's modules under the
same names, so one scenario function runs through both: ``both(fn)``
calls ``fn(PKG["jax"])`` and ``fn(PKG["port"])`` and asserts that the
two records (plain data: numbers, strings, lists, dicts, arrays) are
equal, exactly."""
import dataclasses
from types import SimpleNamespace

import numpy as np

import repro.core.queries as jq
import repro.launch.serve_stack as jstack
import repro.runtime.balance as jbal
import repro.runtime.budget as jbud
import repro.runtime.chaos as jchaos
import repro.runtime.controller as jctl
import repro.runtime.executor as jexe
import repro.runtime.fleet as jfleet
import repro.runtime.placement as jplace
import repro.runtime.window as jwin
import repro_torch.core.queries as tq
import repro_torch.data.store as tstore
import repro_torch.launch.serve_stack as tstack
import repro_torch.runtime.balance as tbal
import repro_torch.runtime.budget as tbud
import repro_torch.runtime.chaos as tchaos
import repro_torch.runtime.controller as tctl
import repro_torch.runtime.executor as texe
import repro_torch.runtime.fleet as tfleet
import repro_torch.runtime.placement as tplace
import repro_torch.runtime.window as twin
from repro_torch.core import index as tindex

PKG = {
    "jax": SimpleNamespace(name="jax", balance=jbal, budget=jbud,
                           chaos=jchaos, controller=jctl, executor=jexe,
                           fleet=jfleet, placement=jplace, window=jwin,
                           queries=jq, stack=jstack),
    "port": SimpleNamespace(name="port", balance=tbal, budget=tbud,
                            chaos=tchaos, controller=tctl, executor=texe,
                            fleet=tfleet, placement=tplace, window=twin,
                            queries=tq, stack=tstack),
}


def plain(x):
    """A record made comparable across packages: arrays to lists, numpy
    scalars to Python ones, dataclasses and tuples to plain containers."""
    if isinstance(x, np.ndarray):
        return [plain(v) for v in x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def both(fn):
    """Run ``fn`` through the JAX package and the port; assert equal
    records; return the port's."""
    want = plain(fn(PKG["jax"]))
    got = plain(fn(PKG["port"]))
    assert got == want
    return got


class FakeShard:
    def __init__(self, i):
        self.shard_id = i


class FakeCorpus:
    def __init__(self, n):
        self.shards = [FakeShard(i) for i in range(n)]


def port_corpus(corpus):
    """The port's corpus over the same documents and shards."""
    return tstore.ShardedCorpus(
        [tstore.DocShard(s.shard_id, s.tokens, s.offsets, s.doc_ids)
         for s in corpus.shards], corpus.vocab_size)


def port_index(index, path):
    """The port's CPU load of a JAX index (its npz format)."""
    index.save(str(path))
    return tindex.ApproxIndex.load(str(path), device="cpu")


def mixed_queries(m):
    p = m.queries.parse_boolean
    return [m.queries.BatchQuery.count([3]),
            m.queries.BatchQuery.boolean(p([3, "or", 5, "and", 9])),
            m.queries.BatchQuery.ranked([7, 4, 5], k=10),
            m.queries.BatchQuery.count([11]),
            m.queries.BatchQuery.ranked([2, 10], k=5),
            m.queries.BatchQuery.boolean(p([2, "and", 7]))]


def result_record(results):
    """What a batch answered, per query: the shards read and the
    estimate or the doc ids (and scores)."""
    out = []
    for r in results:
        rec = dict(kind=type(r).__name__, shards_read=int(r.shards_read),
                   lost=int(getattr(r, "lost_shards", 0)))
        if hasattr(r, "doc_ids"):
            rec["doc_ids"] = np.asarray(r.doc_ids).tolist()
            if hasattr(r, "scores"):
                rec["scores"] = np.asarray(r.scores).tolist()
        else:
            rec["value"] = float(r.estimate.value)
            rec["bound"] = float(r.estimate.error_bound)
        out.append(rec)
    return out


def inject_rows(engine, rows):
    """Pin an engine's planning to the given probability rows (both
    packages sample from numpy's RNG, so equal rows give equal plans)."""
    engine._probability_rows = lambda *a: rows
    return engine
