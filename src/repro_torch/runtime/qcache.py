"""Semantic query cache keyed on the index's own LSH signatures.

Real query traffic is power-law: a small set of hot and near-duplicate
queries dominates.  The serving stack already embeds every query into
the PV-DBOW space and signs it (``core/lsh.py``) — so the cache key is
free: ``SemanticQueryCache`` memoizes per-query execution state under
the packed SimHash signature of the query's composed scoring vector.

Three outcomes per probe:

  **hit**   — same signature, same query key (kind + words/expr + k),
              same effective sampling rate, same generation, not
              expired.  The engine returns the memoized full result
              (estimate + CI included) with zero scoring, zero rng
              draws, and zero shard scans — the p50 collapse under
              skewed traffic.  The memoized shard-similarity
              distribution and sampled plan ride on the entry for
              callers that want them.
  **near**  — a *different* query whose signature lies within
              ``hamming_radius`` bits of a cached entry of the same
              sampler class ("hh" with-replacement for counts,
              "distinct" for boolean/ranked) at the same rate.  The
              engine reuses the cached shard *plan* — the draws
              together with the probabilities that produced them — and
              re-runs the cheap scan + reduce with the new query's
              per-shard operator.  Unbiasedness survives because the
              Hansen-Hurwitz estimator is unbiased for *any* sampling
              distribution with full support: E[sum tau_s/phi_s] = tau
              regardless of which query's similarities shaped phi.
              The borrowed plan is merely (slightly) higher-variance
              for the new query, never wrong on average.
  **miss**  — the engine plans/samples/executes normally (bit-for-bit
              identical to an uncached engine) and populates the cache
              afterwards.

Invalidation is layered:

  * **generation** — every entry records the engine's
    ``runtime.generation.Generation`` at insert: the *placement* axis
    (``FleetManager`` join/drain/crash all install a new placement
    RCU-style) AND the *content* axis (live ingest swaps / a corpus
    ``attach_corpus``).  A probe under any other generation drops the
    entry lazily (counted in ``stats["stale_epoch"]``) — a cached plan
    from the old fleet can never serve the new one, and a cached
    *estimate* computed over the old corpus can never answer a query
    over the new one.  The cache itself only ever compares epochs for
    equality, so the deprecated raw-int probe (pre-generation callers
    passing ``stats["placement_epoch"]``) keeps working verbatim —
    but it cannot see content changes.
  * **TTL** — wall-clock expiry per entry (``ttl_s``).
  * **LRU** — ``max_entries`` bound, least-recently-used evicted.

What is *never* cached (fidelity fencing, enforced by the engine):
degraded results (``lost_shards > 0``), anything executed under
degradation pressure, and budget-carrying queries whose planned rates
are point-in-time decisions — a budgeted answer must never be replayed
as a full-fidelity one.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.lsh import packed_hamming_np

# sampler compatibility classes: aggregation draws a with-replacement
# multiset (Hansen-Hurwitz needs it), retrieval draws distinct shards
# (Efraimidis-Sampford-style) — a plan is only reusable within its class
_SAMPLER_CLASS = {"count": "hh", "bool": "distinct", "ranked": "distinct"}


def sampler_class(kind: str) -> str:
    """"hh" | "distinct" — which plans are statistically interchangeable."""
    return _SAMPLER_CLASS[kind]


def query_key(q) -> Tuple:
    """Hashable canonical identity of a ``BatchQuery`` — what must match
    *exactly* (beyond the signature) for a memoized result to be the
    answer to this query."""
    if q.kind == "count":
        return ("count", q.phrase)
    if q.kind == "ranked":
        return ("ranked", q.words, int(q.k))
    return ("bool", _expr_key(q.expr))


def _expr_key(e) -> Tuple:
    if e.op == "word":
        return ("w", int(e.word))
    return (e.op, _expr_key(e.left), _expr_key(e.right))


def query_cache_vectors(index, queries) -> np.ndarray:
    """[B, dim] key vectors for a mixed batch: the composed scoring
    vector for count/ranked queries; for Boolean queries the sum of the
    expression's distinct word vectors (the expression *structure*
    rides in the exact-match key — the vector only drives similarity)."""
    vecs = []
    for q in queries:
        if q.kind == "bool":
            words = sorted(set(q.expr.words()))
            vecs.append(index.word_vecs[np.asarray(words, np.int64)]
                        .sum(axis=0))
        else:
            vecs.append(index.query_vector(q.word_ids()))
    return np.stack(vecs)


@dataclasses.dataclass(frozen=True)
class QueryCacheConfig:
    """Knobs for ``SemanticQueryCache``.

    ``hamming_radius`` is in signature bits: 0 restricts plan reuse to
    signature-identical queries; the default trades a little estimator
    variance for plan reuse across near-duplicates (at 128-bit
    signatures, 8 bits ~ cos(pi*8/128) ~ 0.98 cosine similarity)."""
    max_entries: int = 256
    ttl_s: float = 30.0
    hamming_radius: int = 8

    def __post_init__(self):
        if self.max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {self.max_entries}")
        if self.ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0: {self.ttl_s}")
        if self.hamming_radius < 0:
            raise ValueError(
                f"hamming_radius must be >= 0: {self.hamming_radius}")


class _Entry:
    __slots__ = ("key", "sig", "sampler", "rate", "probs", "sample",
                 "plan", "result", "epoch", "born")

    def __init__(self, key, sig, sampler, rate, probs, sample, plan,
                 result, epoch, born):
        self.key = key          # exact-probe key (sig bytes, qkey, rate)
        self.sig = sig          # [W] packed uint32 signature
        self.sampler = sampler  # "hh" | "distinct"
        self.rate = rate
        self.probs = probs      # shard-similarity distribution (or None)
        self.sample = sample    # core.sampling.SampleResult (the plan)
        self.plan = plan        # distinct sampled shard ids [k]
        self.result = result    # full memoized result (estimate + CI)
        self.epoch = epoch      # Generation (or deprecated int) at insert
        self.born = born


class SemanticQueryCache:
    """LSH-signature-keyed memo of (plan, distribution, result) per
    query, with TTL + generation invalidation and an LRU bound.

    Not thread-safe by design: the engine probes and populates it from
    within ``QueryBatch.execute``, which the ``BatchWindow`` dispatcher
    already serializes.  ``clock`` is injectable for deterministic TTL
    tests."""

    def __init__(self, config: Optional[QueryCacheConfig] = None, *,
                 clock=time.monotonic):
        self.config = config or QueryCacheConfig()
        self._clock = clock
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self.stats: Dict[str, int] = dict(
            hits=0, near_hits=0, misses=0, bypassed=0,
            insertions=0, evictions=0, expired=0, stale_epoch=0)

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    # probe
    # ------------------------------------------------------------------
    def _valid(self, e: _Entry, epoch, now: float) -> bool:
        """Drop-on-probe validation; counts the reason.  ``epoch`` is a
        ``Generation`` (equality compares both axes) or a deprecated
        raw int — the cache only needs ``!=``."""
        if e.epoch != epoch:
            del self._entries[e.key]
            self.stats["stale_epoch"] += 1
            return False
        if now - e.born > self.config.ttl_s:
            del self._entries[e.key]
            self.stats["expired"] += 1
            return False
        return True

    def lookup(self, sig: np.ndarray, qkey: Tuple, sampler: str,
               rate: float, epoch) -> Tuple[str, Optional[_Entry]]:
        """("hit" | "near" | "miss", entry-or-None) for one query.

        ``epoch`` is the probing engine's ``Generation`` (or a
        deprecated raw placement int, still accepted)."""
        now = self._clock()
        key = (sig.tobytes(), qkey, float(rate))
        e = self._entries.get(key)
        if e is not None and self._valid(e, epoch, now):
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            return "hit", e
        # near probe: nearest valid same-class same-rate entry within
        # the Hamming radius (a vectorized scan — the LRU bound keeps
        # the candidate set small)
        cands = [c for c in list(self._entries.values())
                 if c.sampler == sampler and c.rate == float(rate)
                 and self._valid(c, epoch, now)]
        if cands:
            d = packed_hamming_np(sig, np.stack([c.sig for c in cands]))[0]
            best = int(np.argmin(d))
            if int(d[best]) <= self.config.hamming_radius:
                e = cands[best]
                self._entries.move_to_end(e.key)
                self.stats["near_hits"] += 1
                return "near", e
        self.stats["misses"] += 1
        return "miss", None

    # ------------------------------------------------------------------
    # populate
    # ------------------------------------------------------------------
    def insert(self, sig: np.ndarray, qkey: Tuple, sampler: str,
               rate: float, *, probs: Optional[np.ndarray], sample,
               plan: np.ndarray, result: Any, epoch) -> None:
        key = (sig.tobytes(), qkey, float(rate))
        # the epoch is stored as handed in (Generation or deprecated
        # int) — validation is pure equality, so no coercion is needed
        # and int-era callers keep their exact semantics
        self._entries[key] = _Entry(
            key, np.asarray(sig, np.uint32), sampler, float(rate),
            probs, sample, plan, result, epoch, self._clock())
        self._entries.move_to_end(key)
        self.stats["insertions"] += 1
        while len(self._entries) > self.config.max_entries:
            self._entries.popitem(last=False)
            self.stats["evictions"] += 1

    # ------------------------------------------------------------------
    # maintenance / introspection
    # ------------------------------------------------------------------
    def purge(self, epoch=None) -> int:
        """Eagerly drop expired (and, given ``epoch``, stale) entries;
        returns how many were dropped."""
        now = self._clock()
        dropped = 0
        for e in list(self._entries.values()):
            if e.key not in self._entries:
                continue
            if epoch is not None and e.epoch != epoch:
                del self._entries[e.key]
                self.stats["stale_epoch"] += 1
                dropped += 1
            elif now - e.born > self.config.ttl_s:
                del self._entries[e.key]
                self.stats["expired"] += 1
                dropped += 1
        return dropped

    def clear(self) -> None:
        self._entries.clear()

    def entries(self) -> List[_Entry]:
        """Snapshot of live entries, LRU-oldest first (for tests)."""
        return list(self._entries.values())

    def record(self) -> Dict[str, Any]:
        """JSON-ready counters + configuration snapshot."""
        return dict(
            size=len(self._entries),
            max_entries=int(self.config.max_entries),
            ttl_s=float(self.config.ttl_s),
            hamming_radius=int(self.config.hamming_radius),
            **{k: int(v) for k, v in self.stats.items()})
