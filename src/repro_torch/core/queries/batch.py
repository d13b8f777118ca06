"""Batched query execution engine (the serving hot path).

Single-query execution (``phrase_count_query`` / ``boolean_query`` /
``ranked_query``) pays three per-query costs that a multi-user serving
workload should amortize:

  1. **Scoring** — every query scores its vector against all shard
     signatures alone (a GEMV per query).  ``QueryBatch`` plans the
     whole batch with one call to ``ApproxIndex.shard_similarities_batch``
     (one launch of the fused CUDA segment-sum kernel on a kernel-backed
     doc-granular index, so the [B, n_docs] intermediate never reaches
     device memory), and Boolean queries batch-score the union of their
     distinct words once before applying the AND->product / OR->sum
     algebra per expression.
  2. **Shard I/O and task overhead** — every query pps-samples and then
     visits its shards independently, so a shard sampled by k queries
     is dispatched k times.  The batch engine unions the per-query
     plans and runs one *shared scan* per distinct shard
     (``ShardTaskExecutor.map_shard_batch``), evaluating all interested
     queries in that single visit — task count scales with the union,
     not the sum.  On a multi-host topology the same union splits by
     shard residency instead of pooling locally: pass a
     ``runtime.placement.HostGroupExecutor`` as ``executor`` and each
     host shared-scans only its resident slice of the union, with the
     cross-host gather feeding the per-query reduces unchanged.  The
     executed plan is kept on ``last_report.plan`` so callers can audit
     it, and a balanced host group's split decision lands on
     ``last_report.balance``.
  3. **Scan work** — per-shard operators walk the lazily-built CSR
     postings (``data/store.shard_postings``), so the second query to
     touch a shard pays O(matching tokens), not O(shard tokens).

Statistical behavior is unchanged: each query still draws its own pps
sample from its own probability row (paper Eq 11), and the estimators
consume exactly the per-shard values the single-query path would have
produced — batching is purely an execution-layer rewrite, which is what
the parity tests pin down (the JAX package's engine and this one
agree bit for bit given the same probability rows).

Three serving-side extensions ride on the same machinery:

  * **Semantic query caching** — construct with a
    ``runtime.qcache.SemanticQueryCache`` and queries resolve against
    the index's own LSH signatures before planning: exact-signature
    hits return memoized results with zero scoring/draws/scans,
    near-hits within a Hamming radius reuse the cached sampling plan
    (unbiased for any sampling distribution — Hansen-Hurwitz) while
    re-running the scan + reduce, and misses stay bit-for-bit the
    uncached path.  Generation fencing (``runtime.generation``: a
    placement axis bumped by fleet swaps, a content axis bumped by
    live ingest / ``attach_corpus``) keeps cached plans and estimates
    from crossing either kind of world change; degraded and budgeted
    answers are never cached.  ``execute`` captures its corpus/index
    refs RCU-style at entry, so a concurrent ingest swap never splits
    a batch across generations and never pauses serving.

  * **Per-query error/latency budgets** — construct with a
    ``runtime.budget.RatePlanner`` and queries may carry a
    ``QueryBudget``; ``execute``'s ``rate`` argument becomes the
    *nominal* rate, and the planner picks each query's actual rate
    (smallest meeting an error budget, largest fitting a latency
    budget, degraded toward its floor under the controller's overload
    ``pressure``).  The per-query plans were always heterogeneous-safe:
    the shared scan unions whatever shard sets the samples produce.
    Queries without budgets keep the nominal rate bit-for-bit,
    including the precise rate>=1.0 fast path.
  * **Confidence intervals on every result** — count estimates always
    carry the closed-form Hansen-Hurwitz bound (Eq 2); with ``ci=True``
    Boolean results gain a bootstrap-over-sampled-shards CI on the
    result size and ranked results a bootstrap top-k stability score
    (``core.sampling.bootstrap_estimate`` /
    ``bootstrap_topk_stability``), so every answer ships as
    (estimate, ci_low, ci_high, achieved_rate).  The bootstrap uses
    its own deterministic generator — the sampling ``rng`` stream is
    never touched, so batched-vs-single draw-order parity holds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.index import ApproxIndex
from repro_torch.core.queries.aggregation import PhraseCountResult
from repro_torch.core.queries.retrieval import (
    BoolExpr,
    RankedResult,
    RetrievalResult,
    _expr_eval_docs,
    bm25_scores_for_shard,
)
from repro_torch.core.sampling import (
    Estimate,
    SampleResult,
    bootstrap_estimate,
    bootstrap_topk_stability,
    ht_estimate,
    pps_sample,
    pps_sample_distinct,
    similarity_probabilities,
    unique_shards,
)
from repro_torch.data.store import (
    ShardedCorpus,
    count_phrase_in_shard,
    shard_postings,
)
from repro_torch.runtime.generation import Generation
from repro_torch.runtime.qcache import query_cache_vectors, query_key, sampler_class


@dataclasses.dataclass(frozen=True)
class ExecutionReport:
    """Typed, JSON-clean record of one ``QueryBatch.execute`` call.

    One report per batch, on ``QueryBatch.last_report`` (the older
    ``last_plan`` / ``last_audit`` / ``last_budget`` / ``last_degraded``
    names survive as deprecated read-only properties reading through
    it; ``runtime/window.py`` reads ``last_budget``).

    ``plan`` is the *executed* plan — one array of scanned shard ids
    per query.  A semantic-cache exact hit executed nothing, so its
    slot is an empty array; ``cache`` carries the batch's cache outcome
    counts (hits / near_hits / misses / bypassed) when the engine has a
    ``SemanticQueryCache`` attached, None otherwise.
    """
    n_queries: int
    rate: float                          # nominal rate passed to execute
    elapsed_s: float
    rates: Tuple[float, ...]             # per-query effective rates
    plan: Tuple[np.ndarray, ...]         # executed shard ids per query
    balance: Optional[Dict[str, Any]] = None
    budget: Optional[Dict[str, Any]] = None
    degraded: Optional[Dict[str, Any]] = None
    cache: Optional[Dict[str, int]] = None

    def record(self) -> Dict[str, Any]:
        """JSON-serializable view (numpy arrays become int lists)."""
        return dict(
            n_queries=int(self.n_queries),
            rate=float(self.rate),
            elapsed_s=float(self.elapsed_s),
            rates=[float(r) for r in self.rates],
            plan=[[int(s) for s in p] for p in self.plan],
            balance=self.balance,
            budget=self.budget,
            degraded=self.degraded,
            cache=self.cache)


@dataclasses.dataclass(frozen=True)
class BatchQuery:
    """One query in a mixed batch: an aggregation phrase count, a
    Boolean retrieval, or a ranked (BM25 top-k) retrieval.

    ``budget`` (a ``runtime.budget.QueryBudget``) declares what the
    query may cost — an error budget, a latency budget, and a
    degradation floor.  It only takes effect when the executing
    ``QueryBatch`` carries a ``RatePlanner``; otherwise it is inert
    metadata and the query runs at the batch's nominal rate."""
    kind: str                                    # "count" | "bool" | "ranked"
    phrase: Optional[Tuple[int, ...]] = None     # kind == "count"
    expr: Optional[BoolExpr] = None              # kind == "bool"
    words: Optional[Tuple[int, ...]] = None      # kind == "ranked"
    k: int = 10                                  # kind == "ranked"
    budget: Optional[Any] = None                 # runtime.budget.QueryBudget

    @staticmethod
    def count(phrase: Sequence[int], budget=None) -> "BatchQuery":
        return BatchQuery("count", phrase=tuple(int(w) for w in phrase),
                          budget=budget)

    @staticmethod
    def boolean(expr: BoolExpr, budget=None) -> "BatchQuery":
        return BatchQuery("bool", expr=expr, budget=budget)

    @staticmethod
    def ranked(words: Sequence[int], k: int = 10,
               budget=None) -> "BatchQuery":
        return BatchQuery("ranked", words=tuple(int(w) for w in words),
                          k=k, budget=budget)

    def word_ids(self) -> List[int]:
        """The word ids whose vectors compose this query's scoring
        vector (Boolean queries score per-word instead)."""
        if self.kind == "count":
            return list(self.phrase)
        if self.kind == "ranked":
            return list(self.words)
        raise ValueError(f"no composed vector for kind {self.kind!r}")


class QueryBatch:
    """Plans, samples, and executes a mixed batch of queries end-to-end.

    One instance wraps a (corpus, index, executor) triple and is reused
    across batches; ``execute`` is the entry point.  Construction is
    cheap — all state lives in the arguments.  For serving a *stream*
    of queries, front this with ``runtime.window.BatchWindow``, which
    forms the batches adaptively (deadline- or size-closed) and runs
    them through ``execute`` on a warm executor pool.
    """

    def __init__(
        self,
        corpus: ShardedCorpus,
        index: Optional[ApproxIndex],
        *,
        executor=None,
        method: str = "emapprox",
        confidence: float = 0.95,
        planner=None,
        ci: bool = False,
        cache=None,
    ):
        if method not in ("emapprox", "srcs"):
            raise ValueError(f"unknown method {method!r}")
        if method == "emapprox" and index is None:
            raise ValueError("emapprox method requires an index")
        if cache is not None and index is None:
            raise ValueError("semantic query cache requires an index "
                             "(its keys are the index's LSH signatures)")
        # the engine's world is ONE tuple so RCU readers capture
        # (corpus, index) with a single atomic attribute load — a
        # concurrent ingest swap can never hand a batch a torn pair
        self._world = (corpus, index)
        self.executor = executor
        self.method = method
        self.confidence = confidence
        # ``planner`` (a runtime.budget.RatePlanner) turns the nominal
        # execute() rate into per-query rates honoring each query's
        # QueryBudget, and makes the engine accuracy-elastic under the
        # controller's degradation pressure (accepts_pressure below)
        self.planner = planner
        # ``ci=True`` adds bootstrap confidence intervals to Boolean /
        # ranked results (count bounds are closed-form and always on);
        # off by default because the bootstrap, while cheap, is not
        # free on the microsecond-scale serving hot path
        self.ci = bool(ci)
        # ``cache`` (a runtime.qcache.SemanticQueryCache) memoizes
        # per-query plans and results under the index's LSH signatures:
        # exact hits skip scoring, sampling, and the scan entirely;
        # near hits reuse the sampled shard plan and re-run the cheap
        # reduce.  Misses stay bit-for-bit the uncached path.
        self.cache = cache
        # the typed record of the most recent execute() call
        self.last_report: Optional[ExecutionReport] = None

    # ------------------------------------------------------------------
    # the world: (corpus, index) behind one atomic reference
    # ------------------------------------------------------------------
    @property
    def corpus(self) -> ShardedCorpus:
        return self._world[0]

    @corpus.setter
    def corpus(self, corpus) -> None:
        self._world = (corpus, self._world[1])

    @property
    def index(self) -> Optional[ApproxIndex]:
        return self._world[1]

    @index.setter
    def index(self, index) -> None:
        self._world = (self._world[0], index)

    def swap_world(self, corpus, index) -> None:
        """Publish a new (corpus, index) pair in one store — the RCU
        write side of live ingest.  Individual ``corpus``/``index``
        assignment still works but publishes in two stores; a swap
        that changes both MUST go through here (or a racing reader
        could capture a torn pair)."""
        self._world = (corpus, index)

    @property
    def accepts_pressure(self) -> bool:
        """Whether ``execute`` understands the ``pressure`` kwarg —
        i.e. the engine can trade accuracy for capacity.  BatchWindow
        checks this before forwarding the controller's degradation
        pressure (and before preferring degradation over shedding)."""
        return self.planner is not None

    # ------------------------------------------------------------------
    # deprecated read-only views of last_report (pre-report callers)
    # ------------------------------------------------------------------
    @property
    def last_plan(self) -> Optional[List[np.ndarray]]:
        """Deprecated: read ``last_report.plan`` — the executed shard
        plan (one array of scanned shard ids per query)."""
        r = self.last_report
        return list(r.plan) if r is not None else None

    @property
    def last_audit(self) -> Optional[Dict[str, Any]]:
        """Deprecated: read ``last_report.balance`` — the balanced
        host group's split audit, None otherwise."""
        r = self.last_report
        return r.balance if r is not None else None

    @property
    def last_budget(self) -> Optional[Dict[str, Any]]:
        """Deprecated: read ``last_report.budget`` — the planner's
        budget audit record, None without a planner."""
        r = self.last_report
        return r.budget if r is not None else None

    @property
    def last_degraded(self) -> Optional[Dict[str, Any]]:
        """Deprecated: read ``last_report.degraded`` — the partial
        gather record (lost shards, per-query breakdown), None on the
        healthy path."""
        r = self.last_report
        return r.degraded if r is not None else None

    # ------------------------------------------------------------------
    # planning: one batched scoring pass -> per-query probability rows
    # ------------------------------------------------------------------
    def _probability_rows(
            self, queries: Sequence[BatchQuery], corpus: ShardedCorpus,
            index: Optional[ApproxIndex]) -> List[np.ndarray]:
        # corpus/index come in as the refs execute() captured at entry
        # (RCU: a concurrent ingest swap must not split one batch
        # across two content generations)
        n_shards = corpus.n_shards
        if self.method == "srcs":
            uniform = np.full(n_shards, 1.0 / n_shards, np.float64)
            return [uniform] * len(queries)
        # one batched scoring pass for all vector-composed queries ...
        vec_pos = [i for i, q in enumerate(queries) if q.kind != "bool"]
        rows: List[Optional[np.ndarray]] = [None] * len(queries)
        if vec_pos:
            sims = index.shard_similarities_batch(
                [queries[i].word_ids() for i in vec_pos])
            for row, i in zip(sims, vec_pos):
                rows[i] = similarity_probabilities(row)
        # ... and one for the union of Boolean query words
        bool_pos = [i for i, q in enumerate(queries) if q.kind == "bool"]
        if bool_pos:
            words = sorted({w for i in bool_pos
                            for w in queries[i].expr.words()})
            word_rows = dict(zip(
                words, index.word_shard_similarities_batch(words)))

            def algebra(e: BoolExpr) -> np.ndarray:
                if e.op == "word":
                    return word_rows[e.word]
                l, r = algebra(e.left), algebra(e.right)
                return l * r if e.op == "and" else l + r

            for i in bool_pos:
                rows[i] = similarity_probabilities(algebra(queries[i].expr))
        return rows

    # ------------------------------------------------------------------
    # per-query shard tasks
    # ------------------------------------------------------------------
    @staticmethod
    def _shard_fn(q: BatchQuery, doc_freq: np.ndarray, n_docs: int,
                  avg_len: float) -> Callable[[Any], Any]:
        if q.kind == "count":
            if len(q.phrase) == 1:
                w = q.phrase[0]
                return lambda shard: shard_postings(shard).word_count(w)
            return lambda shard: count_phrase_in_shard(shard, q.phrase)
        if q.kind == "bool":
            return lambda shard: shard.doc_ids[_expr_eval_docs(q.expr, shard)]
        if q.kind == "ranked":
            return lambda shard: (shard.doc_ids, bm25_scores_for_shard(
                shard, q.words, doc_freq, n_docs, avg_len))
        raise ValueError(f"unknown query kind {q.kind!r}")

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute(
        self,
        queries: Sequence[BatchQuery],
        rate: float,
        rng: Optional[np.random.Generator] = None,
        *,
        pressure: float = 0.0,
    ) -> List[Any]:
        """Run the batch; returns one result per query, in order:
        ``PhraseCountResult`` / ``RetrievalResult`` / ``RankedResult``
        (the same types the single-query entry points return).

        ``elapsed_s`` on every result is the wall time of the *whole*
        batch — under shared scans per-query attribution is not well
        defined; divide by ``len(queries)`` for amortized latency.

        Sampling draws happen in query order from ``rng``, so a batch
        reproduces the exact sample sequence of a single-query loop
        over the same queries with the same generator.

        With a planner, ``rate`` is the nominal rate and each query
        samples at its own planned rate (its budget inverted through
        the planner's error/latency models, degraded toward its floor
        by ``pressure`` in [0, 1] — the controller's overload signal,
        forwarded by ``BatchWindow``).  Queries at a planned rate
        >= 1.0 take the precise path individually, so an unbudgeted
        batch at nominal rate 1.0 stays bit-for-bit the precise
        fast path.

        With a semantic cache attached, queries resolve against it
        before planning: exact-signature hits return their memoized
        result (no scoring, no draws, no scan — and no rng
        consumption, so the remaining misses draw exactly what they
        would draw in a batch of their own), near-hits borrow the
        cached sampling plan and re-run only the scan + reduce, and
        misses execute bit-for-bit the uncached path.  Budgeted
        queries and pressure-degraded batches bypass the cache in both
        directions: a planned-rate or partial answer is a
        point-in-time decision, never replayable as full fidelity.
        """
        rng = rng or np.random.default_rng(0)
        t0 = time.perf_counter()
        # RCU entry: read the generation BEFORE capturing the corpus /
        # index refs.  The ingest swap publishes new refs first and
        # bumps the content generation second, so this order can at
        # worst stamp a new-content result with the old generation (an
        # entry the very next probe drops) — never the reverse, which
        # would let an old-content answer serve under the new
        # generation.  The whole batch then runs against the captured
        # refs: a concurrent swap never splits one batch across two
        # content generations.
        epoch = self._generation() if self.cache is not None else 0
        corpus, index = self._world
        n_shards = corpus.n_shards
        n = len(queries)

        if self.planner is not None:
            rates, audit = self.planner.plan_batch(queries, rate, pressure)
        else:
            rates, audit = [float(rate)] * n, None

        # ---- semantic cache probe (before planning) ----
        hits: Dict[int, Any] = {}
        near: Dict[int, Any] = {}
        cache_meta: Optional[Dict[str, int]] = None
        sigs = qkeys = None
        if self.cache is not None and n:
            sigs = index.query_signatures(
                query_cache_vectors(index, queries))
            qkeys = [query_key(q) for q in queries]
            bypassed = 0
            for i, q in enumerate(queries):
                if pressure > 0.0 or q.budget is not None:
                    bypassed += 1
                    self.cache.stats["bypassed"] += 1
                    continue
                outcome, entry = self.cache.lookup(
                    sigs[i], qkeys[i], sampler_class(q.kind),
                    rates[i], epoch)
                if outcome == "hit":
                    hits[i] = entry
                elif outcome == "near":
                    near[i] = entry
            cache_meta = dict(
                hits=len(hits), near_hits=len(near),
                misses=n - len(hits) - len(near) - bypassed,
                bypassed=bypassed)

        all_ids = np.arange(n_shards, dtype=np.int64)
        uniform = np.full(n_shards, 1.0 / n_shards, np.float64)
        census = SampleResult(all_ids, uniform, 1.0)
        samples: List[Optional[SampleResult]] = [None] * n
        plan: List[Optional[np.ndarray]] = [None] * n
        for i, e in list(hits.items()) + list(near.items()):
            samples[i], plan[i] = e.sample, e.plan
        need = [i for i in range(n) if samples[i] is None]
        rows_by_pos: Dict[int, np.ndarray] = {}
        if need and all(rates[i] >= 1.0 for i in need):
            for i in need:
                samples[i], plan[i] = census, all_ids
        elif need:
            rows = self._probability_rows(
                [queries[i] for i in need], corpus, index)
            # aggregation keeps the with-replacement multiset (the
            # Hansen-Hurwitz estimator needs it); retrieval unions docs
            # over the sample, so it draws distinct shards — same
            # samplers, in the same query order, as the single-query
            # entry points (pinned by the parity tests).  Per-query
            # precise rates draw nothing, exactly as the single-query
            # precise path draws nothing; cache-resolved queries draw
            # nothing either, so the misses' draw sequence matches a
            # batch of only the misses.
            for i, row in zip(need, rows):
                r, q = rates[i], queries[i]
                if r >= 1.0:
                    samples[i], plan[i] = census, all_ids
                    continue
                rows_by_pos[i] = row
                samples[i] = (pps_sample(row, r, rng) if q.kind == "count"
                              else pps_sample_distinct(row, r, rng))
                plan[i] = unique_shards(samples[i])

        if index is not None:
            doc_freq = index.doc_freq
            n_docs, avg_len = index.n_docs, index.avg_doc_len
        else:
            doc_freq = np.ones(corpus.vocab_size, np.int64)
            n_docs = corpus.n_docs
            avg_len = corpus.n_tokens / max(n_docs, 1)
        fns = [self._shard_fn(q, doc_freq, n_docs, avg_len) for q in queries]

        # exact hits scan nothing: their slot in the executed plan is
        # empty, and an all-hit batch skips executor dispatch entirely
        empty = np.zeros(0, np.int64)
        scan_plan = [empty if i in hits else plan[i] for i in range(n)]
        if n and len(hits) == n:
            per_query: List[Dict[int, Any]] = [{} for _ in range(n)]
            job, balance = None, None
        elif self.executor is not None:
            per_query = self.executor.map_shard_batch(
                corpus, scan_plan, fns)
            job = getattr(self.executor, "last_job", None)
            balance = (dict(job["balance"])
                       if isinstance(job, dict) and "balance" in job
                       else None)
        else:
            per_query = self._inline_shared_scan(scan_plan, fns, corpus)
            job, balance = None, None

        # partial gather (allow_partial executors only): shards whose
        # hosts all died never produced results — each affected query
        # reduces over its surviving sample with a widened CI instead
        # of the whole batch aborting
        lost_total = (int(job.get("lost_shards", 0))
                      if isinstance(job, dict) else 0)
        lost_per_query = [0] * n
        degraded = None
        if lost_total:
            lost_per_query = [
                sum(1 for s in scan_plan[i] if int(s) not in per_query[i])
                for i in range(n)]
            degraded = dict(
                lost_shards=lost_total,
                degraded_queries=sum(1 for k in lost_per_query if k),
                lost_per_query=lost_per_query)

        elapsed = time.perf_counter() - t0
        results = [
            hits[i].result._replace(elapsed_s=elapsed) if i in hits
            else self._reduce(queries[i], samples[i], plan[i], per_query[i],
                              elapsed, rates[i] >= 1.0, n_shards,
                              lost=lost_per_query[i])
            for i in range(n)]

        # populate: misses and near-hits insert their own full-fidelity
        # entries; degraded answers (lost draws) never enter the cache
        if self.cache is not None and n:
            for i, q in enumerate(queries):
                if (i in hits or pressure > 0.0 or q.budget is not None
                        or lost_per_query[i]):
                    continue
                self.cache.insert(
                    sigs[i], qkeys[i], sampler_class(q.kind), rates[i],
                    probs=rows_by_pos.get(i), sample=samples[i],
                    plan=plan[i], result=results[i], epoch=epoch)

        budget = self._feedback(queries, rates, results, audit, job,
                                degraded)
        self.last_report = ExecutionReport(
            n_queries=n, rate=float(rate), elapsed_s=elapsed,
            rates=tuple(float(r) for r in rates), plan=tuple(scan_plan),
            balance=balance, budget=budget, degraded=degraded,
            cache=cache_meta)
        return results

    def _generation(self) -> Generation:
        """The engine's composite ``Generation`` — the fencing value
        cache entries are stamped with and probed against.

        The *placement* axis comes from the executor's
        ``GenerationClock`` (every RCU placement swap — fleet
        join/drain/crash, ingest shard growth — bumps it), falling
        back to the deprecated ``stats["placement_epoch"]`` view for
        clock-less executors; executors without placement (single
        host, inline) are placement 0.  The *content* axis comes from
        the index's clock (live ingest swaps and ``attach_corpus``
        bump it) — this is what lets the cache see corpus changes that
        leave placement untouched."""
        clock = getattr(self.executor, "clock", None)
        placement = (clock.current().placement if clock is not None
                     else self._cache_epoch())
        content = (self.index.clock.current().content
                   if self.index is not None else 0)
        return Generation(placement=placement, content=content)

    def _cache_epoch(self) -> int:
        """Deprecated: the raw placement int read off executor stats.
        Kept as the fallback placement source for executors predating
        ``GenerationClock`` — it cannot see content changes, which is
        why ``_generation`` exists."""
        stats = getattr(self.executor, "stats", None)
        if isinstance(stats, dict):
            return int(stats.get("placement_epoch", 0))
        return 0

    def _feedback(self, queries: Sequence[BatchQuery],
                  rates: Sequence[float], results: Sequence[Any],
                  audit, job, degraded) -> Optional[Dict[str, Any]]:
        """Close the planning loop: fold every realized (sample size,
        relative error) back into the planner's per-kind error curves,
        complete the batch's ``BudgetAudit`` with realized errors, and
        attach its record to the executor's ``last_job["budget"]`` (the
        budget analogue of the balance audit).  Returns the budget
        record for the batch's ``ExecutionReport``."""
        if self.planner is None or audit is None:
            return None
        realized: List[Optional[float]] = []
        for q, r, res in zip(queries, rates, results):
            est = getattr(res, "estimate", None)
            if est is None:
                realized.append(None)
                continue
            # ranked stability is a score in [0, 1]; its error is the
            # instability (1 - value), already relative
            rel = (1.0 - est.value if q.kind == "ranked"
                   else est.relative_error)
            realized.append(rel)
            conf = (q.budget.confidence if q.budget is not None
                    else self.confidence)
            self.planner.observe_result(q.kind, r, est.n, rel, conf)
        audit.realized_rel_error = realized
        if degraded is not None:
            audit.partial_queries = degraded["degraded_queries"]
            audit.lost_shards = degraded["lost_shards"]
        budget = audit.record()
        if isinstance(job, dict):
            job["budget"] = budget
        return budget

    def _inline_shared_scan(
        self,
        plan: Sequence[np.ndarray],
        fns: Sequence[Callable[[Any], Any]],
        corpus: ShardedCorpus,
    ) -> List[Dict[int, Any]]:
        """Executor-less fallback: the same union-and-visit-once
        schedule (``run_shared_scan``), run sequentially in-process
        over the corpus ref ``execute`` captured at entry."""
        from repro_torch.runtime.executor import run_shared_scan

        def inline_mapper(corpus, shard_ids, fn):
            return {sid: fn(corpus.shards[sid]) for sid in shard_ids}

        return run_shared_scan(inline_mapper, corpus, plan, fns)

    def _reduce(self, q: BatchQuery, sample: SampleResult,
                distinct: np.ndarray, by_shard: Dict[int, Any],
                elapsed: float, precise: bool, n_shards: int,
                lost: int = 0) -> Any:
        conf = (q.budget.confidence if q.budget is not None
                else self.confidence)
        if lost:
            # degraded reduce: drop the unreachable shards from the
            # sample and the visit set and run the normal estimators
            # over the survivors.  Host loss is independent of shard
            # values, so Hansen-Hurwitz over the surviving draws stays
            # unbiased — the CI simply widens with the smaller sample
            # (fewer draws, fewer distinct shards of t-df).  A census
            # that lost shards is no longer precise: it degrades to
            # the same surviving-sample estimator.
            keep = np.asarray([int(s) in by_shard
                               for s in sample.shard_ids], bool)
            sample = SampleResult(sample.shard_ids[keep],
                                  sample.probabilities, sample.rate)
            distinct = np.asarray([s for s in distinct
                                   if int(s) in by_shard], np.int64)
            precise = False
        if q.kind == "count":
            if precise:
                total = float(sum(by_shard.values()))
                est = Estimate(total, 0.0, conf, n_shards)
            elif len(sample.shard_ids) == 0:
                # every draw lost: no information, infinite bound
                est = Estimate(0.0, float("inf"), conf, 0)
            else:
                local = np.asarray([by_shard[int(s)]
                                    for s in sample.shard_ids], np.float64)
                est = ht_estimate(local, sample, conf)
            return PhraseCountResult(est, sample, len(distinct), n_shards,
                                     elapsed, lost)
        if q.kind == "bool":
            hits = [by_shard[int(s)] for s in distinct]
            doc_ids = (np.concatenate(hits) if hits
                       else np.zeros(0, np.int64))
            est = None
            if self.ci:
                if precise:
                    est = Estimate(float(len(np.unique(doc_ids))), 0.0,
                                   conf, n_shards)
                else:
                    # result-size CI by resampling the per-shard hit
                    # counts; a fresh deterministic generator so the
                    # sampling rng stream stays parity-exact
                    local = np.asarray([len(by_shard[int(s)])
                                        for s in sample.shard_ids],
                                       np.float64)
                    est = bootstrap_estimate(
                        local, sample, conf,
                        rng=np.random.default_rng(len(distinct)))
            return RetrievalResult(np.unique(doc_ids), sample, len(distinct),
                                   n_shards, elapsed, est, lost)
        parts = [by_shard[int(s)] for s in distinct]
        if parts:
            ids = np.concatenate([p[0] for p in parts])
            sc = np.concatenate([p[1] for p in parts])
        else:
            ids, sc = np.zeros(0, np.int64), np.zeros(0, np.float64)
        order = np.argsort(-sc, kind="stable")[:q.k]
        est = None
        if self.ci:
            if precise:
                est = Estimate(1.0, 0.0, conf, n_shards)
            else:
                est = bootstrap_topk_stability(
                    parts, q.k, conf,
                    rng=np.random.default_rng(len(distinct)))
        return RankedResult(ids[order], sc[order], sample, len(distinct),
                            n_shards, elapsed, est, lost)
