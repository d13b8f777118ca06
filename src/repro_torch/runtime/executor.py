"""Fault-tolerant shard-task executor (the query-side runtime).

This is the Spark-executor analogue for EmApprox query jobs: per-shard
tasks run on a worker pool with

  * retry on failure (transient worker faults) with *bounded
    exponential backoff*: the ``r``-th retry of a shard waits
    ``retry_backoff_s * 2**(r-1)`` (capped at ``retry_backoff_cap_s``)
    before resubmitting, so a flaky dependency is not hammered at
    queue speed,
  * a per-job deadline (``job_deadline_s``): a job that cannot finish
    in time stops retrying and — with ``allow_partial=True`` — returns
    the shards it *did* complete, recording the rest on
    ``last_job["lost_shards"]`` so the query layer can degrade to a
    partial-sample estimate with a widened CI instead of failing the
    whole batch (without ``allow_partial`` the deadline raises
    ``ShardTaskError`` exactly like exhausted retries),
  * straggler mitigation: when the slowest ~tail of tasks exceeds
    ``straggler_factor``x the median completion time, duplicates are
    speculatively launched and the first finisher wins (the classic
    MapReduce backup-task trick),
  * elastic worker count: pool size can change between jobs,
  * a *warm* pool: the thread pool is built lazily on the first job and
    kept alive across jobs (long-lived serving was paying a pool
    construction + teardown per batch), rebuilt only when the target
    worker count changes; ``close()`` (or the context manager) tears it
    down,
  * adaptive worker count by task granularity
    (``adaptive_workers=True``): tiny numpy tasks are GIL-bound — the
    lock convoy makes 4+ workers *slower* than 1-2 — so when the last
    job's median task time falls under ``gil_floor_s`` the pool shrinks
    to 2 workers; it widens back to ``workers`` as soon as tasks are
    long enough to release the GIL meaningfully.

This executor is the *single-host* layer: it treats every shard it is
handed as locally resident.  Failure injection for tests is via
``fault_hook`` which may raise on chosen shards.

Shared-scan scheduling (``map_shard_batch``): a batch of queries, each
with its own sampled shard plan, is inverted into one task per shard in
the *union* of the plans; visiting a shard evaluates every query that
sampled it in a single pass.  I/O and task overhead scale with the
union size instead of the sum of per-query plan sizes, and retry /
speculation apply to the composite shard task, so a retried shard
re-evaluates all of its queries (same at-least-once semantics as
``map_shards``).  The schedule itself (invert the plans, visit once,
scatter back per query) is ``run_shared_scan`` — one definition shared
by this executor and the executor-less inline fallback in
``core/queries/batch.py``, so the schedules cannot diverge.

Fault injection has two seams: ``fault_hook(shard_id, attempt)`` (the
raise-to-fail hook) and ``task_hook(shard_id, attempt, job)`` — the
per-shard-task hook carrying the executor's job index, so a scripted
fault plan can target "shard tasks during jobs 3..5" without keeping
its own clock.  ``job_hook(job)`` fires once at job start.

One-launch megascan route (``megakernel``): when the scan fns come from
one ``kernels/megascan`` ``MegascanSpec``, the whole shard group runs as
ONE kernel launch (``_run_group_scan``) instead of one task per shard,
with the per-(query, shard) results in the same layout and bit for bit
the per-shard route's.  This is the serving runtime of the JAX
package's ``runtime/executor.py``.  ``runtime/placement.HostGroupExecutor``
stacks on top (one ``ShardTaskExecutor`` per simulated host), and
``run_shared_scan`` is generic over the mapper so both share it.

Completions are tagged with a *job epoch*: a job abandoned at its
deadline leaves speculative/stalled futures running on the warm pool,
and when those finish late their completion records carry the old
epoch and are dropped (``stats["stale_completions"]``) instead of
polluting a later job's accounting.
"""
from __future__ import annotations

import heapq
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np


class ShardTaskError(RuntimeError):
    pass


def invert_plan(plan: Sequence[Sequence[int]]) -> Dict[int, list]:
    """{shard_id: [query indices]} union of per-query shard plans — the
    shared-scan schedule.  One definition serves the executor's
    ``map_shard_batch`` and the executor-less inline fallback in
    ``core/queries/batch.py`` so the schedules cannot diverge."""
    queries_of: Dict[int, list] = {}
    for qi, shard_ids in enumerate(plan):
        for sid in shard_ids:
            queries_of.setdefault(int(sid), []).append(qi)
    return queries_of


def run_shared_scan(
    mapper: Callable[[Any, Sequence[int], Callable[[Any], Any]],
                     Dict[int, Any]],
    corpus,
    plan: Sequence[Sequence[int]],
    fns: Sequence[Callable[[Any], Any]],
    *,
    megakernel: Optional[bool] = None,
) -> "list[Dict[int, Any]]":
    """The full shared-scan schedule over any ``map_shards``-shaped
    mapper: invert the per-query plans, visit each union shard once
    (evaluating every interested query in that visit), and scatter the
    per-shard composites back into one ``{shard_id: result}`` dict per
    query.

    When every fn carries the same ``kernels/megascan`` ``MegascanSpec``
    (built via ``MegascanSpec.scan_fns()``), the composite shard task
    becomes ``spec.run_shard`` — one launch per shard for all
    interested queries — and, unless ``megakernel=False``, the composite
    is tagged with the spec so a spec-aware mapper (a
    megakernel-enabled ``ShardTaskExecutor``) can run its whole shard
    group as ONE launch (``spec.run_group``).  The gather below is the
    same either way, and the results are bit for bit equal across
    routes.  ``megakernel=True`` asserts the fns are fusable (raises
    otherwise); ``None`` auto-detects; ``False`` pins the per-shard
    route (the parity reference)."""
    if len(plan) != len(fns):
        raise ValueError(f"plan/fns length mismatch: "
                         f"{len(plan)} != {len(fns)}")
    queries_of = invert_plan(plan)

    spec = None
    if fns:
        cand = getattr(fns[0], "megascan", None)
        if cand is not None and all(
                getattr(f, "megascan", None) is cand for f in fns):
            spec = cand
    if megakernel is True and spec is None:
        raise ValueError("megakernel=True requires scan fns built from "
                         "one MegascanSpec (MegascanSpec.scan_fns())")

    if spec is not None:
        def shared_scan(shard):
            return spec.run_shard(shard.shard_id,
                                  queries_of[shard.shard_id])
        if megakernel is not False:
            shared_scan.megascan = spec
            shared_scan.queries_of = queries_of
    else:
        def shared_scan(shard):
            return {qi: fns[qi](shard)
                    for qi in queries_of[shard.shard_id]}

    by_shard = mapper(corpus, sorted(queries_of), shared_scan)
    out: list = [{} for _ in plan]
    for sid, per_query in by_shard.items():
        for qi, res in per_query.items():
            out[qi][sid] = res
    return out


class ShardTaskExecutor:
    def __init__(
        self,
        workers: int = 4,
        max_retries: int = 2,
        straggler_factor: float = 3.0,
        min_completed_for_speculation: int = 4,
        fault_hook: Optional[Callable[[int, int], None]] = None,
        min_straggler_s: float = 0.05,
        adaptive_workers: bool = False,
        gil_floor_s: float = 1e-3,
        retry_backoff_s: float = 0.0,
        retry_backoff_cap_s: float = 1.0,
        job_deadline_s: Optional[float] = None,
        allow_partial: bool = False,
        task_hook: Optional[Callable[[int, int, int], None]] = None,
        job_hook: Optional[Callable[[int], None]] = None,
        megakernel: bool = True,
    ):
        self.workers = workers
        # Spec-tagged shared scans (kernels/megascan MegascanSpec) run
        # the whole shard group as ONE launch instead of one composite
        # task per shard; False pins the per-shard route (the parity
        # reference).
        self.megakernel = bool(megakernel)
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.min_completed = min_completed_for_speculation
        self.fault_hook = fault_hook  # (shard_id, attempt) -> None or raise
        # chaos seams: per-shard-task hook with the executor's job index
        # (slow/flaky injection at task granularity) and a job-start
        # hook (lets a FaultPlan injector advance its clock)
        self.task_hook = task_hook    # (shard_id, attempt, job)
        self.job_hook = job_hook      # (job) at job start
        # attempt k of a failed shard waits backoff * 2^(k-1) (capped)
        # before resubmission; 0.0 keeps the legacy immediate retry
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        # a job that cannot finish by its deadline stops retrying; with
        # allow_partial it returns what completed (lost shards recorded
        # on last_job), otherwise it raises like exhausted retries
        self.job_deadline_s = job_deadline_s
        self.allow_partial = bool(allow_partial)
        # Floor on the speculation threshold: when the median task time
        # is below the scheduler's own tick (tasks of ~100 us at batch
        # scale), 3x the median is noise-level and speculation would
        # duplicate healthy tasks — a backup task is only worth
        # launching for work at least as long as a scheduling quantum.
        self.min_straggler_s = min_straggler_s
        self.adaptive_workers = adaptive_workers
        self.gil_floor_s = gil_floor_s
        self.stats: Dict[str, int] = {"retries": 0, "speculative": 0,
                                      "jobs": 0, "pool_rebuilds": 0,
                                      "lost_shards": 0,
                                      "stale_completions": 0,
                                      "megascan_jobs": 0}
        # job epoch: bumped at every job start; completion records are
        # tagged with it so futures abandoned by a deadline-expired job
        # are recognizably stale when they finish late.  The completions
        # queue is instance-level (not job-local) and jobs are
        # serialized on _job_lock, so a zombie future's late completion
        # lands in a *live* loop where the epoch guard can count and
        # drop it instead of vanishing into a dead queue.
        self._job_epoch = 0
        self._job_lock = threading.Lock()
        self._completions: "queue.Queue[tuple]" = queue.Queue()
        # per-job service-time telemetry for the last completed job —
        # lets a batching front end attribute batch cost to the shared
        # scan (wall_s) vs engine overhead
        self.last_job: Optional[Dict[str, float]] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        self._pool_lock = threading.Lock()
        self._active_jobs = 0
        self._median_task_s: Optional[float] = None

    def resize(self, workers: int) -> None:
        """Elastic scaling between jobs (the warm pool is swapped on the
        next job, not mid-flight)."""
        self.workers = max(1, workers)

    # ------------------------------------------------------------------
    # warm pool management
    # ------------------------------------------------------------------
    def target_workers(self) -> int:
        """Worker count the next job will run with: the configured width
        unless adaptive granularity scaling says the tasks are too small
        to parallelize (GIL-bound numpy ops favor 1-2 workers)."""
        w = max(1, int(self.workers))
        if (self.adaptive_workers and self._median_task_s is not None
                and self._median_task_s < self.gil_floor_s):
            w = min(w, 2)
        return w

    def _acquire_pool(self) -> ThreadPoolExecutor:
        """Check out the long-lived worker pool for one job, (re)built
        only when the target width changed *and* no other job is using
        it — a mid-flight swap would shut the pool down under the other
        job's submits.  Concurrent jobs simply share the current width
        until the executor goes idle.  Balance with ``_release_pool``."""
        with self._pool_lock:
            target = self.target_workers()
            if self._pool is None or (self._pool_size != target
                                      and self._active_jobs == 0):
                if self._pool is not None:
                    self._pool.shutdown(wait=False)
                self._pool = ThreadPoolExecutor(
                    max_workers=target, thread_name_prefix="shard-worker")
                self._pool_size = target
                self.stats["pool_rebuilds"] += 1
            self._active_jobs += 1
            return self._pool

    def _release_pool(self) -> None:
        with self._pool_lock:
            self._active_jobs -= 1

    def close(self) -> None:
        """Tear down the warm pool (idempotent).  Call when no job is
        in flight — shutting down under a running ``map_shards`` fails
        that job's remaining submits."""
        with self._pool_lock:
            pool, self._pool, self._pool_size = self._pool, None, 0
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> "ShardTaskExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def map_shards(
        self,
        corpus,
        shard_ids: Sequence[int],
        fn: Callable[[Any], Any],
    ) -> Dict[int, Any]:
        """Run ``fn(shard)`` for every id; returns {shard_id: result}.

        The completion loop is event-driven: every future signals a
        queue via ``add_done_callback`` and the scheduler blocks on that
        queue, so bookkeeping is O(1) per completion (a
        ``wait(..., FIRST_COMPLETED)`` polling loop would re-register a
        waiter on every still-pending future each iteration — O(tasks^2)
        per job).  Straggler checks run on 50 ms ticks and on each
        completion.

        A ``MegascanSpec``-tagged composite (see ``run_shared_scan``)
        skips the per-shard fan-out: the whole group runs as ONE launch
        (``_run_group_scan``) when this executor was built with
        ``megakernel=True``.
        """
        spec = getattr(fn, "megascan", None)
        if spec is not None and self.megakernel:
            with self._job_lock:
                return self._run_group_scan(corpus, shard_ids, fn, spec)
        pool = self._acquire_pool()
        try:
            # jobs are serialized: the epoch guard on the shared
            # completions queue assumes one live job owns the loop
            with self._job_lock:
                return self._run_job(pool, corpus, shard_ids, fn)
        finally:
            self._release_pool()

    def _run_job(
        self,
        pool: ThreadPoolExecutor,
        corpus,
        shard_ids: Sequence[int],
        fn: Callable[[Any], Any],
    ) -> Dict[int, Any]:
        ids = [int(s) for s in shard_ids]
        t_job = time.perf_counter()
        deadline = (t_job + self.job_deadline_s
                    if self.job_deadline_s is not None else None)
        self._job_epoch += 1
        epoch = self._job_epoch
        job = self.stats["jobs"]
        if self.job_hook is not None:
            self.job_hook(job)
        results: Dict[int, Any] = {}
        attempts: Dict[int, int] = {i: 0 for i in ids}
        lock = threading.Lock()

        # live[sid][attempt] = when that attempt actually began executing
        # on a worker (NOT when it was submitted): with queue depth >>
        # workers, submission age measures queue wait, and the straggler
        # check would speculatively duplicate nearly every queued task
        # once the median of the first few completions is small.  Keyed
        # per attempt so a speculative duplicate cannot overwrite the
        # original's start (which would corrupt duration samples), and
        # failed attempts are removed so a queued retry is never
        # mistaken for a running straggler.
        live: Dict[int, Dict[int, float]] = {i: {} for i in ids}

        def run_one(sid: int, attempt: int) -> Any:
            with lock:
                live[sid][attempt] = time.perf_counter()
            if self.fault_hook is not None:
                self.fault_hook(sid, attempt)
            if self.task_hook is not None:
                self.task_hook(sid, attempt, job)
            return fn(corpus.shards[sid])

        completions = self._completions
        in_flight = 0
        durations: list = []
        speculated: set = set()
        # retries waiting out their backoff: heap of (due_time, sid)
        delayed: list = []

        def submit(sid: int) -> None:
            nonlocal in_flight
            with lock:
                attempts[sid] += 1
                attempt = attempts[sid]
            fut = pool.submit(run_one, sid, attempt)
            fut.add_done_callback(
                lambda f, sid=sid, a=attempt: completions.put(
                    (epoch, sid, a, f)))
            in_flight += 1

        def schedule_retry(sid: int) -> None:
            """The r-th retry of a shard waits backoff * 2^(r-1)
            (capped) before resubmission; zero backoff resubmits
            immediately, the legacy behavior."""
            self.stats["retries"] += 1
            if self.retry_backoff_s <= 0.0:
                submit(sid)
                return
            delay = min(self.retry_backoff_cap_s,
                        self.retry_backoff_s * 2.0 ** (attempts[sid] - 1))
            heapq.heappush(delayed, (time.perf_counter() + delay, sid))

        last_check = time.perf_counter()

        def check_stragglers(now: float) -> None:
            nonlocal last_check
            if len(durations) < self.min_completed:
                return
            if now - last_check < 0.05:  # O(ids) scan, throttled
                return
            last_check = now
            median = float(np.median(durations))
            threshold = self.straggler_factor * max(
                median, self.min_straggler_s)
            for sid in ids:
                if sid in results or sid in speculated:
                    continue
                with lock:
                    t_run = min(live[sid].values(), default=None)
                if t_run is not None and now - t_run > threshold:
                    speculated.add(sid)
                    self.stats["speculative"] += 1
                    submit(sid)

        # On permanent failure the error is *recorded*, submissions stop,
        # and the loop still drains every in-flight future before the
        # exception escapes — the old per-job pool got this quiescence
        # from its `with` shutdown; the shared warm pool must not be
        # left running zombie tasks that would queue-jam the next job.
        # A *deadline* expiry is the one exception: draining would let a
        # stalled task hold the job hostage past its own time bound, so
        # the job abandons its in-flight futures on the warm pool and
        # the epoch guard disposes of their late completions.
        fatal: Optional[ShardTaskError] = None
        lost: set = set()
        timed_out = False
        for sid in ids:
            submit(sid)
        while in_flight or delayed:
            now = time.perf_counter()
            if fatal is None and deadline is not None and now >= deadline:
                timed_out = True
                break
            if fatal is None:
                while delayed and delayed[0][0] <= now:
                    _, sid = heapq.heappop(delayed)
                    submit(sid)
                if not in_flight and not delayed:
                    break
            timeout = 0.05
            if delayed and fatal is None:
                timeout = min(timeout, max(1e-4, delayed[0][0] - now))
            if deadline is not None and fatal is None:
                timeout = min(timeout, max(1e-4, deadline - now))
            if not in_flight:
                if fatal is not None:
                    break          # only delayed retries left: drop them
                time.sleep(timeout)
                continue
            try:
                rec_epoch, sid, attempt, fut = completions.get(
                    timeout=timeout)
            except queue.Empty:
                if fatal is None:
                    check_stragglers(time.perf_counter())
                continue
            if rec_epoch != epoch:
                # zombie from an abandoned (deadline-expired) earlier
                # job finishing late — drop, never decrement in_flight
                self.stats["stale_completions"] += 1
                continue
            in_flight -= 1
            now = time.perf_counter()
            try:
                res = fut.result()
                with lock:
                    t_start = live[sid].pop(attempt, now)
                if sid not in results:
                    results[sid] = res
                    durations.append(now - t_start)
                    lost.discard(sid)   # late speculative success
            except Exception:
                with lock:
                    live[sid].pop(attempt, None)
                if sid in results or fatal is not None:
                    pass  # a speculative duplicate failed after the
                          # original already delivered, or the job is
                          # already failing — nothing to redo
                elif attempts[sid] <= self.max_retries:
                    schedule_retry(sid)
                elif self.allow_partial:
                    lost.add(sid)   # degrade instead of failing the job
                else:
                    fatal = ShardTaskError(
                        f"shard {sid} failed after "
                        f"{attempts[sid]} attempts")
            if fatal is None:
                check_stragglers(now)
        if fatal is not None:
            raise fatal
        missing = [s for s in ids if s not in results]
        if missing and not self.allow_partial:
            if timed_out:
                raise ShardTaskError(
                    f"job deadline ({self.job_deadline_s}s) expired; "
                    f"shards incomplete: {missing}")
            raise ShardTaskError(f"shards never completed: {missing}")
        self.stats["lost_shards"] += len(missing)
        median_task = float(np.median(durations)) if durations else 0.0
        if durations:
            # feeds adaptive granularity scaling for the next job
            self._median_task_s = median_task
        self.stats["jobs"] += 1
        self.last_job = {
            "wall_s": time.perf_counter() - t_job,
            "tasks": float(len(ids)),
            "median_task_s": median_task,
            "lost_shards": float(len(missing)),
        }
        return results

    def _run_group_scan(self, corpus, shard_ids: Sequence[int], fn,
                        spec) -> Dict[int, Any]:
        """One-launch megakernel route: the whole shard group is a
        single composite task (``spec.run_group``, one launch over the
        packed multi-shard payload) instead of one task per shard.  The
        fault seams keep their per-shard granularity — ``fault_hook``
        and ``task_hook`` fire for every shard in the group before the
        launch, so chaos scripts targeting single shards still bite —
        but failure and retry are at-least-once at *group* granularity:
        any hook raise or launch failure re-runs the whole group (with
        the same bounded exponential backoff)."""
        ids = [int(s) for s in shard_ids]
        t_job = time.perf_counter()
        deadline = (t_job + self.job_deadline_s
                    if self.job_deadline_s is not None else None)
        self._job_epoch += 1
        job = self.stats["jobs"]
        if self.job_hook is not None:
            self.job_hook(job)
        queries_of = getattr(fn, "queries_of", None)
        if queries_of is None:
            queries_of = {sid: [] for sid in ids}
        attempt = 0
        lost: list = []
        results: Dict[int, Any] = {}
        while True:
            attempt += 1
            try:
                for sid in ids:
                    if self.fault_hook is not None:
                        self.fault_hook(sid, attempt)
                    if self.task_hook is not None:
                        self.task_hook(sid, attempt, job)
                results = spec.run_group(ids, queries_of)
                break
            except Exception as exc:
                if attempt > self.max_retries:
                    raise ShardTaskError(
                        f"megascan group {ids} failed after "
                        f"{attempt} attempts") from exc
                self.stats["retries"] += 1
                delay = 0.0
                if self.retry_backoff_s > 0.0:
                    delay = min(self.retry_backoff_cap_s,
                                self.retry_backoff_s * 2.0 ** (attempt - 1))
                if deadline is not None and (
                        time.perf_counter() + delay >= deadline):
                    if self.allow_partial:
                        lost = list(ids)
                        break
                    raise ShardTaskError(
                        f"job deadline ({self.job_deadline_s}s) expired; "
                        f"megascan group incomplete: {ids}") from exc
                if delay > 0.0:
                    time.sleep(delay)
        self.stats["lost_shards"] += len(lost)
        self.stats["jobs"] += 1
        self.stats["megascan_jobs"] += 1
        wall = time.perf_counter() - t_job
        # with one launch for the group, the per-shard attribution is
        # the launch wall spread over its shards
        self.last_job = {
            "wall_s": wall,
            "tasks": float(len(ids)),
            "median_task_s": wall / max(1, len(ids)),
            "lost_shards": float(len(lost)),
        }
        if spec.last_record is not None and not lost:
            self.last_job["megascan"] = dict(spec.last_record)
        return results

    def map_shard_batch(
        self,
        corpus,
        plan: Sequence[Sequence[int]],
        fns: Sequence[Callable[[Any], Any]],
        *,
        megakernel: Optional[bool] = None,
    ) -> "list[Dict[int, Any]]":
        """Shared scan over a batch of queries.

        ``plan[i]`` is the shard ids query ``i`` sampled and ``fns[i]``
        its per-shard task.  Returns one ``{shard_id: result}`` dict per
        query — exactly what ``map_shards(corpus, plan[i], fns[i])``
        would have produced, but each shard in the union of the plans is
        visited once, with all interested queries evaluated in that
        single visit.  Retry and straggler speculation are inherited
        from ``map_shards`` at composite-task granularity.

        ``megakernel`` (None = auto): when the fns come from one
        ``MegascanSpec``, run the whole union as ONE launch (see
        ``run_shared_scan``); ``False`` pins the per-shard route — the
        bit-for-bit parity reference.
        """
        return run_shared_scan(self.map_shards, corpus, plan, fns,
                               megakernel=megakernel)
