"""Adaptive batch-window serving frontend.

``QueryBatch`` executes fixed, client-chosen batches; a serving process
instead sees a *stream* of single queries.  ``BatchWindow`` sits in
between: callers ``submit`` individual queries and get a future back,
and a dispatcher thread closes the open window when either

  * the window reaches ``max_batch`` queries (high traffic — full
    shared-scan amortization), or
  * ``max_delay_s`` has elapsed since the window's oldest query arrived
    (low traffic — bounded latency; the default 2 ms deadline is small
    next to per-shard scan times but large next to scoring dispatch).

Each closed window executes as one ``QueryBatch.execute`` call —
one batched scoring pass, one shared scan over the union of sampled
shards — on a single dispatcher thread, so the engine's rng draws stay
in a deterministic stream.  On a multi-host engine (a
``runtime/placement.HostGroupExecutor`` behind ``QueryBatch``) that
shared scan splits by shard residency and runs per host; the window
neither knows nor cares — the executor's ``last_job`` telemetry it
forwards to the controller is already the per-host *aggregate* (the
cross-host critical-path wall time).  ``flush()`` force-closes the
open window; ``close()`` drains everything and stops the dispatcher.

The win: low-traffic periods keep latency (a lone query waits at most
the deadline, not for a full batch), high-traffic periods batch up to
``max_batch`` and inherit the batched engine's ~6x throughput (see
BENCH_serve.json's ``windowed`` row).

Two optional control loops close the remaining gaps:

  * ``controller=WindowController(...)`` replaces the static pair with
    the queueing-theory autotuner in ``runtime/controller.py``: every
    window opens with the (deadline, size) the controller currently
    estimates minimizes p99 sojourn, fed by the window's own arrival /
    batch-cost observations (``max_delay_s`` / ``max_batch`` then only
    apply when the controller is absent).
  * ``max_pending=N`` bounds the pending queue: once N queries sit
    unserved, ``submit`` sheds with the typed ``Backpressure`` signal
    instead of letting sojourn grow without bound behind a saturated
    dispatcher.

When the engine can trade accuracy for capacity (it advertises
``accepts_pressure``, i.e. a ``QueryBatch`` with a
``runtime.budget.RatePlanner``), the queue bound becomes a *two-stage*
ladder instead of a cliff: the first bound-hit escalates the
controller's degradation pressure to 1.0 (every pending query drops to
its budget floor rate — see ``runtime/budget.py``) and the query is
*accepted*; only once the queue stretches to twice the bound with the
engine already fully degraded does ``submit`` shed.  Overload degrades
accuracy before availability, and every shed carries the controller's
``retry_after_s`` hint so callers back off one serving cycle.  The
dispatcher forwards the controller's current pressure to each
``engine.execute`` call, and the engine's per-batch budget audit
(planned vs realized rates and errors) lands on ``last_budget``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.controller import Backpressure, WindowController


class BatchWindow:
    """Deadline/size-closed batching frontend over a ``QueryBatch``
    engine.  One instance owns one dispatcher thread; it is safe to
    submit from many producer threads."""

    def __init__(
        self,
        engine,
        rate: float,
        *,
        max_batch: int = 32,
        max_delay_s: float = 0.002,
        rng: Optional[np.random.Generator] = None,
        controller: Optional[WindowController] = None,
        max_pending: Optional[int] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.engine = engine
        self.rate = rate
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.controller = controller
        self.max_pending = max_pending
        self._rng = rng or np.random.default_rng(0)
        self._wake = threading.Condition()
        self._pending: List[Tuple[Any, Future]] = []
        self._first_arrival: Optional[float] = None
        self._flush = False
        self._closed = False
        self.stats: Dict[str, int] = {
            "batches": 0, "served": 0, "cancelled": 0, "shed": 0,
            "escalated": 0, "degraded": 0, "batch_retries": 0,
            "closed_by_size": 0, "closed_by_deadline": 0,
            "closed_by_flush": 0,
        }
        # the engine's budget audit for the most recent batch (planned
        # vs realized per-query rates/errors), when the engine keeps
        # one (QueryBatch with a RatePlanner) — None otherwise
        self.last_budget: Optional[Dict[str, Any]] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batch-window")
        self._thread.start()

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------
    def submit(self, query) -> "Future":
        """Enqueue one query; the future resolves to the same result
        object ``QueryBatch.execute`` would return for it.

        Raises ``Backpressure`` (the query is *not* enqueued) when
        ``max_pending`` queries already wait — the dispatcher is
        saturated and callers must shed or retry elsewhere."""
        fut: Future = Future()
        with self._wake:
            # timestamp under the lock: the controller's EWMA needs
            # monotone arrival times, and two producers reading the
            # clock before racing for the lock can deliver them
            # out of order
            now = time.perf_counter()
            if self._closed:
                raise RuntimeError("BatchWindow is closed")
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                # degrade before shedding: an accuracy-elastic engine
                # absorbs the overload by dropping every pending query
                # to its budget floor (pressure -> 1.0), and the queue
                # may stretch to twice the bound while the degraded
                # capacity catches up.  Shed only beyond that hard cap
                # — by then every query is already at its floor and
                # accuracy has nothing left to give.
                can_degrade = (
                    self.controller is not None
                    and getattr(self.engine, "accepts_pressure", False))
                if can_degrade and len(self._pending) < 2 * self.max_pending:
                    self.controller.escalate_pressure()
                    self.stats["escalated"] += 1
                else:
                    self.stats["shed"] += 1
                    util = retry = None
                    if self.controller is not None:
                        util = self.controller.utilization
                        retry = self.controller.retry_after_s()
                    raise Backpressure(len(self._pending), util, retry)
            if self.controller is not None:
                self.controller.observe_arrival(now)
            self._pending.append((query, fut))
            if self._first_arrival is None:
                self._first_arrival = now
            self._wake.notify_all()
        return fut

    def flush(self) -> None:
        """Force-close the open window without waiting for the deadline
        (returns immediately; wait on the submitted futures)."""
        with self._wake:
            if self._pending:
                self._flush = True
                self._wake.notify_all()

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain all pending queries, then stop the dispatcher."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "BatchWindow":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._wake:
                while not self._pending and not self._closed:
                    self._flush = False        # nothing left to flush
                    self._wake.wait()
                if not self._pending and self._closed:
                    return
                # a window is open: its (deadline, size) pair is fixed
                # at open time — static, or the controller's current
                # p99-sojourn-minimizing plan
                if self.controller is not None:
                    delay_s, max_batch = self.controller.window_params()
                else:
                    delay_s, max_batch = self.max_delay_s, self.max_batch
                deadline = self._first_arrival + delay_s
                while (len(self._pending) < max_batch
                       and not self._flush and not self._closed):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
                batch = self._pending[: max_batch]
                del self._pending[: max_batch]
                if len(batch) >= max_batch:
                    reason = "size"
                elif self._flush or self._closed:
                    reason = "flush"
                else:
                    reason = "deadline"
                # the remainder opens a fresh window "now" — close
                # enough to the true oldest-remaining arrival, and it
                # never *extends* any query's wait past one full window
                self._first_arrival = (time.perf_counter()
                                       if self._pending else None)
                if not self._pending:
                    self._flush = False
            self._run_batch(batch, reason)

    def _execute_once_retried(self, queries: List[Any],
                              kwargs: Dict[str, Any]) -> List[Any]:
        """One batch through the engine, with a single synchronous
        in-place retry on *infrastructure* failure (``HostFailure`` /
        ``ShardTaskError``): a host that died mid-batch is marked dead
        by the first attempt's requeue path (or taken out of rotation
        by ``FleetManager.crash``), so the immediate re-run lands on
        the survivors.  In place because the claimed futures are
        already RUNNING — ``set_running_or_notify_cancel`` returns
        False for a re-enqueued future, so queueing them again would
        silently drop them.  Exactly one retry: a second consecutive
        infra failure means the fleet genuinely cannot serve the batch
        and the waiters get the exception."""
        from repro_torch.runtime.executor import ShardTaskError
        from repro_torch.runtime.placement import HostFailure

        try:
            return self.engine.execute(queries, self.rate,
                                       rng=self._rng, **kwargs)
        except (HostFailure, ShardTaskError):
            self.stats["batch_retries"] += 1
            return self.engine.execute(queries, self.rate,
                                       rng=self._rng, **kwargs)

    def _run_batch(self, batch: List[Tuple[Any, Future]],
                   reason: str) -> None:
        # Claim every future before executing: a caller may have
        # cancel()ed while it sat PENDING in the window.  Marking the
        # survivors RUNNING means no later cancel can win the race and
        # make set_result raise InvalidStateError (which would kill the
        # dispatcher thread for good).
        claimed = [(q, f) for q, f in batch
                   if f.set_running_or_notify_cancel()]
        dropped = len(batch) - len(claimed)
        service_s = None
        pressure = 0.0
        if claimed:
            queries = [q for q, _ in claimed]
            # an accuracy-elastic engine takes the controller's current
            # degradation pressure with the batch; plain engines keep
            # the legacy signature (the kwarg would be a TypeError)
            kwargs = {}
            if getattr(self.engine, "accepts_pressure", False):
                pressure = (self.controller.pressure
                            if self.controller is not None else 0.0)
                kwargs["pressure"] = pressure
            t0 = time.perf_counter()
            try:
                results = self._execute_once_retried(queries, kwargs)
            except BaseException as exc:  # deliver failures to every waiter
                for _, fut in claimed:
                    fut.set_exception(exc)
            else:
                service_s = time.perf_counter() - t0
                for (_, fut), res in zip(claimed, results):
                    fut.set_result(res)
        with self._wake:
            self.stats["cancelled"] += dropped
            if not claimed:
                return
            self.stats["batches"] += 1
            self.stats["served"] += len(claimed)
            if pressure > 0.0:
                self.stats["degraded"] += len(claimed)
            self.last_budget = getattr(self.engine, "last_budget", None)
            self.stats[f"closed_by_{reason}"] += 1
            if self.controller is not None and service_s is not None:
                # the executor's per-job telemetry attributes the batch
                # cost: scan_s is the shared-scan share of service_s
                # (for a host group, the cross-host critical path)
                executor = getattr(self.engine, "executor", None)
                job = getattr(executor, "last_job", None)
                scan_s = job["wall_s"] if job else None
                # semantic-cache exact hits never touched the executor;
                # keep them out of the fitted batch cost model
                report = getattr(self.engine, "last_report", None)
                cache_meta = getattr(report, "cache", None)
                cached_n = cache_meta.get("hits", 0) if cache_meta else 0
                self.controller.observe_batch(len(claimed), service_s,
                                              scan_s, cached=cached_n)
