"""Deterministic, seeded fault injection: the ``FaultPlan`` DSL.

Fault lambdas used to be scattered one-off closures across tests and
``serve_bench`` — each hand-rolling its own "fail host 1 once" state.
A ``FaultPlan`` is the declarative replacement: a scripted scenario

    plan = (FaultPlan(seed=7)
            .crash(1, at_job=3)               # host 1 dies at job 3
            .slow(0, ms_per_shard=5)          # host 0 is always slow
            .flaky(2, error_rate=0.1,
                   jobs=range(4, 8))          # host 2 flakes jobs 4-7
            .stall(0, s=0.2, jobs=[5]))       # host 0 stalls job 5
    plan.install(executor)

that compiles onto the executor stack's injection seams:

  * ``HostGroupExecutor.job_hook`` — the plan's *clock*.  Faults are
    scheduled in group-job units ("at_job=3" = the executor's 4th
    ``map_shards``/``map_shard_batch``), so a scenario needs no wall
    clock and replays identically run over run.
  * ``HostGroupExecutor.host_fault_hook`` — host-granularity faults:
    ``crash`` raises for every job from ``at_job`` on (the host is
    dead until fleet membership says otherwise), ``stall`` sleeps
    before the host group runs (the delay lands in the host's wall
    telemetry, so the balancer *observes* the stall).
  * ``ShardTaskExecutor.task_hook`` — shard-task-granularity faults,
    installed per host: ``slow`` sleeps per shard visit, ``flaky``
    raises ``ChaosFault`` with the configured probability.

**Determinism**: a flaky decision is drawn from
``np.random.default_rng([seed, host, shard, job, attempt])`` — a
counter-based stream keyed on the fault's coordinates, never on a
shared mutable RNG — so outcomes are independent of worker-thread
interleaving and identical across runs, machines, and retries of the
*other* shards.  Retrying a flaked shard advances ``attempt`` and so
redraws; a retry can deterministically succeed.

Hosts that join after ``install`` (FleetManager.join) are hooked
automatically: the plan wraps ``ensure_host`` so a revived or new slot
gets its per-host task hook before it can serve.

``record()`` summarizes what actually fired (per-kind counters) for
the bench's chaos audit.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

JobSpan = Optional[Union[int, range, list, tuple, set]]


class ChaosFault(RuntimeError):
    """A transient injected task fault (retries may clear it)."""


class ChaosCrash(RuntimeError):
    """An injected host death (persists until membership changes)."""


def _in_span(jobs: JobSpan, job: int) -> bool:
    if jobs is None:
        return True
    if isinstance(jobs, int):
        return job == jobs
    return job in jobs


class FaultPlan:
    """A seeded, scripted fault scenario.  Its methods chain; call
    ``install(executor)`` to compile it onto a ``HostGroupExecutor``
    (or a bare ``ShardTaskExecutor``, whose faults are read as
    host 0)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._crashes: List[tuple] = []   # (host, at_job)
        self._slows: List[tuple] = []     # (host, ms_per_shard, jobs)
        self._flaky: List[tuple] = []     # (host, error_rate, jobs)
        self._stalls: List[tuple] = []    # (host, seconds, jobs)
        self._job = -1                    # advanced by the job hook
        self.fired: Dict[str, int] = {"crash": 0, "slow": 0,
                                      "flaky": 0, "stall": 0}

    # ------------------------------------------------------------------
    # DSL
    # ------------------------------------------------------------------
    def crash(self, host: int, at_job: int) -> "FaultPlan":
        """Host dies at group job ``at_job`` and stays dead (every
        later job's group on it raises ``ChaosCrash``) — pair with
        ``FleetManager.crash`` to take it out of rotation."""
        self._crashes.append((int(host), int(at_job)))
        return self

    def slow(self, host: int, ms_per_shard: float,
             jobs: JobSpan = None) -> "FaultPlan":
        """Every shard task on ``host`` sleeps ``ms_per_shard`` during
        ``jobs`` (None = always): a degraded host the balancer can
        observe."""
        self._slows.append((int(host), float(ms_per_shard), jobs))
        return self

    def flaky(self, host: int, error_rate: float,
              jobs: JobSpan = None) -> "FaultPlan":
        """Shard tasks on ``host`` raise ``ChaosFault`` with
        probability ``error_rate``, decided deterministically per
        (seed, host, shard, job, attempt)."""
        self._flaky.append((int(host), float(error_rate), jobs))
        return self

    def stall(self, host: int, s: float,
              jobs: JobSpan = None) -> "FaultPlan":
        """Host pauses ``s`` seconds before serving its group during
        ``jobs`` — long enough stalls trip per-job deadlines."""
        self._stalls.append((int(host), float(s), jobs))
        return self

    # ------------------------------------------------------------------
    # compiled hooks
    # ------------------------------------------------------------------
    def _advance(self, job: int) -> None:
        self._job = int(job)

    def _host_hook(self, host: int, shard_ids) -> None:
        job = self._job
        for h, at in self._crashes:
            if host == h and job >= at:
                self.fired["crash"] += 1
                raise ChaosCrash(
                    f"chaos: host {h} dead since job {at} (job {job})")
        for h, s, jobs in self._stalls:
            if host == h and _in_span(jobs, job):
                self.fired["stall"] += 1
                time.sleep(s)

    def _task_hook_for(self, host: int):
        def hook(sid: int, attempt: int, _local_job: int) -> None:
            job = self._job
            for h, ms, jobs in self._slows:
                if h == host and _in_span(jobs, job):
                    self.fired["slow"] += 1
                    time.sleep(ms / 1000.0)
            for h, rate, jobs in self._flaky:
                if h == host and _in_span(jobs, job):
                    draw = np.random.default_rng(
                        [self.seed, h, int(sid), job, int(attempt)]
                    ).random()
                    if draw < rate:
                        self.fired["flaky"] += 1
                        raise ChaosFault(
                            f"chaos: flaky host {h} shard {sid} "
                            f"job {job} attempt {attempt}")
        return hook

    # ------------------------------------------------------------------
    # installation
    # ------------------------------------------------------------------
    def install(self, executor: Any) -> "FaultPlan":
        """Compile the plan onto an executor's injection seams.  A
        ``HostGroupExecutor`` gets the job clock, the host hook, and a
        per-host task hook (late-joining hosts are hooked through
        ``ensure_host``); a bare ``ShardTaskExecutor`` gets its faults
        read as host 0, with ``crash`` at task granularity and
        ``stall`` on the job hook."""
        if hasattr(executor, "hosts"):            # HostGroupExecutor
            executor.job_hook = self._advance
            executor.host_fault_hook = self._host_hook
            for h, ex in executor.hosts.items():
                ex.task_hook = self._task_hook_for(int(h))
            orig_ensure = executor.ensure_host

            def ensure(host):
                ex = orig_ensure(host)
                ex.task_hook = self._task_hook_for(int(host))
                return ex

            executor.ensure_host = ensure
            return self

        # bare ShardTaskExecutor: host-0 faults, task granularity
        task_hook = self._task_hook_for(0)

        def bare_task_hook(sid: int, attempt: int, job: int) -> None:
            self._job = int(job)        # the executor's own job counter
            for h, at in self._crashes:
                if h == 0 and job >= at:
                    self.fired["crash"] += 1
                    raise ChaosCrash(
                        f"chaos: executor dead since job {at}")
            task_hook(sid, attempt, job)

        def bare_job_hook(job: int) -> None:
            self._job = int(job)
            for h, s, jobs in self._stalls:
                if h == 0 and _in_span(jobs, job):
                    self.fired["stall"] += 1
                    time.sleep(s)

        executor.task_hook = bare_task_hook
        executor.job_hook = bare_job_hook
        return self

    def record(self) -> dict:
        """JSON-ready audit: the scripted faults and what fired."""
        return dict(
            seed=self.seed,
            scripted=dict(
                crashes=[list(c) for c in self._crashes],
                slows=[[h, ms, _span_repr(j)]
                       for h, ms, j in self._slows],
                flaky=[[h, r, _span_repr(j)]
                       for h, r, j in self._flaky],
                stalls=[[h, s, _span_repr(j)]
                        for h, s, j in self._stalls]),
            fired=dict(self.fired))


def _span_repr(jobs: JobSpan):
    if jobs is None:
        return None
    if isinstance(jobs, int):
        return jobs
    return sorted(int(j) for j in jobs)
