"""Locality-aware shard placement + multi-host query execution.

On a multi-host deployment the corpus shards are not a flat local
pool: each host holds a *resident* slice of them (the Spark-executor
/ HDFS-block layout the paper's prototype rides).  Two pieces make the
query runtime placement-aware:

``PlacementMap`` — the shard -> host residency table, plus ``R``
replica hosts per shard for failover.  It is derived from the host
mesh (``PlacementMap.from_mesh`` reads the residency axes of a mesh;
``launch.mesh.make_placement_mesh`` describes one without a device) or
built directly (``blocked`` mirrors how a mesh axis shards an array
into contiguous blocks; ``round_robin`` stripes).  ``split`` is the
scheduling primitive: it partitions a set of shard ids into per-host
groups by residency, falling over to the first live replica for hosts
in the ``dead`` set.

``HostGroupExecutor`` — the multi-host analogue of
``ShardTaskExecutor`` (same ``map_shards`` / ``map_shard_batch``
surface, so ``QueryBatch`` and ``BatchWindow`` take either without
change).  A job runs in three phases:

  1. **Residency split**: the shard ids (for a batch: the *union* of
     the per-query plans, inverted once by ``invert_plan``) are split
     by ``PlacementMap.split`` — each host only ever scans shards it
     holds, so no shard payload crosses the interconnect.
  2. **Per-host shared scans**: every host group runs as one
     ``ShardTaskExecutor`` job on that host's own executor — per-host
     warm pools, per-host retry/straggler speculation, and for batches
     the per-host shared scan evaluates every query that sampled a
     resident shard in a single visit.  Host jobs run concurrently on
     a coordinator pool (one thread per active host; on a real cluster
     the coordinator thread becomes an RPC to the host).
  3. **Cross-host gather**: per-host results merge into one
     ``{shard_id: result}`` map.  Partials stay at (query, shard)
     granularity — the Hansen-Hurwitz sums, Boolean doc sets, and
     BM25 top-k candidates a reduce consumes are exactly the per-shard
     values the single-executor path would have produced, so the
     merged reduce is bit-for-bit identical to single-host execution
     (pinned by tests/test_placement.py).

**Host failure**: a host job that dies (its ``ShardTaskExecutor``
exhausts retries, or the injected ``host_fault_hook`` raises) marks
the host dead for the rest of the job; its entire shard group is
requeued onto the replica hosts via ``split(..., dead=...)`` and
re-executed there — the same at-least-once semantics as task retry,
lifted to host granularity (a requeued shard re-runs all of its
queries).  A shard whose primary and replicas are all dead raises
``HostFailure``.

**Load balancing** (``balanced=True``): the residency split is
primary-only and therefore bounded by the slowest host — skewed phi
concentrates sampled shards on a few hot hosts.  With a balancer the
dataflow becomes placement -> balance -> executor: ``PlacementMap``
says who *can* run a shard (primary + live ring replicas),
``runtime.balance.plan_split`` says who *should* (greedy LPT over a
per-host EWMA cost model fed by realized host-group wall times, with a
hysteresis band so stable loads don't flap), and the per-host
``ShardTaskExecutor`` fleet actually runs the groups.  Shed shards
land only on replicas that hold them, so every scan stays local, and
the cross-host gather is unchanged — balanced results are bit-for-bit
the single-executor results.  Failover and balancing are one code
path (``_split``): a dead host is an infinitely-hot one.

Telemetry is a per-host aggregate: ``last_job`` carries the job's
critical-path wall time (what the window controller attributes to the
shared scan), total task count, and the per-host breakdown (realized
wall per host, including any injected degradation);
``stats["scans_per_host"]`` counts shard visits per host, which the
serving bench checks against the residency split of the union plan
(primary-only executors — a balanced executor deliberately deviates
from residency counts, and its audit lives in
``last_job["balance"]``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.sharding import data_host_count
from repro_torch.runtime.balance import BalanceAudit, HostLoadModel, plan_split
from repro_torch.runtime.executor import (
    ShardTaskExecutor,
    invert_plan,
    run_shared_scan,
)
from repro_torch.runtime.generation import GenerationClock


class HostFailure(RuntimeError):
    """A shard's primary host and every replica are dead — the job
    cannot make progress.  ``host`` is the last host tried, ``shard_ids``
    the orphaned shards."""

    def __init__(self, host: int, shard_ids: Sequence[int]):
        self.host = int(host)
        self.shard_ids = [int(s) for s in shard_ids]
        super().__init__(
            f"host {host} failed and shards {self.shard_ids} have no "
            f"live replica host")


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Shard -> host residency with optional replicas.

    ``primary[s]`` is the host shard ``s`` lives on; ``replicas[s]`` are
    up to R additional hosts holding a copy (failover targets, primary
    excluded).  Hosts are dense ids ``0..n_hosts-1``."""

    primary: np.ndarray          # int64 [n_shards]
    replicas: np.ndarray         # int64 [n_shards, R] (R may be 0)
    n_hosts: int

    def __post_init__(self):
        p = np.asarray(self.primary, np.int64)
        r = np.asarray(self.replicas, np.int64)
        if r.ndim != 2 or r.shape[0] != p.shape[0]:
            raise ValueError(f"replicas must be [n_shards, R], got "
                             f"{r.shape} for {p.shape[0]} shards")
        object.__setattr__(self, "primary", p)
        object.__setattr__(self, "replicas", r)
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        for name, a in (("primary", p), ("replicas", r)):
            if a.size and (a.min() < 0 or a.max() >= self.n_hosts):
                raise ValueError(f"{name} references hosts outside "
                                 f"0..{self.n_hosts - 1}")
        if r.shape[1] and (r == p[:, None]).any():
            raise ValueError("a replica host duplicates its primary")

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def blocked(n_shards: int, n_hosts: int,
                n_replicas: int = 1) -> "PlacementMap":
        """Contiguous-block residency — how a data mesh axis shards an
        array: shard ``s`` lives on host ``s * n_hosts // n_shards``.
        Replica ``j`` of a shard is ``(primary + j) % n_hosts``."""
        ids = np.arange(n_shards, dtype=np.int64)
        primary = ids * n_hosts // max(n_shards, 1)
        return PlacementMap._with_ring_replicas(primary, n_hosts, n_replicas)

    @staticmethod
    def round_robin(n_shards: int, n_hosts: int,
                    n_replicas: int = 1) -> "PlacementMap":
        """Striped residency: shard ``s`` lives on host ``s % n_hosts``
        (spreads hot shard ranges; blocked keeps range scans local)."""
        primary = np.arange(n_shards, dtype=np.int64) % n_hosts
        return PlacementMap._with_ring_replicas(primary, n_hosts, n_replicas)

    @staticmethod
    def from_mesh(mesh, n_shards: int, *,
                  n_replicas: int = 1) -> "PlacementMap":
        """Residency read off a mesh's data-residency axes (``pod`` x
        ``data``, ``distributed.sharding.data_host_count``): shards lay
        out in contiguous blocks exactly like an array sharded across
        those hosts.  ``mesh`` is a ``DeviceMesh`` or the shape-only
        ``AbstractMesh`` (``launch.mesh.make_placement_mesh``), so a
        simulated topology allocates nothing; a host count is refused."""
        if isinstance(mesh, (int, np.integer)):
            raise TypeError("from_mesh takes a mesh, not a host count: "
                            "use make_placement_mesh(n_hosts)")
        return PlacementMap.blocked(n_shards, data_host_count(mesh),
                                    n_replicas)

    @staticmethod
    def _with_ring_replicas(primary: np.ndarray, n_hosts: int,
                            n_replicas: int) -> "PlacementMap":
        r = max(0, min(int(n_replicas), n_hosts - 1))
        offsets = np.arange(1, r + 1, dtype=np.int64)
        replicas = (primary[:, None] + offsets[None, :]) % n_hosts
        return PlacementMap(primary, replicas.reshape(len(primary), r),
                            int(n_hosts))

    # ------------------------------------------------------------------
    # lookups
    # ------------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return int(self.primary.shape[0])

    @property
    def n_replicas(self) -> int:
        return int(self.replicas.shape[1])

    def hosts_of(self, shard_id: int) -> Tuple[int, ...]:
        """(primary, *replicas) for one shard, in failover order."""
        s = int(shard_id)
        return (int(self.primary[s]),
                *(int(h) for h in self.replicas[s]))

    def shards_on(self, host: int) -> np.ndarray:
        """Shard ids whose *primary* residency is ``host``."""
        return np.nonzero(self.primary == int(host))[0].astype(np.int64)

    def extend(self, n_shards: int) -> "PlacementMap":
        """Open-shard residency for live ingest: grow the map to cover
        newly appended shards without moving any existing one.  New
        shard ids take round-robin primaries (spreads ingest load) with
        the same ring-replica count as the rest of the map.  Returns
        ``self`` when nothing grew, so callers can swap unconditionally."""
        old = self.n_shards
        n = int(n_shards)
        if n < old:
            raise ValueError(f"cannot shrink placement from {old} to "
                             f"{n} shards")
        if n == old:
            return self
        new_primary = np.arange(old, n, dtype=np.int64) % self.n_hosts
        primary = np.concatenate([self.primary, new_primary])
        return PlacementMap._with_ring_replicas(primary, self.n_hosts,
                                                self.n_replicas)

    def split(self, shard_ids: Sequence[int],
              dead: frozenset = frozenset(), *,
              load=None,
              hysteresis: Optional[float] = None,
              orphans: Optional[List[int]] = None) -> Dict[int, List[int]]:
        """Partition shard ids into per-host groups by residency.

        Primary-only (``load=None``): each shard goes to its primary
        host, or — when the primary is in ``dead`` — to its first live
        replica (failover order).  Cost-aware (``load`` a
        ``runtime.balance.HostLoadModel``): the residency split is the
        starting point, but shards shed from estimated-hot hosts onto
        their live replicas when the balanced assignment beats the
        residency makespan by more than the ``hysteresis`` band (see
        ``runtime.balance.plan_split`` — a dead host is just an
        infinitely-hot one, so failover is the degenerate case of
        balancing).  Either way every shard lands on a host that holds
        it.  A shard with *no* live host raises ``HostFailure`` — or,
        when ``orphans`` (a mutable list) is supplied, is appended
        there and left out of every group: the degraded-serving path,
        where the query layer answers from the surviving sample with a
        widened CI instead of failing.  Group lists preserve the input
        order (determinism for tests)."""
        if load is not None:
            return plan_split(self, shard_ids, load, dead=dead,
                              hysteresis=hysteresis, orphans=orphans).groups
        groups: Dict[int, List[int]] = {}
        for sid in shard_ids:
            sid = int(sid)
            for h in self.hosts_of(sid):
                if h not in dead:
                    groups.setdefault(h, []).append(sid)
                    break
            else:
                if orphans is not None:
                    orphans.append(sid)
                    continue
                raise HostFailure(int(self.primary[sid]), [sid])
        return groups


class HostGroupExecutor:
    """Locality-split executor: one ``ShardTaskExecutor`` per host,
    per-host shared scans, cross-host gather, replica failover.

    Duck-type compatible with ``ShardTaskExecutor`` where the query
    engine touches it (``map_shards`` / ``map_shard_batch`` /
    ``last_job`` / ``stats`` / ``close``), so it drops into
    ``QueryBatch(executor=...)`` and behind ``BatchWindow`` unchanged.

    ``workers_per_host`` sizes each host's warm pool (keep
    ``hosts * workers_per_host`` at the single-host width for a fair
    same-machine comparison); remaining keyword arguments are forwarded
    to every per-host ``ShardTaskExecutor`` (``fault_hook``,
    ``max_retries``, ``adaptive_workers``, ...).  ``host_fault_hook``
    is the *host*-granularity injection point: called as
    ``(host, shard_ids)`` before the host's scan; raising kills the
    whole host for the current job and triggers replica requeue, while
    a hook that merely sleeps simulates a degraded (hot) host — the
    delay lands in the host's wall-time telemetry, which is how the
    bench and tests exercise the balancer.

    ``balanced=True`` (or an explicit ``balancer=HostLoadModel(...)``)
    turns on replica-aware load balancing: every split goes through
    ``runtime.balance.plan_split`` fed by the per-host realized wall
    times of completed host groups, so estimated-hot hosts shed whole
    shard groups onto their live ring replicas (residency preserved —
    shed scans stay local).  The requeue path uses the same balancer
    split with the dead set grown, unifying failover and balancing;
    ``last_job["balance"]`` records the decision (estimated vs
    realized per-host makespan, shed count) for audit."""

    def __init__(
        self,
        placement: PlacementMap,
        *,
        workers_per_host: int = 2,
        host_fault_hook: Optional[Callable[[int, Sequence[int]], None]] = None,
        balanced: bool = False,
        balancer: Optional["HostLoadModel"] = None,
        allow_partial: bool = False,
        job_hook: Optional[Callable[[int], None]] = None,
        clock: Optional[GenerationClock] = None,
        **executor_kw: Any,
    ):
        self.placement = placement
        self.host_fault_hook = host_fault_hook
        # the one version authority this executor mints placement
        # generations through; build_serving_stack passes the stack's
        # shared clock so cache/index/ingestor fence on the same handle
        self.clock = clock if clock is not None else GenerationClock()
        # group-level degraded serving: a shard whose primary and every
        # replica are dead (or down) is *lost* — recorded on stats /
        # last_job — instead of raising HostFailure.  Deliberately NOT
        # forwarded to the per-host executors: a task that exhausts its
        # retries must still escalate to host failover (the replica may
        # well succeed); only a shard with no live host left degrades.
        self.allow_partial = bool(allow_partial)
        # group-level job-start hook (job index): the chaos layer's
        # clock — per-host executors count their own host-jobs, which
        # is the wrong denomination for a scripted scenario
        self.job_hook = job_hook
        if balanced and balancer is None:
            balancer = HostLoadModel(placement.n_hosts)
        self.balancer = balancer
        self._workers_per_host = workers_per_host
        self._executor_kw = dict(executor_kw)
        self.hosts: Dict[int, ShardTaskExecutor] = {
            h: ShardTaskExecutor(workers=workers_per_host, **executor_kw)
            for h in range(placement.n_hosts)
        }
        # fleet membership: hosts taken out of rotation (crashed, or
        # drained by runtime/fleet.FleetManager).  Unlike the per-job
        # ``dead`` set this persists across jobs; the host's executor
        # object stays alive so an in-flight job that captured an older
        # placement generation can still finish on it (RCU — see
        # set_placement), until close().
        self.down: set = set()
        self.stats: Dict[str, Any] = {
            "jobs": 0, "host_jobs": 0, "host_failures": 0,
            "requeued_shards": 0, "shed_shards": 0,
            "lost_shards": 0,
            # deprecated read-only view of clock.current().placement
            # (pre-generation callers; pinned by tests) — never bumped
            # directly, only mirrored after a clock mint
            "placement_epoch": self.clock.current().placement,
            "scans_per_host": [0] * placement.n_hosts,
        }
        self.last_job: Optional[Dict[str, Any]] = None
        self._coord: Optional[ThreadPoolExecutor] = None
        self._coord_size = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # fleet membership (driven by runtime/fleet.FleetManager)
    # ------------------------------------------------------------------
    def ensure_host(self, host: int) -> ShardTaskExecutor:
        """Create (or revive) the executor slot for ``host`` and take
        it out of the down set.  Stats arrays grow to cover the id.
        Residency is NOT granted here — that happens when a new
        placement generation is swapped in via ``set_placement`` (a
        joiner must be warm before it serves)."""
        h = int(host)
        with self._lock:
            if h not in self.hosts:
                self.hosts[h] = ShardTaskExecutor(
                    workers=self._workers_per_host, **self._executor_kw)
            while len(self.stats["scans_per_host"]) <= h:
                self.stats["scans_per_host"].append(0)
            self.down.discard(h)
        return self.hosts[h]

    def retire_host(self, host: int) -> None:
        """Take ``host`` out of rotation for every future split (crash
        observed, or drain completed).  The executor object is kept —
        in-flight jobs on an older placement generation may still be
        running host groups on it; ``close()`` tears everything down."""
        self.down.add(int(host))

    def set_placement(self, placement: PlacementMap) -> None:
        """RCU-style generation swap: every job captures the placement
        reference at job start, so in-flight jobs finish on the old
        generation while jobs submitted after this call see the new
        one — membership changes never pause serving.  Executor slots
        and stats arrays are grown to cover any new host ids, and the
        balancer (if any) learns the new fleet width."""
        for h in range(placement.n_hosts):
            if h not in self.hosts:
                self.ensure_host(h)
        with self._lock:
            while len(self.stats["scans_per_host"]) < placement.n_hosts:
                self.stats["scans_per_host"].append(0)
        if self.balancer is not None:
            self.balancer.ensure_hosts(placement.n_hosts)
        self.placement = placement
        # the clock is the mint; stats carries the deprecated view
        self.stats["placement_epoch"] = self.clock.bump_placement().placement

    # ------------------------------------------------------------------
    # coordinator pool (one slot per host; warm across jobs)
    # ------------------------------------------------------------------
    def _coordinator(self, width: Optional[int] = None) -> ThreadPoolExecutor:
        need = max(1, int(width if width is not None
                          else self.placement.n_hosts))
        with self._lock:
            if self._coord is None or self._coord_size < need:
                # a grown fleet needs more concurrent host slots; the
                # old pool drains its in-flight host jobs on its own
                old = self._coord
                self._coord = ThreadPoolExecutor(
                    max_workers=need, thread_name_prefix="host-coord")
                self._coord_size = need
                if old is not None:
                    old.shutdown(wait=False)
            return self._coord

    def close(self) -> None:
        """Tear down the coordinator pool and every host's warm pool
        (idempotent)."""
        with self._lock:
            coord, self._coord = self._coord, None
        if coord is not None:
            coord.shutdown(wait=True)
        for ex in self.hosts.values():
            ex.close()

    def __enter__(self) -> "HostGroupExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _run_host(self, host: int, corpus, shard_ids: List[int],
                  fn: Callable[[Any], Any]) -> Tuple[Dict[int, Any], float]:
        """One host group: returns (results, realized wall seconds).
        The wall clock covers the injection hook too, so a simulated
        degraded host is *observed* as slow by the balancer."""
        t0 = time.perf_counter()
        if self.host_fault_hook is not None:
            self.host_fault_hook(host, shard_ids)
        res = self.hosts[host].map_shards(corpus, shard_ids, fn)
        return res, time.perf_counter() - t0

    def _split(self, placement: PlacementMap, shard_ids: Sequence[int],
               dead: frozenset, requeue: bool = False,
               orphans: Optional[List[int]] = None,
               ) -> Tuple[Dict[int, List[int]], Optional[BalanceAudit]]:
        """The one split point for both the initial plan and the
        failure requeue: primary residency without a balancer,
        cost-aware shedding with one (a dead host is just an
        infinitely-hot host, so failover rides the same path).  A
        requeue round is read-only on the balancer: the dead host's
        small group must not flip the hysteresis state or inflate the
        planned-shed stat.  ``placement`` is the generation the job
        captured at start, not ``self.placement`` — membership swaps
        must not move a job's shards mid-flight."""
        if self.balancer is None:
            return placement.split(shard_ids, dead, orphans=orphans), None
        audit = plan_split(placement, shard_ids, self.balancer,
                           dead=dead, update_state=not requeue,
                           orphans=orphans)
        if not requeue:
            self.stats["shed_shards"] += audit.shed
        return audit.groups, audit

    def map_shards(
        self,
        corpus,
        shard_ids: Sequence[int],
        fn: Callable[[Any], Any],
    ) -> Dict[int, Any]:
        """Residency-split ``fn(shard)`` over every id; returns the
        cross-host gather ``{shard_id: result}``.

        Hosts run concurrently; a failed host's group requeues onto
        replica hosts (at-least-once at host granularity) until every
        shard has a result or some shard runs out of live hosts — at
        which point the job raises ``HostFailure``, or with
        ``allow_partial`` returns the shards it *did* gather and
        records the rest on ``last_job["lost_shards"]``."""
        ids = [int(s) for s in shard_ids]
        t_job = time.perf_counter()
        # RCU: capture the placement generation for the whole job —
        # a concurrent set_placement (join/drain) must not reshuffle
        # this job's groups; new jobs pick up the new generation
        placement = self.placement
        if self.job_hook is not None:
            self.job_hook(self.stats["jobs"])
        # per-job dead set starts from the persistent membership down
        # set: crashed/drained hosts never receive work again
        dead: set = set(self.down)
        orphans: Optional[List[int]] = [] if self.allow_partial else None
        pending, audit = self._split(placement, ids, frozenset(dead),
                                     orphans=orphans)
        results: Dict[int, Any] = {}
        per_host: Dict[int, Dict[str, float]] = {}
        realized: Dict[int, int] = {}
        failed: Dict[int, List[int]] = {}
        errors: Dict[int, BaseException] = {}

        def collect(h: int, group: List[int], run) -> None:
            try:
                host_res, wall = run()
            except Exception as exc:
                # the host is dead for the rest of this job: its shard
                # group moves wholesale to replica hosts.  The cause is
                # kept so a job that runs out of replicas raises with
                # the real failure chained — a deterministic bug in a
                # query fn must not masquerade as pure infrastructure
                # loss.
                self.stats["host_failures"] += 1
                dead.add(h)
                failed[h] = group
                errors[h] = exc
                return
            results.update(host_res)
            self.stats["host_jobs"] += 1
            self.stats["scans_per_host"][h] += len(host_res)
            realized[h] = realized.get(h, 0) + len(host_res)
            job = dict(self.hosts[h].last_job or {})
            # realized wall includes the injection hook — the cost the
            # balancer must learn is the host's, not just its pool's —
            # and *accumulates* over rounds: a host that ran its own
            # group and then absorbed a requeued one spent both walls
            job["wall_s"] = wall + per_host.get(h, {}).get("wall_s", 0.0)
            per_host[h] = job
            if self.balancer is not None and host_res:
                self.balancer.observe(h, wall, len(host_res))

        while pending:
            items = list(pending.items())
            # all but the first group go through the coordinator; the
            # first runs on the calling thread — the caller would only
            # block on the gather anyway, and skipping its handoff
            # keeps the common small-batch job at one dispatch
            coord = (self._coordinator(placement.n_hosts)
                     if len(items) > 1 else None)
            futures = [
                (h, g, coord.submit(self._run_host, h, corpus, g, fn))
                for h, g in items[1:]
            ]
            h0, g0 = items[0]
            failed = {}
            collect(h0, g0, lambda: self._run_host(h0, corpus, g0, fn))
            for h, g, fut in futures:
                collect(h, g, fut.result)
            if failed:
                requeue = [sid for group in failed.values()
                           for sid in group]
                self.stats["requeued_shards"] += len(requeue)
                try:
                    pending, _ = self._split(placement, requeue,
                                             frozenset(dead),
                                             requeue=True,
                                             orphans=orphans)
                except HostFailure as hf:
                    # no live replica left: chain the underlying host
                    # exception (the orphaned shard's own host if we
                    # have it, else any from this round)
                    cause = errors.get(hf.host)
                    if cause is None and errors:
                        cause = next(iter(errors.values()))
                    raise hf from cause
            else:
                pending = {}
        # shards that never produced a result: orphans (no live host)
        # plus anything a per-host executor configured with its own
        # allow_partial/deadline gave up on
        lost = [s for s in ids if s not in results]
        if lost and not self.allow_partial:
            raise HostFailure(int(placement.primary[lost[0]]), lost)
        self.stats["lost_shards"] += len(lost)
        self.stats["jobs"] += 1
        medians = [j["median_task_s"] for j in per_host.values()
                   if j.get("median_task_s")]
        walls = {h: j.get("wall_s", 0.0) for h, j in per_host.items()}
        self.last_job = {
            # hosts run concurrently, so the job's service time is the
            # coordinator's critical path (incl. the gather) — this is
            # what the window controller attributes to the shared scan
            "wall_s": time.perf_counter() - t_job,
            "tasks": float(len(ids)),
            "median_task_s": float(np.median(medians)) if medians else 0.0,
            "hosts": float(len(per_host)),
            "per_host_wall_s": walls,
            "lost_shards": float(len(lost)),
        }
        if audit is not None:
            # estimated (at split time) vs realized (measured) per-host
            # makespans, for the bench's run-over-run balance audit
            rec = audit.record()
            rec["realized_wall_s"] = [
                walls.get(h, 0.0) for h in range(placement.n_hosts)]
            rec["realized_group_sizes"] = [
                realized.get(h, 0) for h in range(placement.n_hosts)]
            rec["realized_makespan_s"] = max(walls.values(), default=0.0)
            self.last_job["balance"] = rec
        return results

    def map_shard_batch(
        self,
        corpus,
        plan: Sequence[Sequence[int]],
        fns: Sequence[Callable[[Any], Any]],
        *,
        megakernel: "bool | None" = None,
    ) -> List[Dict[int, Any]]:
        """Locality-split shared scan over a batch of queries: the
        union of the per-query plans is inverted once, split by
        residency, scanned per host (each resident shard visited once,
        all interested queries evaluated in that visit), and gathered
        back into one ``{shard_id: result}`` map per query — exactly
        what the single-executor ``map_shard_batch`` produces.

        With ``MegascanSpec`` scan fns (``megakernel`` None/True, see
        ``run_shared_scan``) each *host* becomes one kernel launch: the
        spec-tagged composite flows through the residency split to the
        per-host ``ShardTaskExecutor``s, whose megakernel route fuses
        their whole group — one task per host instead of one per
        shard-group, with requeue/balance/chaos semantics untouched
        because they all act on the host groups, not on what runs
        inside one."""
        return run_shared_scan(self.map_shards, corpus, plan, fns,
                               megakernel=megakernel)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def residency_split(
            self, plan: Sequence[Sequence[int]]) -> Dict[int, int]:
        """{host: number of union-plan shards resident on it} — the
        per-host scan counts one batch *should* produce (the serving
        bench checks observed scans against this)."""
        union = sorted(invert_plan(plan))
        return {h: len(g) for h, g in self.placement.split(union).items()}
