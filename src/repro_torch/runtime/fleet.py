"""Elastic fleet membership: join / drain / crash as first-class,
audited operations over the placement layer.

``PlacementMap`` is frozen — correct for a single topology, but a
production fleet grows, shrinks, and loses hosts while serving.  The
``FleetManager`` makes membership a *generation swap* rather than a
restart: it builds the next ``PlacementMap`` off-line and installs it
with ``HostGroupExecutor.set_placement`` (RCU-style — every job
captures the placement reference at job start, so in-flight jobs
finish on their old generation while the next job sees the new one;
serving never pauses).

The three operations share one residency-transfer path, extending
the balancer's unification ("a dead host is an infinitely-hot host") to
membership: **a drain is a crash you saw coming.**

``join(host)`` — grow the fleet (or revive a down slot).  The joiner
gets an executor slot immediately but *no residency*: first every
shard it will own is warmed — payload streamed from the host that
currently holds it (``warm_fn(shard_id, source_host, dest_host)``, the
injection point for simulated transfer time) — and only then is the
new generation installed, so a query never routes to a cold host.
Shards are stolen one at a time from the currently most-loaded live
host down to an even share, and the joiner enters the
``HostLoadModel`` with no telemetry, which prices it at the fleet
median (neither feared nor favored) until its own walls arrive.

``drain(host)`` — planned departure.  Residency moves to each shard's
first live replica *before* the host leaves rotation
(``_transfer_residency(..., planned=True)``); replicas already hold
the payload, so the handoff is metadata-only.  In-flight jobs finish
on their captured generation (the drained host's executor object stays
alive until ``close()``), so a drain sheds zero queries and never
widens a CI.

``crash(host)`` — the same transfer, ``planned=False``, in the
opposite order: the host leaves rotation *first* (it is gone now —
in-flight jobs discover the loss through their fault hooks and requeue
on replicas), then residency transfers.  A shard whose replicas are
all down keeps its dead primary and *orphans* at split time — with
``allow_partial`` the query layer degrades to a partial-sample
estimate with a widened CI instead of failing (see
``core/queries/batch.py``).  If the slot later rejoins, those shards
come back with it.

Every operation appends an audit event (op, host, ``planned``, shards
moved/warmed/orphaned, resulting placement epoch) to ``events`` —
same pattern as ``BalanceAudit`` / ``BudgetAudit`` — and the serving
bench's chaos arm replays a scripted crash → degrade → join → recover
scenario against these records (``benchmarks/serve_bench.py``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.placement import HostGroupExecutor, PlacementMap


class FleetManager:
    """Join/drain/crash over a ``HostGroupExecutor``'s placement,
    load model, and per-host executor fleet."""

    def __init__(
        self,
        executor: HostGroupExecutor,
        *,
        warm_fn: Optional[Callable[[int, int, int], None]] = None,
    ):
        self.executor = executor
        # warm_fn(shard_id, source_host, dest_host): called once per
        # shard a joiner must fetch, before residency is granted —
        # simulated payload streaming (a sleep models transfer time)
        self.warm_fn = warm_fn
        self.events: List[dict] = []

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def placement(self) -> PlacementMap:
        return self.executor.placement

    def live_hosts(self) -> List[int]:
        pm = self.executor.placement
        return [h for h in range(pm.n_hosts)
                if h not in self.executor.down]

    def record(self) -> dict:
        """JSON-ready audit summary of every membership event."""
        ops = [e["op"] for e in self.events]
        return dict(
            events=list(self.events),
            joins=ops.count("join"),
            drains=ops.count("drain"),
            crashes=ops.count("crash"),
            live_hosts=self.live_hosts(),
            # read through the one generation authority (the stats key
            # of the same name is the deprecated mirrored view)
            placement_epoch=int(
                self.executor.clock.current().placement),
            generation=self.executor.clock.current().record(),
        )

    # ------------------------------------------------------------------
    # the one residency-transfer path (drain == planned crash)
    # ------------------------------------------------------------------
    def _transfer_residency(
            self, host: int) -> Tuple[PlacementMap, List[int], List[int]]:
        """Move every shard primaried on ``host`` to its first live
        replica.  Returns (new placement, moved shard ids, orphaned
        shard ids) — an orphan has no live replica and keeps its dead
        primary, so it degrades at split time (and revives if the slot
        rejoins)."""
        ex = self.executor
        pm = ex.placement
        h = int(host)
        down = set(ex.down) | {h}
        primary = pm.primary.copy()
        moved: List[int] = []
        orphaned: List[int] = []
        for sid in np.nonzero(primary == h)[0]:
            for r in pm.replicas[sid]:
                if int(r) not in down:
                    primary[sid] = int(r)
                    moved.append(int(sid))
                    break
            else:
                orphaned.append(int(sid))
        new_pm = PlacementMap._with_ring_replicas(
            primary, pm.n_hosts, pm.n_replicas)
        return new_pm, moved, orphaned

    def _audit(self, op: str, host: int, *, planned: bool,
               moved: int, warmed: int = 0, orphaned: int = 0) -> dict:
        ev = dict(op=op, host=int(host), planned=bool(planned),
                  moved_shards=int(moved), warmed_shards=int(warmed),
                  orphaned_shards=int(orphaned),
                  placement_epoch=int(
                      self.executor.clock.current().placement),
                  live_hosts=len(self.live_hosts()))
        self.events.append(ev)
        return ev

    # ------------------------------------------------------------------
    # operations
    # ------------------------------------------------------------------
    def join(self, host: Optional[int] = None) -> dict:
        """Add a host (default: revive the lowest down slot, else grow
        the fleet by one id).  Warm-up precedes residency: every shard
        the joiner will own streams from the host that currently holds
        it, and only once all transfers complete does the placement
        generation swap — a query is never routed to a cold host."""
        ex = self.executor
        pm = ex.placement
        if host is None:
            h = min(ex.down) if ex.down else pm.n_hosts
        else:
            h = int(host)
        n_hosts = max(pm.n_hosts, h + 1)
        ex.ensure_host(h)                 # slot + revival, no residency
        primary = pm.primary.copy()
        live = [x for x in range(n_hosts) if x not in ex.down or x == h]
        counts = {x: int((primary == x).sum()) for x in live}
        target = len(primary) // max(1, len(live))
        warmed: List[int] = []
        while counts.get(h, 0) < target:
            donor = max((x for x in live if x != h),
                        key=lambda x: (counts[x], x), default=None)
            if donor is None or counts[donor] <= counts.get(h, 0) + 1:
                break                     # already as even as it gets
            donor_shards = np.nonzero(primary == donor)[0]
            sid = int(donor_shards[-1])
            if self.warm_fn is not None:
                self.warm_fn(sid, donor, h)
            primary[sid] = h
            counts[donor] -= 1
            counts[h] = counts.get(h, 0) + 1
            warmed.append(sid)
        new_pm = PlacementMap._with_ring_replicas(
            primary, n_hosts, pm.n_replicas)
        ex.set_placement(new_pm)          # residency granted: warm now
        return self._audit("join", h, planned=True,
                           moved=len(warmed), warmed=len(warmed))

    def drain(self, host: int) -> dict:
        """Planned departure: hand residency to live replicas, *then*
        leave rotation.  In-flight jobs finish on their captured
        generation; zero queries shed, no CI widened."""
        ex = self.executor
        new_pm, moved, orphaned = self._transfer_residency(host)
        ex.set_placement(new_pm)
        ex.retire_host(host)
        if ex.balancer is not None:
            ex.balancer.forget_host(host)
        return self._audit("drain", host, planned=True,
                           moved=len(moved), orphaned=len(orphaned))

    def crash(self, host: int) -> dict:
        """Unplanned loss: the host leaves rotation *first* (in-flight
        jobs discover it through their fault hooks and requeue), then
        the same residency transfer runs with ``planned=False``."""
        ex = self.executor
        ex.retire_host(host)
        new_pm, moved, orphaned = self._transfer_residency(host)
        ex.set_placement(new_pm)
        if ex.balancer is not None:
            ex.balancer.forget_host(host)
        return self._audit("crash", host, planned=False,
                           moved=len(moved), orphaned=len(orphaned))
