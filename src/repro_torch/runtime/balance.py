"""Cost-aware, residency-preserving load balancing for shard placement.

The placement layer answers *who can* run a shard (``PlacementMap``:
primary residency + ring replicas); this module answers *who should*.
With skewed phi the sampled shards concentrate on a few hot hosts, and
the job's wall clock is the slowest host's — the classic straggler
bound on partitioned text analytics.  Replicas already hold the data,
so shedding work from a hot host onto a replica keeps every scan local;
the only question is how much to move, which is a cost model plus an
assignment rule:

``HostLoadModel`` — per-host EWMA of realized per-shard scan cost, fed
by the placement executor's per-host wall-time telemetry (each host
group's ``last_job`` wall over its shard count).  Before any telemetry
exists every host is priced identically (``seed_cost_s``), so the
estimated host load degenerates to its residency shard count — the
split starts out count-balanced and sharpens as jobs complete.  A host
that has never run is priced at the fleet median so a cold replica is
neither feared nor favored.

``plan_split`` — the balancer.  It first computes the residency split
(primary hosts, dead primaries falling over to their first live
replica — exactly ``PlacementMap.split``), prices each host group with
the load model, and keeps the residency split unless the balanced
assignment beats its estimated makespan by more than the *hysteresis*
band (stable loads must not flap between near-equal splits: a shard
bouncing hosts invalidates that host's warm caches for no makespan
win).  The band is genuinely hysteretic — the previous decision is
state on the load model, and staying in the balanced split takes only
``stay_fraction`` of the margin that entering it does, so a load
hovering at the threshold keeps whichever split it already runs.
When the gap is real it reassigns with a greedy
longest-processing-time pass: shards ordered by estimated cost, each
placed on the cheapest *eligible* host — eligible meaning the shard's
primary or one of its live replicas, never anywhere else, so every
scan stays on a host that holds the data — followed by a swap pass
that cancels cross-moves (per-shard cost is host-uniform, so
returning misplaced pairs to their base hosts changes nothing about
the makespan and halves the churn).  A dead host is simply
infinitely expensive: it is never eligible, which makes failover a
special case of balancing (one code path for both — see
``HostGroupExecutor.map_shards``).  A shard with no live host raises
``HostFailure`` exactly as the primary-only split does.

The audit trail (``BalanceAudit`` / ``last_job["balance"]``) keeps the
estimated per-host costs, the base and chosen group sizes, and the
estimated makespans of both splits, so the serving bench can compare
estimate vs realized per-host wall time run over run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BalanceConfig:
    """Knobs of the load model + balancer.

    ``ewma_alpha`` weighs the newest per-shard cost observation;
    ``hysteresis`` is the relative makespan margin the balanced split
    must win by before the residency split is abandoned (0.25 = the
    balanced estimate must be >25% better); ``seed_cost_s`` prices a
    shard before any telemetry exists (its absolute value is
    irrelevant while all hosts share it — only ratios matter)."""

    ewma_alpha: float = 0.3
    hysteresis: float = 0.25
    seed_cost_s: float = 1e-3
    # fraction of ``hysteresis`` required to *stay* balanced once the
    # split has switched — the asymmetric band is what makes this real
    # hysteresis (the decision depends on the previous decision), so a
    # load hovering exactly at the entry threshold cannot flap the
    # split every job
    stay_fraction: float = 0.5

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
        if self.hysteresis < 0.0:
            raise ValueError(f"hysteresis must be >= 0, got "
                             f"{self.hysteresis}")
        if not 0.0 <= self.stay_fraction <= 1.0:
            raise ValueError(f"stay_fraction must be in [0, 1], got "
                             f"{self.stay_fraction}")


class HostLoadModel:
    """Per-host EWMA of realized per-shard scan+task wall time.

    ``observe`` is fed after every per-host group completes (wall time
    of the whole host job — scan work plus any injected degradation —
    over the number of shards it scanned); ``shard_cost`` prices one
    shard on a host for the balancer.  Thread-safe: observations land
    from the placement executor's coordinator threads."""

    def __init__(self, n_hosts: int,
                 config: Optional[BalanceConfig] = None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.n_hosts = int(n_hosts)
        self.config = config or BalanceConfig()
        self._cost: List[Optional[float]] = [None] * self.n_hosts
        self._lock = threading.Lock()
        # hysteresis state: was the *previous* plan_split balanced?
        # Living on the model (the object that persists across jobs)
        # makes the keep/shed decision path-dependent — the definition
        # of hysteresis — with an easier bar to stay than to switch.
        self.balanced_mode = False

    def observe(self, host: int, wall_s: float, n_shards: int) -> None:
        """Fold one completed host group into the host's cost EWMA."""
        if n_shards <= 0:
            return
        c = float(wall_s) / float(n_shards)
        a = self.config.ewma_alpha
        with self._lock:
            prev = self._cost[int(host)]
            self._cost[int(host)] = c if prev is None else (
                a * c + (1.0 - a) * prev)

    def shard_cost(self, host: int) -> float:
        """Estimated seconds to scan one shard on ``host``.  Hosts
        without telemetry are priced at the fleet median (uniform
        ``seed_cost_s`` when nothing has run yet), so the cold split
        balances residency shard counts."""
        with self._lock:
            c = self._cost[int(host)]
            seen = [x for x in self._cost if x is not None]
        if c is not None:
            return c
        if seen:
            return float(np.median(seen))
        return self.config.seed_cost_s

    def snapshot(self) -> List[Optional[float]]:
        """Raw per-host EWMA values (None = no telemetry yet)."""
        with self._lock:
            return list(self._cost)

    # ------------------------------------------------------------------
    # fleet membership (see runtime/fleet.FleetManager)
    # ------------------------------------------------------------------
    def ensure_hosts(self, n_hosts: int) -> None:
        """Grow the model to at least ``n_hosts`` slots.  A joining
        host arrives with no telemetry (None), so ``shard_cost`` prices
        it at the fleet median — neither feared nor favored until its
        own realized walls arrive."""
        with self._lock:
            n = int(n_hosts)
            if n > self.n_hosts:
                self._cost.extend([None] * (n - self.n_hosts))
                self.n_hosts = n

    def forget_host(self, host: int) -> None:
        """Drop a departed host's telemetry (crash or drain): if the
        host id ever rejoins it re-enters at the fleet median instead
        of a stale EWMA from its previous life."""
        with self._lock:
            h = int(host)
            if 0 <= h < self.n_hosts:
                self._cost[h] = None


@dataclasses.dataclass
class BalanceAudit:
    """What the balancer decided and why — attached to
    ``HostGroupExecutor.last_job["balance"]`` for run-over-run audit
    (the serving bench compares ``est_makespan_s`` against the realized
    per-host walls)."""

    groups: Dict[int, List[int]]        # the chosen split
    base_groups: Dict[int, List[int]]   # the residency (primary) split
    balanced: bool                      # False = hysteresis kept base
    shed: int                           # shards moved off their base host
    est_cost_s: List[Optional[float]]   # per-host per-shard cost (None=dead)
    est_makespan_s: float               # of the chosen split
    est_base_makespan_s: float          # of the residency split
    n_hosts: int

    def record(self) -> dict:
        """JSON-ready per-host summary (host-indexed lists, no int
        keys — survives a json.dump round-trip unchanged)."""
        sizes = [0] * self.n_hosts
        base_sizes = [0] * self.n_hosts
        for h, g in self.groups.items():
            sizes[h] = len(g)
        for h, g in self.base_groups.items():
            base_sizes[h] = len(g)
        return dict(
            balanced=self.balanced, shed=self.shed,
            group_sizes=sizes, base_group_sizes=base_sizes,
            est_cost_s=self.est_cost_s,
            est_makespan_s=self.est_makespan_s,
            est_base_makespan_s=self.est_base_makespan_s)


def _makespan(groups: Dict[int, List[int]],
              cost: Dict[int, float]) -> float:
    return max((len(g) * cost[h] for h, g in groups.items()),
               default=0.0)


def plan_split(
    placement,
    shard_ids: Sequence[int],
    load: HostLoadModel,
    *,
    dead: frozenset = frozenset(),
    hysteresis: Optional[float] = None,
    update_state: bool = True,
    orphans: Optional[List[int]] = None,
) -> BalanceAudit:
    """Cost-aware, residency-preserving split of ``shard_ids``.

    Starts from the residency split (``placement.split`` — primaries,
    dead primaries failing over to live replicas), and reassigns with a
    greedy longest-processing-time pass over the load model's per-shard
    cost estimates only when the balanced split's estimated makespan
    beats the residency split's by more than the hysteresis band.
    Every shard lands on a host that holds it (primary or live
    replica); raises ``HostFailure`` when a shard has none.

    ``update_state=False`` makes the call read-only on the model's
    hysteresis state: a mid-job failure requeue splits only the dead
    host's small group, and letting that degenerate subset flip
    ``balanced_mode`` would make a transient host loss reset the
    band — the flap the state exists to prevent.

    ``orphans`` mirrors ``PlacementMap.split``: when given, shards
    with no live host are appended there and dropped from the plan
    instead of raising ``HostFailure``."""
    if hysteresis is None:
        hysteresis = load.config.hysteresis
    ids = [int(s) for s in shard_ids]
    # the residency split both seeds the comparison and performs the
    # orphan check (HostFailure / orphan collection) so the two split
    # flavors cannot disagree about liveness
    base = placement.split(ids, dead, orphans=orphans)
    if orphans:
        dropped = set(orphans)
        ids = [s for s in ids if s not in dropped]
    cost = {h: load.shard_cost(h)
            for h in range(placement.n_hosts) if h not in dead}
    est_base = _makespan(base, cost)

    # greedy LPT over estimated per-shard cost: expensive shards first
    # (a shard is priced at its cheapest eligible host — that is the
    # work it contributes wherever it lands in a balanced split),
    # each placed on the eligible host with the least accumulated load
    eligible = {
        sid: [h for h in placement.hosts_of(sid) if h not in dead]
        for sid in ids
    }
    order = sorted(
        range(len(ids)),
        key=lambda i: (-min(cost[h] for h in eligible[ids[i]]), i))
    loads = {h: 0.0 for h in cost}
    assign: Dict[int, List[int]] = {}
    for i in order:
        sid = ids[i]
        h = min(eligible[sid], key=lambda h: (loads[h] + cost[h], h))
        assign.setdefault(h, []).append(sid)
        loads[h] += cost[h]
    est_bal = max((v for v in loads.values() if v > 0.0), default=0.0)

    # asymmetric band = true hysteresis: switching *into* the balanced
    # split takes the full margin, staying in it only ``stay_fraction``
    # of it — a load hovering at the entry threshold keeps whatever
    # split it already runs instead of flapping every job
    band = hysteresis * (load.config.stay_fraction
                         if load.balanced_mode else 1.0)
    if est_base <= (1.0 + band) * est_bal:
        # within the band: keep the residency split (no flapping —
        # marginal estimated wins do not justify moving warm shards)
        if update_state:
            load.balanced_mode = False
        return BalanceAudit(
            groups=base, base_groups=base, balanced=False, shed=0,
            est_cost_s=[cost.get(h) for h in range(placement.n_hosts)],
            est_makespan_s=est_base, est_base_makespan_s=est_base,
            n_hosts=placement.n_hosts)
    if update_state:
        load.balanced_mode = True

    # churn minimization: per-shard cost is host-uniform, so exchanging
    # a pair of misplaced shards between two hosts returns both to
    # their base (residency) host while keeping every group size — and
    # hence the estimated makespan — unchanged.  Returning to the base
    # host is always residency-safe: the base split put the shard there
    # with the same dead set.
    base_host = {sid: h for h, g in base.items() for sid in g}
    hosts_used = sorted(assign)
    for ai, h1 in enumerate(hosts_used):
        for h2 in hosts_used[ai + 1:]:
            away1 = [s for s in assign[h1] if base_host[s] == h2]
            away2 = [s for s in assign[h2] if base_host[s] == h1]
            for x, y in zip(away1, away2):
                assign[h1][assign[h1].index(x)] = y
                assign[h2][assign[h2].index(y)] = x

    # restore input order inside each group (determinism: downstream
    # scans and tests see shards in submission order, as split() does)
    pos = {sid: i for i, sid in reversed(list(enumerate(ids)))}
    groups = {h: sorted(g, key=lambda s: pos[s])
              for h, g in assign.items()}
    shed = sum(1 for h, g in groups.items()
               for sid in g if base_host[sid] != h)
    return BalanceAudit(
        groups=groups, base_groups=base, balanced=True, shed=shed,
        est_cost_s=[cost.get(h) for h in range(placement.n_hosts)],
        est_makespan_s=est_bal, est_base_makespan_s=est_base,
        n_hosts=placement.n_hosts)
