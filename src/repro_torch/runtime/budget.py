"""Error/latency budgets and SLO-driven sampling-rate planning.

The paper's contribution is an accuracy<->speed dial (the sampling
``rate``), but as static config every query in
a batch runs at the same rate, and the only overload response is to
refuse work (``Backpressure``).  This module turns the dial into the
runtime's *second actuator*:

``QueryBudget`` — what a request is allowed to cost, in either
currency.  An *error* budget ("±5% relative at 95% confidence") asks
for the smallest rate whose estimated error bound fits; a *latency*
budget ("p99 <= 50 ms, best accuracy that fits") asks for the largest
rate whose estimated sojourn fits.  ``floor_rate`` is the degradation
floor: under overload the planner may squeeze the query down to — but
never below — this rate.

``RatePlanner`` — inverts two models to pick per-query rates:

  * For aggregation the paper's own variance model (Eq 2) is
    closed-form invertible: the relative half-width at ``n`` sampled
    shards is ``e(n) ~= t_{n-1,conf} * s_rel / sqrt(n)`` for a
    workload-dependent dispersion scale ``s_rel``.  ``_ErrCurve``
    learns ``s_rel`` online (EWMA over realized ``e * sqrt(n) / t``
    from every served estimate) and ``required_n`` scans the monotone
    curve for the smallest ``n`` meeting the target.  Boolean and
    ranked queries get the same curve *shape* fitted to their own
    realized errors (bootstrap CI width, 1 - top-k stability) — no
    closed form exists, but the 1/sqrt(n) decay is the right family
    and the EWMA keeps it honest.
  * For latency the controller's cost model prices the work:
    ``WindowController.service_cost`` gives batch service time at the
    current plan, and scan work scales ~linearly with rate, so the
    estimated p99 at rate ``r`` is the plan's ``est_p99_s`` scaled by
    ``r / ref_rate`` (``ref_rate`` = EWMA of recently served rates).

``plan_batch`` applies the *degradation ladder* on top: given the
controller's pressure ``d`` in [0, 1], each query's planned rate slides
linearly from its plan (d=0) toward its floor (d=1), so overload
degrades accuracy before it degrades availability.  The decision is
recorded in a ``BudgetAudit`` (mirroring ``balance.BalanceAudit``) that
lands on ``last_job["budget"]`` with planned-vs-realized error so the
serving bench can check the planner's calibration run over run.

Layering: this module sits beside ``controller`` (it *reads* the
controller's models, never drives it) and below ``core.queries.batch``
(the batch engine imports the planner; nothing here imports core).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.utils.stats import t_critical_value


@dataclasses.dataclass(frozen=True)
class QueryBudget:
    """What one query is allowed to cost.

    At least one of ``max_rel_error`` (error budget: smallest rate
    whose estimated relative error bound fits, at ``confidence``) and
    ``max_latency_s`` (latency budget: largest rate whose estimated
    p99 sojourn fits) must be set; with both, the error budget asks
    for a rate and the latency budget caps it.  ``floor_rate`` bounds
    graceful degradation — overload may squeeze the query to the
    floor, never below it."""

    max_rel_error: Optional[float] = None
    confidence: float = 0.95
    max_latency_s: Optional[float] = None
    floor_rate: float = 0.05

    def __post_init__(self):
        if self.max_rel_error is None and self.max_latency_s is None:
            raise ValueError(
                "QueryBudget needs max_rel_error and/or max_latency_s")
        if self.max_rel_error is not None and self.max_rel_error <= 0:
            raise ValueError(
                f"max_rel_error must be > 0, got {self.max_rel_error}")
        if self.max_latency_s is not None and self.max_latency_s <= 0:
            raise ValueError(
                f"max_latency_s must be > 0, got {self.max_latency_s}")
        if not 0.0 < self.confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1), got {self.confidence}")
        if not 0.0 < self.floor_rate <= 1.0:
            raise ValueError(
                f"floor_rate must be in (0, 1], got {self.floor_rate}")


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Knobs of ``RatePlanner``.

    ``default_floor_rate`` is the degradation floor for queries that
    carry no budget of their own; ``curve_alpha`` the EWMA gain for the
    per-kind error curves; ``seed_rel_scale`` the dispersion scale
    assumed before any estimate has been observed (1.0 = per-draw
    relative spread about equal to the mean — deliberately pessimistic,
    so cold planning over-samples rather than blowing budgets)."""

    default_floor_rate: float = 0.1
    curve_alpha: float = 0.3
    seed_rel_scale: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.default_floor_rate <= 1.0:
            raise ValueError(f"default_floor_rate must be in (0, 1], got "
                             f"{self.default_floor_rate}")
        if not 0.0 < self.curve_alpha <= 1.0:
            raise ValueError(f"curve_alpha must be in (0, 1], got "
                             f"{self.curve_alpha}")
        if self.seed_rel_scale <= 0:
            raise ValueError(f"seed_rel_scale must be > 0, got "
                             f"{self.seed_rel_scale}")


class _ErrCurve:
    """The invertible error model ``e(n) = t_{n-1,conf} * s_rel /
    sqrt(n)`` for one query kind, with ``s_rel`` learned online.

    Every served estimate yields one observation ``s_rel_obs =
    e * sqrt(n) / t_{n-1}`` (solving the model for the scale), folded
    in with exponential forgetting.  ``required_n`` inverts: ``e(n)``
    is monotone decreasing in ``n`` (t falls, sqrt grows), so a linear
    scan finds the smallest sample size meeting a target."""

    def __init__(self, alpha: float, seed_rel_scale: float):
        self.alpha = float(alpha)
        self.seed = float(seed_rel_scale)
        self.s_rel: Optional[float] = None
        self.count = 0

    def observe(self, n: int, rel_error: float,
                confidence: float = 0.95) -> None:
        """Fold one realized (sample size, relative error) pair in.
        Degenerate observations (n < 2: no variance estimate; infinite
        or zero error: no scale information) are skipped."""
        if n < 2 or not math.isfinite(rel_error) or rel_error <= 0:
            return
        obs = rel_error * math.sqrt(n) / t_critical_value(n - 1, confidence)
        self.s_rel = obs if self.s_rel is None else (
            self.s_rel + self.alpha * (obs - self.s_rel))
        self.count += 1

    def scale(self) -> float:
        return self.s_rel if self.s_rel is not None else self.seed

    def predict(self, n: int, confidence: float = 0.95) -> float:
        """Estimated relative error bound at ``n`` sampled shards."""
        if n < 2:
            return float("inf")
        return t_critical_value(n - 1, confidence) * self.scale() / math.sqrt(n)

    def required_n(self, target_rel_error: float, confidence: float,
                   n_max: int) -> int:
        """Smallest ``n <= n_max`` with ``predict(n) <= target``;
        ``n_max`` (a census) when no sample size fits."""
        for n in range(2, max(n_max, 2) + 1):
            if self.predict(n, confidence) <= target_rel_error:
                return n
        return max(n_max, 2)


@dataclasses.dataclass
class BudgetAudit:
    """What the planner decided for one batch and why — the budget
    analogue of ``balance.BalanceAudit``, attached to
    ``last_job["budget"]`` so serving telemetry can compare the
    planner's predicted error against what the estimators actually
    reported."""

    base_rate: float                     # the caller's nominal rate
    pressure: float                      # controller degradation in [0,1]
    kinds: List[str]                     # per query
    planned_rates: List[float]           # after budgets + degradation
    undegraded_rates: List[float]        # budgets only (pressure = 0)
    floors: List[float]                  # per-query degradation floor
    budgeted: int                        # queries carrying a QueryBudget
    est_rel_error: List[Optional[float]]      # planner's prediction
    realized_rel_error: List[Optional[float]] = dataclasses.field(
        default_factory=list)            # filled after execution
    # filled after execution when the gather came back partial (hosts
    # lost with no live replica): queries whose reduce ran over a
    # smaller surviving sample, and the total shards they lost
    partial_queries: int = 0
    lost_shards: int = 0

    @property
    def degraded(self) -> int:
        """Queries served below their undegraded plan."""
        return sum(1 for p, u in zip(self.planned_rates,
                                     self.undegraded_rates)
                   if p < u - 1e-12)

    @property
    def at_floor(self) -> int:
        """Queries already squeezed to their floor — when this equals
        the batch size, degradation has nothing left to give and
        shedding is the only remaining actuator."""
        return sum(1 for p, f in zip(self.planned_rates, self.floors)
                   if p <= f + 1e-12)

    def record(self) -> dict:
        """JSON-ready summary (finite-or-None floats only)."""
        def clean(xs):
            return [None if x is None or not math.isfinite(x) else float(x)
                    for x in xs]
        return dict(
            base_rate=self.base_rate, pressure=self.pressure,
            budgeted=self.budgeted, degraded=self.degraded,
            at_floor=self.at_floor,
            planned_rates=[float(r) for r in self.planned_rates],
            undegraded_rates=[float(r) for r in self.undegraded_rates],
            floors=[float(f) for f in self.floors],
            est_rel_error=clean(self.est_rel_error),
            realized_rel_error=clean(self.realized_rel_error),
            partial_queries=self.partial_queries,
            lost_shards=self.lost_shards)


class RatePlanner:
    """Per-query sampling-rate planning against error/latency budgets.

    One instance serves one (corpus, controller) pair and learns
    across batches; ``QueryBatch`` calls ``plan_batch`` before
    sampling and ``observe_result`` after reducing.  Thread-safety
    matches the engine's: the window dispatcher serializes batches, so
    no internal locking is needed."""

    KINDS = ("count", "bool", "ranked")

    def __init__(self, n_shards: int, *,
                 config: Optional[PlannerConfig] = None,
                 controller=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.config = config or PlannerConfig()
        self.controller = controller
        self._curves: Dict[str, _ErrCurve] = {
            k: _ErrCurve(self.config.curve_alpha,
                         self.config.seed_rel_scale)
            for k in self.KINDS}
        # EWMA of rates actually served — the reference point for
        # scaling the controller's p99 estimate to other rates
        self._ref_rate: Optional[float] = None

    # ------------------------------------------------------------------
    # models
    # ------------------------------------------------------------------
    def curve(self, kind: str) -> _ErrCurve:
        return self._curves[kind]

    def est_rel_error(self, kind: str, rate: float,
                      confidence: float = 0.95) -> float:
        """Predicted relative error bound for ``kind`` at ``rate``."""
        n = max(1, int(math.ceil(rate * self.n_shards)))
        return self._curves[kind].predict(n, confidence)

    def _latency_cap(self, max_latency_s: float,
                     base_rate: float) -> float:
        """Largest rate whose estimated p99 sojourn fits the latency
        budget, from the controller's current plan scaled linearly in
        rate (scan work dominates batch service and is proportional to
        shards read).  Without a controller or plan there is no cost
        model — return ``base_rate`` (never degrade on a guess)."""
        plan = (self.controller.current_plan
                if self.controller is not None else None)
        if plan is None or not math.isfinite(plan.est_p99_s):
            return base_rate
        ref = self._ref_rate if self._ref_rate else base_rate
        if plan.est_p99_s <= 0 or ref <= 0:
            return base_rate
        return ref * max_latency_s / plan.est_p99_s

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def plan_rate(self, kind: str, budget: Optional[QueryBudget],
                  base_rate: float) -> float:
        """The rate one query should sample at, ignoring pressure.

        No budget -> the caller's nominal rate, untouched (bit-for-bit
        parity with unbudgeted serving, including the precise rate=1.0
        path).  An error budget asks for the smallest sufficient rate,
        a latency budget caps it at the largest affordable one; both
        clamp to [floor_rate, 1.0]."""
        if budget is None:
            return base_rate
        rate = base_rate
        if budget.max_rel_error is not None:
            n_req = self._curves[kind].required_n(
                budget.max_rel_error, budget.confidence, self.n_shards)
            rate = n_req / self.n_shards
        if budget.max_latency_s is not None:
            cap = self._latency_cap(budget.max_latency_s, base_rate)
            if budget.max_rel_error is not None:
                rate = min(rate, cap)
            else:
                rate = cap          # best accuracy that fits
        return min(max(rate, budget.floor_rate), 1.0)

    def plan_batch(self, queries: Sequence[Any], base_rate: float,
                   pressure: float = 0.0
                   ) -> Tuple[List[float], BudgetAudit]:
        """Per-query rates for one batch, with the degradation ladder
        applied: each rate slides linearly from its plan (pressure 0)
        toward its floor (pressure 1).  Unbudgeted queries degrade
        toward ``config.default_floor_rate`` — overload is a property
        of the batch, not of who declared a budget."""
        pressure = min(max(float(pressure), 0.0), 1.0)
        kinds, planned, undegraded, floors, est_err = [], [], [], [], []
        budgeted = 0
        for q in queries:
            budget = getattr(q, "budget", None)
            kind = getattr(q, "kind", "count")
            if budget is not None:
                budgeted += 1
                floor = budget.floor_rate
                conf = budget.confidence
            else:
                floor = self.config.default_floor_rate
                conf = 0.95
            r0 = self.plan_rate(kind, budget, base_rate)
            r = r0
            if pressure > 0.0 and r > floor:
                r = floor + (1.0 - pressure) * (r - floor)
            kinds.append(kind)
            undegraded.append(r0)
            planned.append(r)
            floors.append(min(floor, r0))
            e = self.est_rel_error(kind, r, conf)
            est_err.append(e if math.isfinite(e) else None)
        audit = BudgetAudit(
            base_rate=float(base_rate), pressure=pressure, kinds=kinds,
            planned_rates=planned, undegraded_rates=undegraded,
            floors=floors, budgeted=budgeted, est_rel_error=est_err)
        return planned, audit

    # ------------------------------------------------------------------
    # feedback
    # ------------------------------------------------------------------
    def observe_result(self, kind: str, rate: float, n: int,
                       rel_error: float,
                       confidence: float = 0.95) -> None:
        """Fold one served query's realized (n, relative error) into
        its kind's curve and the reference-rate EWMA."""
        self._curves[kind].observe(n, rel_error, confidence)
        if 0.0 < rate <= 1.0:
            a = self.config.curve_alpha
            self._ref_rate = rate if self._ref_rate is None else (
                self._ref_rate + a * (rate - self._ref_rate))
