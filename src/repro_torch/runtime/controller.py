"""Queueing-theory batch-window controller (serving-time autotuning).

``BatchWindow``'s static (deadline, max_batch) pair is wrong at both
ends of the load curve: at low traffic a lone query waits out the full
deadline for a batch that never fills, and at high traffic a too-small
window underfills the batched engine's amortization while a too-large
one lets the single dispatcher saturate with no signal to callers.
``WindowController`` closes the loop:

  * **Arrival model** — an EWMA over inter-arrival gaps gives the
    instantaneous arrival rate ``lambda``.  A second, slower EWMA of
    squared gap deviations gives a burstiness hint (diagnostic only).
  * **Service model** — per-batch observations ``(n, service_s)`` feed
    exponentially-weighted first/second moments from which a batch
    cost line ``s(n) = c0 + c1 * n`` is recovered (covariance over
    variance; the same running-moments trick as Welford, but with
    exponential forgetting so the model tracks warmup -> warm shifts).
    ``c0`` is the per-window overhead the batch amortizes (planning,
    dispatch, kernel launch), ``c1`` the marginal per-query cost.
    The cost model is *piecewise*: observations route into a small-n
    fit (``n < pivot_batch``) and a large-n fit, and the planner costs
    each candidate from the fit of the regime its predicted batch size
    falls in (``service_cost``), falling back to the pooled all-sizes
    line until a regime has data.  One pooled line systematically
    overestimates small windows — the shared scan's union coverage
    saturates with batch size, so the true s(n) is concave, and an
    intercept fitted mostly from large batches charges a 1-2 query
    window far more than it costs.  In the *transition* band (arrivals
    ~0.5-1.5x batched capacity) that inflated small-n cost made the
    planner flee to long deadlines the static 2 ms pair beat; the
    small-n fit restores honest pricing there.
  * **Plan** — on every batch completion (and at least every
    ``control_period_s``) the controller sweeps a small candidate grid
    (geometric deadlines x doubling batch sizes, both clamped to
    configured bounds) and picks the pair minimizing the estimated p99
    sojourn of a query under the current ``lambda``.  Each candidate is
    scored under the better of two regimes:

    arrival-fed (windows open on an empty queue and fill from fresh
    arrivals — the light/moderate-load regime):

        fill   = (B - 1) / lambda          time for a window to fill
        closes by size  if fill <= d  ->  n = B,           wait = fill
        closes by deadline otherwise  ->  n = 1 + lambda*d, wait = d

    queue-fed (a standing backlog stuffs every window to B the moment
    it opens — scored only when the arrival-fed regime is unstable,
    because that instability is precisely the condition under which a
    backlog forms; crediting queue-fed batching at light load would
    chase batches the queue can never supply):

        n = B, wait = min(d, fill)

    and in either regime:

        s      = c0 + c1 * n               batch service time
        rho    = lambda * s / n            dispatcher utilization
        queue  = rho / (1 - rho) * s / 2   M/G/1-flavored mean wait
        p99    ~= wait + TAIL_P99 * queue + s

    (``TAIL_P99``: tail factor mapping the mean queue wait to a p99
    estimate; see its definition for why it is lighter than the
    exponential ln(100).)
    ``rho >= 1`` in a regime marks it unstable (infinite sojourn); if
    *every* candidate is unstable in *both* regimes the plan pins
    (min deadline, max batch) — serve immediately, amortize maximally,
    the backlog does the batching — and reports saturation.

The qualitative behavior this buys (pinned by tests/test_controller.py):
under light load the chosen deadline collapses toward ``min_delay_s``
(a lone query's sojourn is ``d + s(1)``, so the optimizer shrinks
``d``); under heavy load the chosen batch grows toward ``max_batch``
(amortizing ``c0`` is the only way to keep ``rho < 1``).

**Backpressure** — the dispatcher saturating is a *caller's* problem
too: ``BatchWindow`` bounds its pending queue and sheds with the typed
``Backpressure`` signal once the bound is hit, so upstream load
balancers see a crisp, immediate reject instead of a silently growing
sojourn.  ``Backpressure`` carries the queue depth and the controller's
current utilization estimate for the caller's retry policy.

All entry points take an explicit ``now`` timestamp (defaulting to
``time.perf_counter()``) so tests drive synthetic clocks.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

# Tail factor mapping the mean queue wait to a p99 estimate.  A pure
# exponential tail would give ln(100) ~ 4.6, but batch service here is
# near-deterministic (one shared scan over a similar shard union every
# window), so the M/D/1-flavored tail is far lighter; ln(10) keeps the
# ordering pressure of the tail without making moderate utilization
# look catastrophic (which drove the planner to long idle deadlines).
TAIL_P99 = math.log(10.0)


class Backpressure(RuntimeError):
    """The serving window's pending queue is at its bound: the query was
    shed, not enqueued.  Retry with jitter or divert to another replica.
    ``depth`` is the queue depth at rejection; ``utilization`` the
    controller's dispatcher-utilization estimate (>= 1.0 ~ saturated),
    or None when the window runs without a controller.
    ``retry_after_s`` is the controller's estimate of when capacity
    frees up — the current window deadline plus one full-batch service
    time — so a shed caller can back off for one serving cycle instead
    of hot-retrying into the same full queue (None without a
    controller)."""

    def __init__(self, depth: int, utilization: Optional[float] = None,
                 retry_after_s: Optional[float] = None):
        self.depth = depth
        self.utilization = utilization
        self.retry_after_s = retry_after_s
        util = (f", utilization ~{utilization:.2f}"
                if utilization is not None else "")
        retry = (f", retry after ~{retry_after_s * 1e3:.1f} ms"
                 if retry_after_s is not None else "")
        super().__init__(
            f"batch window pending queue full ({depth} queued{util}{retry})")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Bounds and gains for ``WindowController``."""
    min_delay_s: float = 1e-4       # never close faster than dispatch cost
    max_delay_s: float = 0.02       # latency ceiling at any load
    min_batch: int = 1
    max_batch: int = 128
    control_period_s: float = 0.05  # re-plan cadence
    arrival_alpha: float = 0.1      # EWMA gain for inter-arrival gaps
    service_alpha: float = 0.2      # EWMA gain for batch-cost moments
    n_delay_candidates: int = 8     # geometric grid resolution
    pivot_batch: int = 8            # small-n / large-n regime boundary
    #                                 (1 collapses to one pooled fit)
    # degradation ladder (the second actuator): utilization above
    # ``degrade_enter_util`` ratchets pressure up by ``degrade_step``
    # per replan, utilization below ``degrade_exit_util`` ratchets it
    # down — the gap between the two thresholds is the hysteresis dead
    # band (mirroring balance.py's asymmetric band) so pressure does
    # not flap when load hovers at the threshold
    degrade_enter_util: float = 0.85
    degrade_exit_util: float = 0.6
    degrade_step: float = 0.25

    def __post_init__(self):
        if not (0 < self.min_delay_s <= self.max_delay_s):
            raise ValueError(
                f"need 0 < min_delay_s <= max_delay_s, got "
                f"{self.min_delay_s} / {self.max_delay_s}")
        if not (1 <= self.min_batch <= self.max_batch):
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got "
                f"{self.min_batch} / {self.max_batch}")
        for name in ("arrival_alpha", "service_alpha"):
            a = getattr(self, name)
            if not (0 < a <= 1):
                raise ValueError(f"{name} must be in (0, 1], got {a}")
        if self.pivot_batch < 1:
            raise ValueError(
                f"pivot_batch must be >= 1, got {self.pivot_batch}")
        if not (0.0 <= self.degrade_exit_util < self.degrade_enter_util):
            raise ValueError(
                f"need 0 <= degrade_exit_util < degrade_enter_util, got "
                f"{self.degrade_exit_util} / {self.degrade_enter_util}")
        if not (0.0 < self.degrade_step <= 1.0):
            raise ValueError(
                f"degrade_step must be in (0, 1], got {self.degrade_step}")


class _CostFit:
    """Exponentially-forgotten first/second moments of (n, service_s)
    observations for one batch-size regime, recoverable as a cost line
    (the covariance-over-variance fit ``service_model`` documents).
    ``seed`` pre-loads a benign prior (the pooled fit uses one so the
    first plan is sane before any batch completes); unseeded fits
    initialize from their first observation."""

    def __init__(self, alpha: float, seed_per_item_s: float,
                 seed: Optional[Tuple[float, float]] = None):
        self.alpha = float(alpha)
        self.seed_per_item = float(seed_per_item_s)
        self.count = 0
        self.m_n = self.m_s = self.m_nn = self.m_ns = 0.0
        if seed is not None:
            n, s = seed
            self.m_n, self.m_s = float(n), float(s)
            self.m_nn, self.m_ns = float(n * n), float(n * s)

    def observe(self, n: float, s: float) -> None:
        if self.count == 0 and self.m_nn == 0.0:
            self.m_n, self.m_s = n, s
            self.m_nn, self.m_ns = n * n, n * s
        else:
            a = self.alpha
            self.m_n += a * (n - self.m_n)
            self.m_s += a * (s - self.m_s)
            self.m_nn += a * (n * n - self.m_nn)
            self.m_ns += a * (n * s - self.m_ns)
        self.count += 1

    def line(self) -> Tuple[float, float]:
        """``(c0, c1)`` of ``s(n) = c0 + c1 * n`` over this regime's
        observations.  The covariance fit is only trusted once the
        observed batch sizes genuinely spread (var >= 0.25, i.e. more
        than jitter around one size): a fit over near-identical sizes
        amplifies service-time noise into wild marginal costs, and one
        bad transient ``c1`` is enough to misplan a long idle deadline
        straight into the sojourn tail.  Near-constant sizes instead
        split the mean cost with the seeded marginal estimate."""
        var_n = self.m_nn - self.m_n * self.m_n
        cov = self.m_ns - self.m_n * self.m_s
        if var_n >= 0.25 and cov > 0:
            c1 = min(cov / var_n, self.m_s / max(self.m_n, 1.0))
            return max(self.m_s - c1 * self.m_n, 0.0), c1
        c1 = min(self.seed_per_item, self.m_s / max(self.m_n, 1.0))
        return max(self.m_s - c1 * self.m_n, 0.0), c1


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One control decision: the (deadline, batch) pair to serve with,
    plus the estimates that chose it (surfaced in stats/benchmarks)."""
    delay_s: float
    max_batch: int
    est_p99_s: float            # estimated p99 sojourn under the plan
    utilization: float          # rho at the chosen candidate
    arrival_rate: float         # lambda the plan was computed for
    saturated: bool             # every candidate had rho >= 1


class WindowController:
    """Picks (deadline, max_batch) minimizing estimated p99 sojourn.

    Not thread-safe by itself; ``BatchWindow`` serializes calls under
    its own condition lock (producers call ``observe_arrival`` /
    ``window_params`` while holding it, the dispatcher calls
    ``observe_batch``)."""

    def __init__(self, config: Optional[ControllerConfig] = None, *,
                 seed_service_s: float = 1e-3,
                 seed_per_item_s: float = 1e-4):
        self.config = config or ControllerConfig()
        self._last_arrival: Optional[float] = None
        self._mean_gap: Optional[float] = None   # EWMA inter-arrival gap
        self._gap_var: float = 0.0               # EWMA squared deviation
        # piecewise service model: every observation feeds the pooled
        # all-sizes fit (seeded with a benign 1-query prior so the first
        # plan is sane before any batch has completed) plus the fit of
        # its size regime; candidates are costed from their regime's fit
        # once it has data (see service_cost)
        a = self.config.service_alpha
        self._fit_all = _CostFit(a, seed_per_item_s,
                                 seed=(1.0, float(seed_service_s)))
        self._fit_small = _CostFit(a, seed_per_item_s)
        self._fit_large = _CostFit(a, seed_per_item_s)
        self._n_batches = 0
        self._scan_s: Optional[float] = None     # executor telemetry EWMA
        self._plan: Optional[WindowPlan] = None
        self._plan_at: float = -math.inf
        # degradation pressure in [0, 1]: the accuracy actuator's
        # position (0 = every query at its planned rate, 1 = every
        # query at its budget floor); ratcheted by plan() under the
        # asymmetric utilization band, escalated to 1.0 by the window
        # when the pending queue hits its bound
        self._pressure: float = 0.0

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def observe_arrival(self, now: Optional[float] = None) -> None:
        """One query arrived at ``now``; update the arrival-rate EWMA."""
        now = time.perf_counter() if now is None else now
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 1e-9)
            a = self.config.arrival_alpha
            if self._mean_gap is None:
                self._mean_gap = gap
            else:
                dev = gap - self._mean_gap
                self._mean_gap += a * dev
                self._gap_var += a * (dev * dev - self._gap_var)
        self._last_arrival = now

    def observe_batch(self, n: int, service_s: float,
                      scan_s: Optional[float] = None,
                      cached: int = 0) -> None:
        """One window of ``n`` queries took ``service_s`` to execute.
        ``scan_s`` is the executor's per-job service telemetry (the
        shared-scan share of the batch; see
        ``ShardTaskExecutor.last_job``) — tracked so saturation can be
        attributed to scan work vs engine overhead.

        ``cached`` is how many of the ``n`` were served straight from
        the semantic query cache (``runtime/qcache`` exact hits): they
        cost ~no service time, so they are excluded from the cost fit
        — folding them in would deflate the fitted per-query cost and
        make the planner promise capacity the uncached path cannot
        deliver.  An all-cached window is dropped entirely (near-hits
        still scan, so they count as executed)."""
        n = int(n) - int(cached)
        if n < 1 or service_s < 0:
            return
        a = self.config.service_alpha
        self._fit_all.observe(float(n), float(service_s))
        regime = (self._fit_small if n < self.config.pivot_batch
                  else self._fit_large)
        regime.observe(float(n), float(service_s))
        if scan_s is not None:
            self._scan_s = (scan_s if self._scan_s is None else
                            self._scan_s + a * (scan_s - self._scan_s))
        self._n_batches += 1
        # a fresh service observation invalidates the cached plan: one
        # batch against a cold (seeded) cost model can shift the
        # estimate by 10x, and replanning is 72 multiply-adds
        self._plan_at = -math.inf

    # ------------------------------------------------------------------
    # models
    # ------------------------------------------------------------------
    @property
    def arrival_rate(self) -> float:
        """Queries/sec (EWMA); 0.0 until two arrivals have been seen."""
        if self._mean_gap is None or self._mean_gap <= 0:
            return 0.0
        return 1.0 / self._mean_gap

    def service_model(self) -> Tuple[float, float]:
        """``(c0, c1)`` of the *pooled* (all sizes) batch cost line
        ``s(n) = c0 + c1 * n`` — the fallback the planner uses until a
        size regime has its own observations, and the stable summary
        surfaced in stats (see ``_CostFit.line`` for the fit guard)."""
        return self._fit_all.line()

    def service_cost(self, n: float) -> float:
        """Estimated batch service time ``s(n)`` under the piecewise
        cost model: the fit of ``n``'s own size regime (small-n below
        ``pivot_batch``, large-n at or above it) once that regime has
        seen at least two batches, else the pooled line.  Two
        observations, not one — a single batch is indistinguishable
        from noise, and the regime fit replaces the pooled line
        entirely for its half of the candidate grid."""
        fit = (self._fit_small if n < self.config.pivot_batch
               else self._fit_large)
        c0, c1 = fit.line() if fit.count >= 2 else self._fit_all.line()
        return c0 + c1 * n

    @property
    def scan_fraction(self) -> Optional[float]:
        """Share of batch service spent in the executor's shared scan
        (None until executor telemetry has been observed)."""
        if self._scan_s is None or self._fit_all.m_s <= 0:
            return None
        return min(self._scan_s / self._fit_all.m_s, 1.0)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def _regime_p99(self, lam: float, n: float,
                    wait: float) -> Tuple[float, float]:
        s = self.service_cost(n)
        rho = lam * s / max(n, 1.0)
        if rho >= 1.0:
            return math.inf, rho
        queue = rho / (1.0 - rho) * s / 2.0
        return wait + TAIL_P99 * queue + s, rho

    def _estimate_p99(self, lam: float, d: float,
                      batch: int) -> Tuple[float, float]:
        """(estimated p99 sojourn, utilization) for one candidate: the
        better of the arrival-fed and queue-fed regimes (see module
        docstring), costed by the piecewise model at the batch size the
        regime predicts."""
        if lam <= 0:
            # no traffic: a lone query waits the full deadline
            return d + self.service_cost(1.0), 0.0
        fill = (batch - 1) / lam
        if fill <= d:
            n, wait = float(batch), fill
        else:
            n, wait = min(1.0 + lam * d, float(batch)), d
        arrival = self._regime_p99(lam, n, wait)
        if not math.isinf(arrival[0]):
            return arrival
        # arrival-fed service can't keep up, so a backlog forms and
        # feeds full windows; the deadline only delays dispatch
        return self._regime_p99(lam, float(batch), min(d, fill))

    def _candidates(self) -> Tuple[List[float], List[int]]:
        cfg = self.config
        k = max(cfg.n_delay_candidates, 2)
        ratio = cfg.max_delay_s / cfg.min_delay_s
        delays = [cfg.min_delay_s * ratio ** (i / (k - 1)) for i in range(k)]
        batches, b = [], cfg.min_batch
        while b < cfg.max_batch:
            batches.append(b)
            b *= 2
        batches.append(cfg.max_batch)
        return delays, batches

    def plan(self, now: Optional[float] = None) -> WindowPlan:
        """Recompute the plan unconditionally (tests and ``window_params``
        call this; serving code wants ``window_params``)."""
        now = time.perf_counter() if now is None else now
        lam = self.arrival_rate
        delays, batches = self._candidates()
        best: Optional[Tuple[float, float, float, int]] = None
        for d in delays:
            for b in batches:
                p99, rho = self._estimate_p99(lam, d, b)
                key = (p99, d, b)
                if best is None or key < (best[0], best[2], best[3]):
                    best = (p99, rho, d, b)
        p99, rho, d, b = best
        saturated = math.isinf(p99)
        if saturated:
            # No stable candidate: under overload the backlog itself
            # forms the batches (a full queue size-closes the window
            # instantly), so waiting out a long deadline only adds
            # latency — serve immediately with the largest batch and
            # let backpressure shed the excess.
            d, b = self.config.min_delay_s, self.config.max_batch
            _, rho = self._estimate_p99(lam, d, b)
        self._plan = WindowPlan(d, b, p99, rho, lam, saturated)
        self._plan_at = now
        # degradation ladder: ratchet pressure inside the asymmetric
        # utilization band (enter high, exit low — the dead band
        # between them is hysteresis against flapping, as in
        # balance.py).  Saturation counts as over-threshold even when
        # rho at the pinned fallback plan reads < 1.
        cfg = self.config
        if saturated or rho >= cfg.degrade_enter_util:
            self._pressure = min(1.0, self._pressure + cfg.degrade_step)
        elif rho <= cfg.degrade_exit_util:
            self._pressure = max(0.0, self._pressure - cfg.degrade_step)
        return self._plan

    def window_params(self, now: Optional[float] = None
                      ) -> Tuple[float, int]:
        """(max_delay_s, max_batch) to serve the next window with;
        replans at most every ``control_period_s``."""
        now = time.perf_counter() if now is None else now
        if (self._plan is None
                or now - self._plan_at >= self.config.control_period_s):
            self.plan(now)
        return self._plan.delay_s, self._plan.max_batch

    @property
    def current_plan(self) -> Optional[WindowPlan]:
        return self._plan

    @property
    def utilization(self) -> Optional[float]:
        return self._plan.utilization if self._plan is not None else None

    # ------------------------------------------------------------------
    # degradation (the accuracy actuator)
    # ------------------------------------------------------------------
    @property
    def pressure(self) -> float:
        """Current degradation pressure in [0, 1]; the batch engine's
        planner maps it linearly onto each query's rate-vs-floor span
        (``runtime.budget.RatePlanner.plan_batch``)."""
        return self._pressure

    def escalate_pressure(self) -> float:
        """Jump pressure to 1.0 (every query straight to its budget
        floor).  Called by ``BatchWindow`` the moment the pending
        queue hits its bound: the queue filling up is a harder signal
        than any utilization estimate, and the ladder must exhaust the
        accuracy actuator *before* the availability one (shedding)."""
        self._pressure = 1.0
        return self._pressure

    def retry_after_s(self) -> Optional[float]:
        """Estimated time until the dispatcher can absorb new work: the
        current window deadline plus one full-batch service time (one
        serving cycle).  Attached to ``Backpressure`` so shed callers
        back off for a cycle instead of hot-retrying; None before the
        first plan exists."""
        if self._plan is None:
            return None
        return self._plan.delay_s + self.service_cost(
            float(self._plan.max_batch))
