"""Cluster sampling + estimators (paper Sec. II-B, III-A).

The estimator is Hansen-Hurwitz / pps-with-replacement (paper Eq 1):

    tau_hat = (1/n) sum_{s in S} tau_s / phi_s

with the variance estimate and t-based confidence interval of Eq 2.
``phi_s`` comes either from similarity (EmApprox: Eq 11 softmax over
exp(q . s)) or is uniform (SRCS baseline).  The math is identical for
both — only the probability vector changes, which is exactly the paper's
framing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.utils.stats import t_critical_value


class SampleResult(NamedTuple):
    shard_ids: np.ndarray        # int64 [n] sampled shard ids (with replacement)
    probabilities: np.ndarray    # float64 [n_shards] the phi vector used
    rate: float                  # nominal sampling rate


def similarity_probabilities(
    similarities: np.ndarray,
    floor: float = 1e-6,
) -> np.ndarray:
    """Paper Eq 11: phi_s = sim_s / sum(sim).  A small floor keeps every
    shard selectable so the HT estimator stays unbiased (phi_s > 0)."""
    s = np.asarray(similarities, np.float64)
    s = np.maximum(s, 0.0) + floor
    return s / s.sum()


def pps_sample(
    probabilities: np.ndarray,
    rate: float,
    rng: np.random.Generator,
) -> SampleResult:
    """Probability-proportional-to-size sampling with replacement.

    ``rate`` maps to a sample size n = ceil(rate * n_shards), matching
    the paper's 'block sampling rate'."""
    p = np.asarray(probabilities, np.float64)
    p = p / p.sum()
    n_shards = p.shape[0]
    n = max(1, int(np.ceil(rate * n_shards)))
    ids = rng.choice(n_shards, size=n, replace=True, p=p)
    return SampleResult(ids.astype(np.int64), p, rate)


def pps_sample_distinct(
    probabilities: np.ndarray,
    rate: float,
    rng: np.random.Generator,
) -> SampleResult:
    """Probability-proportional-to-size sampling *without* replacement
    (Efraimidis-Spirakis exponential keys: take the n smallest
    ``-log(u)/phi``).

    Retrieval queries (Boolean / ranked top-k) union documents over the
    sampled shards — they never form a Hansen-Hurwitz estimate — so a
    with-replacement multiset only wastes read budget on duplicate
    draws: at rate 0.6 on a skewed phi a with-replacement sample can
    physically touch under a third of the shards.  Drawing ``n =
    ceil(rate * n_shards)`` *distinct* shards makes the realized data
    fraction match the nominal rate while still concentrating reads on
    similar shards.  Aggregation queries keep ``pps_sample`` (Eq 1
    needs the with-replacement multiset)."""
    p = np.asarray(probabilities, np.float64)
    p = p / p.sum()
    n_shards = p.shape[0]
    n = min(n_shards, max(1, int(np.ceil(rate * n_shards))))
    u = rng.random(n_shards)
    with np.errstate(divide="ignore"):
        keys = -np.log(u) / np.maximum(p, 1e-300)
    ids = np.sort(np.argpartition(keys, n - 1)[:n])
    return SampleResult(ids.astype(np.int64), p, rate)


def srcs_sample(
    n_shards: int,
    rate: float,
    rng: np.random.Generator,
) -> SampleResult:
    """Simple random cluster sampling (the paper's baseline)."""
    p = np.full(n_shards, 1.0 / n_shards, np.float64)
    n = max(1, int(np.ceil(rate * n_shards)))
    ids = rng.choice(n_shards, size=n, replace=True, p=p)
    return SampleResult(ids.astype(np.int64), p, rate)


class Estimate(NamedTuple):
    value: float          # tau_hat
    error_bound: float    # epsilon at the requested confidence
    confidence: float
    n: int                # sample size

    @property
    def relative_error(self) -> float:
        """``error_bound / |value|``, degenerate-safe.

        Serving plans rates from realized relative errors, so the
        degenerate corners an online planner actually hits must come
        back as orderable floats, never raise or go NaN: a single
        sampled shard carries an infinite bound (df=0 — no variance
        estimate exists); a zero-valued estimate has no scale, so any
        positive bound is unbounded error while a zero-width bound
        around zero (an exact zero, e.g. a census that found nothing)
        is exactly 0.0."""
        if math.isnan(self.error_bound) or math.isinf(self.error_bound):
            return float("inf")
        if self.value == 0.0 or not math.isfinite(self.value):
            return 0.0 if self.error_bound == 0.0 else float("inf")
        return abs(self.error_bound) / abs(self.value)

    @property
    def interval(self) -> Tuple[float, float]:
        """``(value - eps, value + eps)``, always well-ordered: an
        infinite bound yields ``(-inf, inf)`` (covers everything)
        instead of the NaN endpoints naive arithmetic produces when
        the value itself is non-finite."""
        if not math.isfinite(self.error_bound):
            return (float("-inf"), float("inf"))
        return (self.value - self.error_bound, self.value + self.error_bound)

    def covers(self, truth: float) -> bool:
        """Does the interval contain ``truth``?  (The smoke gate's
        ground-truth coverage check for count queries.)"""
        lo, hi = self.interval
        return lo <= truth <= hi


def ht_estimate(
    local_values: np.ndarray,
    sample: SampleResult,
    confidence: float = 0.95,
) -> Estimate:
    """Paper Eq 1 & 2 over per-shard local results ``tau_s``.

    ``local_values[i]`` is the exact local quantity computed on sampled
    shard ``sample.shard_ids[i]`` (duplicates allowed — with-replacement
    draws each count once, per Hansen-Hurwitz)."""
    tau = np.asarray(local_values, np.float64)
    phi = sample.probabilities[sample.shard_ids]
    n = tau.shape[0]
    scaled = tau / phi                      # tau_s / phi_s
    tau_hat = scaled.mean() / 1.0
    # Eq 1 has (1/n) sum, i.e. the mean of scaled values.  The interval
    # is degenerate-safe for the tiny samples degraded serving actually
    # draws: with-replacement draws that all land on ONE shard carry no
    # variance information (the naive formula returns a zero-width CI
    # around that shard's scaled value — confidently wrong), so the
    # bound goes infinite; and the t quantile uses the *distinct* draw
    # count as its effective replication — duplicate draws of a hot
    # shard are not independent evidence, and the naive n-1 df lets a
    # near-collapsed sample report a far tighter interval than its
    # information content supports.
    n_distinct = len(np.unique(sample.shard_ids)) if n else 0
    if n > 1 and n_distinct > 1:
        var_hat = np.sum((scaled - tau_hat) ** 2) / (n * (n - 1))
        eps = t_critical_value(n_distinct - 1, confidence) * np.sqrt(var_hat)
    else:
        eps = float("inf")
    return Estimate(float(tau_hat), float(eps), confidence, n)


def mean_estimate(
    local_sums: np.ndarray,
    local_counts: np.ndarray,
    sample: SampleResult,
    confidence: float = 0.95,
) -> Estimate:
    """Ratio estimator for averages (the paper's second provided reduce
    function): estimate sum and count jointly, report sum/count with a
    linearized (Taylor) variance."""
    sums = np.asarray(local_sums, np.float64)
    counts = np.asarray(local_counts, np.float64)
    phi = sample.probabilities[sample.shard_ids]
    n = sums.shape[0]
    s_hat = (sums / phi).mean()
    c_hat = (counts / phi).mean()
    if c_hat == 0:
        return Estimate(0.0, float("inf"), confidence, n)
    r = s_hat / c_hat
    # same degenerate-sample guard as ht_estimate: one distinct shard
    # carries no variance information, and duplicate draws are not
    # independent evidence for the t quantile
    n_distinct = len(np.unique(sample.shard_ids)) if n else 0
    if n > 1 and n_distinct > 1:
        resid = (sums - r * counts) / phi
        var = np.sum((resid - resid.mean()) ** 2) / (n * (n - 1)) / (c_hat ** 2)
        eps = t_critical_value(n_distinct - 1, confidence) * np.sqrt(max(var, 0.0))
    else:
        eps = float("inf")
    return Estimate(float(r), float(eps), confidence, n)


def unique_shards(sample: SampleResult) -> np.ndarray:
    """Distinct shards to physically read (I/O dedup; estimator still
    uses the with-replacement multiset)."""
    return np.unique(sample.shard_ids)


def bootstrap_estimate(
    local_values: np.ndarray,
    sample: SampleResult,
    confidence: float = 0.95,
    n_boot: int = 64,
    rng: Optional[np.random.Generator] = None,
) -> Estimate:
    """Percentile-bootstrap CI over *sampled shard partials*.

    Where no closed-form variance exists (Boolean result sizes, union
    cardinalities) we resample the per-shard scaled partials
    ``tau_s/phi_s`` with replacement — never the documents, so the cost
    is O(n_boot * n_sampled_shards), trivial next to the scan itself.
    The point estimate is the same Hansen-Hurwitz mean as
    ``ht_estimate``; only the interval differs."""
    tau = np.asarray(local_values, np.float64)
    phi = sample.probabilities[sample.shard_ids]
    n = tau.shape[0]
    scaled = tau / np.maximum(phi, 1e-300)
    point = float(scaled.mean()) if n else 0.0
    if n < 2:
        return Estimate(point, float("inf"), confidence, n)
    if rng is None:
        rng = np.random.default_rng(0)
    idx = rng.integers(0, n, size=(n_boot, n))
    reps = scaled[idx].mean(axis=1)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(reps, [alpha, 1.0 - alpha])
    eps = max(point - float(lo), float(hi) - point, 0.0)
    return Estimate(point, float(eps), confidence, n)


def bootstrap_topk_stability(
    parts: Sequence[Tuple[np.ndarray, np.ndarray]],
    k: int,
    confidence: float = 0.95,
    n_boot: int = 48,
    rng: Optional[np.random.Generator] = None,
) -> Estimate:
    """Stability score for a sampled top-k: mean overlap fraction between
    the full-sample top-k and top-k lists recomputed on bootstrap
    resamples of the sampled shards.

    ``parts`` holds one ``(doc_ids, scores)`` pair per sampled shard.
    A value of 1.0 means the ranking is insensitive to which of the
    sampled shards contributed (every resample reproduces the same
    top-k); low values flag rankings that a slightly different sample
    would have changed.  Reported as an ``Estimate`` so ranked results
    carry the same ``(value, ci)`` shape as counts."""
    n = len(parts)
    if n == 0 or k <= 0:
        return Estimate(0.0, float("inf"), confidence, n)

    def _topk(pairs) -> np.ndarray:
        ids = np.concatenate([p[0] for p in pairs])
        sc = np.concatenate([p[1] for p in pairs])
        order = np.argsort(-sc, kind="stable")
        uniq, first = np.unique(ids[order], return_index=True)
        return uniq[np.argsort(first, kind="stable")[:k]]

    ref = _topk(parts)
    if ref.size == 0:
        return Estimate(0.0, float("inf"), confidence, n)
    if n < 2:
        return Estimate(1.0, float("inf"), confidence, n)
    if rng is None:
        rng = np.random.default_rng(0)
    ref_set = set(ref.tolist())
    overlaps = np.empty(n_boot, np.float64)
    for b in range(n_boot):
        pick = rng.integers(0, n, size=n)
        top = _topk([parts[i] for i in pick])
        hit = sum(1 for d in top.tolist() if d in ref_set)
        overlaps[b] = hit / float(ref.size)
    value = float(overlaps.mean())
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(overlaps, [alpha, 1.0 - alpha])
    eps = max(value - float(lo), float(hi) - value, 0.0)
    return Estimate(value, float(eps), confidence, n)
