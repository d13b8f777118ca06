"""Statistics helpers: Student-t critical values without SciPy.

The paper's error bounds (Eq 2) use ``t_{n-1, 1-alpha/2}``.  SciPy is not
part of the runtime, so we implement the inverse CDF of the
t-distribution with the classic Hill (1970) expansion around the normal
quantile.  Accuracy is ~1e-6 for df >= 3 and better than 1e-3 for df in
{1, 2}, which we special-case exactly (Cauchy / closed form).

Checked against tabulated values in tests/test_stats.py.
"""
from __future__ import annotations

import math


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Max abs error ~1.15e-9 over (0, 1).
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0,1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def t_critical_value(df: int, confidence: float = 0.95) -> float:
    """Two-sided critical value ``t_{df, 1-alpha/2}`` for the given
    confidence level (paper Eq 2 uses 95%)."""
    if df <= 0:
        raise ValueError(f"df must be positive, got {df}")
    p = 1.0 - (1.0 - confidence) / 2.0  # upper-tail quantile
    if df == 1:  # Cauchy: exact
        return math.tan(math.pi * (p - 0.5))
    if df == 2:  # exact closed form
        alpha2 = 2.0 * (1.0 - p)
        return math.sqrt(2.0 / (alpha2 * (2.0 - alpha2)) - 2.0)
    # Hill's asymptotic expansion: normal quantile + Cornish-Fisher terms.
    x = _norm_ppf(p)
    g1 = (x ** 3 + x) / 4.0
    g2 = (5 * x ** 5 + 16 * x ** 3 + 3 * x) / 96.0
    g3 = (3 * x ** 7 + 19 * x ** 5 + 17 * x ** 3 - 15 * x) / 384.0
    g4 = (79 * x ** 9 + 776 * x ** 7 + 1482 * x ** 5 - 1920 * x ** 3 - 945 * x) / 92160.0
    return x + g1 / df + g2 / df ** 2 + g3 / df ** 3 + g4 / df ** 4
