"""Percentiles and spreads, kept with the benchmark so that no later change
to the program moves the yardstick."""

from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks, as numpy.percentile's default computes it (the program's
    soak/harvest.py reports its tails so).  An infinite value, a failed
    operation, sorts last."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: list[float]) -> float:
    """The distance between the first and the third quartile, as a share of
    the median (statistics.quantiles' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
