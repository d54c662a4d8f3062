"""Percentiles and spreads of the benchmark's readings (plain Python)."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default): rank ``q / 100 * (n - 1)`` of the
    sorted values.  Raises on an empty sequence."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = q / 100.0 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, with the quartiles of ``statistics.quantiles(values, n=4)``
    (its default "exclusive" method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
