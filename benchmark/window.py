"""The percentile and spread arithmetic of the benchmark."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it.  A missing value
    is +inf and counts as the largest."""
    if not values:
        return math.inf
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)]


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's ``statistics.quantiles(n=4)``: the
    run-to-run spread that an end-to-end metric's bound is set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def spread_without_farthest(values: Sequence[float]) -> float:
    """``quartile_spread`` with the value farthest from the median left
    out: one far-off run in a set does no harm to a bound's tightness."""
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda x: abs(x - med)))
    return quartile_spread(rest)
