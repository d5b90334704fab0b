"""Arithmetic of the benchmark's numbers: quartiles and percentiles, and
device intervals merged into busy time and idle gaps."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def quartile_spread(values: Sequence[float]) -> float:
    """(third quartile − first) / median, by ``statistics.quantiles(n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile: the smallest value with at least
    p% of the values at or below it (a missing value counts as +inf)."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(int(math.ceil(p / 100.0 * len(s))), 1)
    return s[k - 1]


def merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Overlapping or touching [start, end) intervals joined, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_within(intervals, lo: float, hi: float) -> float:
    """Time in [lo, hi) covered by at least one interval."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged(intervals))


def gaps_within(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The uncovered stretches of [lo, hi)."""
    out, t = [], lo
    for a, b in merged(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
