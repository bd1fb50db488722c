"""Statistics over all of a window's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values: the
    smallest value with at least q% of the samples at or below it."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over all of the window's time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds
