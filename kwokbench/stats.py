"""Percentiles as the metrics define them: over every sample of the
window, nearest rank, a failed sample counting as infinitely late."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``; NaN
    when there are none.  ``math.inf`` stands for a sample that failed."""
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(q * len(v)) - 1)]


def beyond(values: Sequence[float], q: float) -> int:
    """How many samples lie beyond the ``q`` quantile's rank."""
    return len(values) - max(0, math.ceil(q * len(values)))
