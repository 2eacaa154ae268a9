"""What the end-to-end metrics reduce a window to: a tail is over all
requests, a failed one counting as the slowest (rates are taken by the
traffic kinds over all the work and all the time of their window)."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
