"""Streaming normalization statistics and outlier removal.

Own copy of ``emotts/audio/normalize.py``.  Replaces the reference's
sklearn ``StandardScaler.partial_fit`` + IQR cleanup
(rank_model/preprocess.py:27-31,128-131) with a Welford accumulator — same
math, no sklearn dependency in the production path.
"""

from __future__ import annotations

import numpy as np


class RunningStats:
    """Welford online mean/std over batches (matches StandardScaler.partial_fit)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float64).ravel()
        if x.size == 0:
            return
        n_b = x.size
        mean_b = x.mean()
        m2_b = ((x - mean_b) ** 2).sum()
        n_new = self.n + n_b
        delta = mean_b - self.mean
        self.mean += delta * n_b / n_new
        self.m2 += m2_b + delta**2 * self.n * n_b / n_new
        self.n = n_new

    @property
    def std(self) -> float:
        # population std (ddof=0), matching sklearn's StandardScaler.scale_
        if self.n == 0:
            return 1.0
        s = np.sqrt(self.m2 / self.n)
        return float(s) if s > 0 else 1.0


def remove_outliers(x: np.ndarray) -> np.ndarray:
    """IQR-based outlier removal (reference: rank_model/preprocess.py:27-31)."""
    q1, q3 = np.percentile(x, [25, 75])
    iqr = q3 - q1
    mask = (x >= (q1 - 1.5 * iqr)) & (x <= (q3 + 1.5 * iqr))
    return x[mask]
