"""Streaming per-point estimators (port of ``tpu_perf/health/stats.py``).

:class:`Welford` is the numerically stable running mean and variance
(Welford 1962): O(1) state, no samples kept.  The adaptive stop rule
(:mod:`tpu_perf_torch.adaptive`) takes its moments from it.  The EWMA, P²
quantile and point baseline of the JAX module come with the health
detectors (ROADMAP).
"""

from __future__ import annotations

import math


class Welford:
    """Running mean and variance without sample retention."""

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def push(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self._m2 += delta * (x - self.mean)

    def variance(self) -> float:
        """Sample variance (n-1 denominator); 0 before two samples."""
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    def std(self) -> float:
        return math.sqrt(self.variance())
