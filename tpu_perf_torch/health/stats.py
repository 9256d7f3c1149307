"""Streaming per-point estimators (port of ``tpu_perf/health/stats.py``):
the rolling baseline with no sample retention.

The monitoring daemon visits each (op, nbytes, dtype) sweep point forever
(driver._run_daemon round-robin), so per-point state must be O(1) in the
number of runs — a week-long soak cannot keep its samples.  Three
estimator families cover what the detectors need:

* :class:`Welford` — numerically stable running mean/variance (Welford
  1962), the z-score denominator for spike detection and the adaptive
  stop rule's moments (:mod:`tpu_perf_torch.adaptive`);
* :class:`EWMA` — exponentially weighted moving average, the short-term
  level a step regression moves;
* :class:`P2Quantile` — the P² streaming quantile (Jain & Chlamtac 1985,
  CACM): five markers tracking an arbitrary quantile with parabolic
  interpolation, no histogram, no samples.  The long-run p50 is the
  baseline a regressed EWMA is judged against; the p99 feeds the
  exporter's tail gauge.

:class:`PointBaseline` bundles one of each per sweep point with warm-up
gating — a point is never judged before ``warmup`` samples have shaped
its baseline (imbalanced arrival patterns make early windows noisy,
arXiv:1804.05349; per-link asymmetries make one global threshold
meaningless across points, arXiv:2006.13112 — hence a baseline PER
point, not per fleet).
"""

from __future__ import annotations

import math

from tpu_perf_torch.metrics import percentile


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


class EWMA:
    """Exponentially weighted moving average; seeded by the first sample."""

    def __init__(self, alpha: float = 0.3) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value: float | None = None

    def push(self, x: float) -> None:
        if self.value is None:
            self.value = x
        else:
            self.value = self.alpha * x + (1.0 - self.alpha) * self.value


class P2Quantile:
    """P²-algorithm streaming quantile estimator (Jain & Chlamtac 1985).

    Five markers (min, q/2, q, (1+q)/2, max) track the target quantile
    ``q`` in (0, 1); each sample adjusts marker heights by piecewise-
    parabolic interpolation.  Before five samples the exact small-sample
    percentile is returned.
    """

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.count = 0
        self._init: list[float] = []   # first five samples, then retired
        self._h: list[float] | None = None  # marker heights
        self._n: list[float] = []      # marker positions
        self._np: list[float] = []     # desired positions
        self._dn = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def push(self, x: float) -> None:
        self.count += 1
        if self._h is None:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self._h = list(self._init)
                self._n = [0.0, 1.0, 2.0, 3.0, 4.0]
                q = self.q
                self._np = [0.0, 2.0 * q, 4.0 * q, 2.0 + 2.0 * q, 4.0]
                self._init = []
            return
        h, n = self._h, self._n
        if x < h[0]:
            h[0] = x
            k = 0
        elif x < h[1]:
            k = 0
        elif x < h[2]:
            k = 1
        elif x < h[3]:
            k = 2
        elif x <= h[4]:
            k = 3
        else:
            h[4] = x
            k = 3
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                d = 1.0 if d >= 0.0 else -1.0
                hp = self._parabolic(i, d)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    h[i] = self._linear(i, d)
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float | None:
        """Current quantile estimate; None before the first sample."""
        if self._h is not None:
            return self._h[2]
        if not self._init:
            return None
        return percentile(self._init, self.q * 100.0)


class PointBaseline:
    """The rolling baseline one (op, nbytes, dtype) sweep point owns.

    ``update`` is O(1); ``ready`` gates every judgement on the warm-up
    sample count (an unshaped baseline would alert on its own start-up
    transient).  ``flat_run`` is the length of the current run of
    bit-identical samples (1 after any fresh value, 0 before the first
    sample) — wall-clock timings never repeat exactly, so a long run of
    them means a stuck clock or a wedged measurement path, not a fast one.
    """

    def __init__(self, *, warmup: int = 30, ewma_alpha: float = 0.3) -> None:
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.warmup = warmup
        self.welford = Welford()
        self.ewma = EWMA(ewma_alpha)
        self.p50 = P2Quantile(0.5)
        self.p99 = P2Quantile(0.99)
        self.flat_run = 0
        self._last: float | None = None

    def update(self, x: float, *, longrun: bool = True) -> None:
        """Fold one sample.  ``longrun=False`` freezes the long-run
        estimators (Welford, p50, p99) and folds only the EWMA and the
        flatline run — the detector uses it during an active regression,
        where folding degraded samples would drift the median up to the
        degraded level and fire a false recovery."""
        if longrun:
            self.welford.push(x)
            self.p50.push(x)
            self.p99.push(x)
        self.ewma.push(x)
        if self._last is not None and x == self._last:
            self.flat_run += 1
        else:
            self.flat_run = 1
        self._last = x

    @property
    def n(self) -> int:
        return self.welford.n

    @property
    def ready(self) -> bool:
        """True once the warm-up window has shaped the baseline."""
        return self.n >= self.warmup
