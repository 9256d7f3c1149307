"""Adaptive sampling: variance-targeted early stopping (port of
``tpu_perf/adaptive.py``).

The reference burns a fixed ``-i iters x -r runs`` budget at every message
size (mpi_perf.c:474-569).  With ``--ci-rel`` a finite sweep stops each
point instead once its estimate is good enough:

* :class:`PointController` keeps taking runs until the relative
  half-width of a Student-t confidence interval on the running mean (or,
  with ``--ci-statistic p50``, of the order-statistic interval on the
  median) falls under ``ci_rel``, bounded by ``min_runs`` / ``max_runs``.
  The moments come from :class:`~tpu_perf_torch.health.stats.Welford`.
* **Lockstep stop votes.**  In a multi-process world every rank must take
  the same number of runs, or a collective waits for ever.  Each round
  every rank computes its own verdict and the ranks all-reduce the votes
  (their minimum, one ``torch.distributed`` call after the run's fence,
  outside its window): the point stops only when every rank would stop.
  The sim world has one process and no vote.
* :func:`hbm_depth_cap` and :class:`PrecompileTuner` size the compile
  pipeline's look-ahead (``--precompile auto``): the cap from the card's
  free memory (``torch.cuda.mem_get_info``), the depth from the measured
  compile / measure phase ratio.

The CI is computed on per-run wall times; latency and bandwidth are
monotone transforms of them, so a 5% half-width on time is, to first
order, 5% on lat_us and busbw.  The row's ``ci_rel`` column records the
achieved value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

from tpu_perf_torch.health.stats import Welford

#: two-sided Student-t critical values by confidence level; keys are the
#: degrees of freedom the table pins (between pinned rows the next LOWER
#: df's larger value is used — a conservative, slightly wider interval).
_T_TABLE: dict[float, dict[int, float]] = {
    0.90: {
        1: 6.314, 2: 2.920, 3: 2.353, 4: 2.132, 5: 2.015, 6: 1.943,
        7: 1.895, 8: 1.860, 9: 1.833, 10: 1.812, 11: 1.796, 12: 1.782,
        13: 1.771, 14: 1.761, 15: 1.753, 16: 1.746, 17: 1.740, 18: 1.734,
        19: 1.729, 20: 1.725, 21: 1.721, 22: 1.717, 23: 1.714, 24: 1.711,
        25: 1.708, 26: 1.706, 27: 1.703, 28: 1.701, 29: 1.699, 30: 1.697,
        40: 1.684, 60: 1.671, 120: 1.658,
    },
    0.95: {
        1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131, 16: 2.120, 17: 2.110, 18: 2.101,
        19: 2.093, 20: 2.086, 21: 2.080, 22: 2.074, 23: 2.069, 24: 2.064,
        25: 2.060, 26: 2.056, 27: 2.052, 28: 2.048, 29: 2.045, 30: 2.042,
        40: 2.021, 60: 2.000, 120: 1.980,
    },
    0.99: {
        1: 63.657, 2: 9.925, 3: 5.841, 4: 4.604, 5: 4.032, 6: 3.707,
        7: 3.499, 8: 3.355, 9: 3.250, 10: 3.169, 11: 3.106, 12: 3.055,
        13: 3.012, 14: 2.977, 15: 2.947, 16: 2.921, 17: 2.898, 18: 2.878,
        19: 2.861, 20: 2.845, 21: 2.831, 22: 2.819, 23: 2.807, 24: 2.797,
        25: 2.787, 26: 2.779, 27: 2.771, 28: 2.763, 29: 2.756, 30: 2.750,
        40: 2.704, 60: 2.660, 120: 2.617,
    },
}
#: the z fallback past the table's last pinned df
_Z_LIMIT = {0.90: 1.645, 0.95: 1.960, 0.99: 2.576}

#: confidence levels the t table carries (validated by AdaptiveConfig)
SUPPORTED_CONFIDENCES = tuple(sorted(_T_TABLE))


def t_critical(df: int, confidence: float = 0.95) -> float:
    """Two-sided Student-t critical value for ``df`` degrees of freedom.

    Exact at the pinned rows; between pins the next LOWER df's value is
    returned (larger t ⇒ wider interval ⇒ a conservative stop rule);
    past df 120 the normal limit.  Hard-coded table: the container
    carries no scipy, and three confidence levels cover every harness
    use."""
    if df < 1:
        raise ValueError(f"degrees of freedom must be >= 1, got {df}")
    table = _T_TABLE.get(confidence)
    if table is None:
        raise ValueError(
            f"confidence must be one of {SUPPORTED_CONFIDENCES}, "
            f"got {confidence}"
        )
    if df in table:
        return table[df]
    pinned = [d for d in table if d <= df]
    if not pinned:
        return table[1]
    if df > max(table):
        return _Z_LIMIT[confidence]
    return table[max(pinned)]


#: statistics the stop rule can target: ``mean`` is the t-based CI on
#: the running mean (Welford moments, no retention); ``p50`` targets
#: the MEDIAN via the distribution-free order-statistic interval —
#: the headline tables publish p50, so stopping on the mean's CI under
#: a heavy tail can stop too late (the tail inflates s) or declare a
#: converged mean while the median is still wandering.
SUPPORTED_STATISTICS = ("mean", "p50")


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """The early-stop policy for one job (every point shares it).

    ``ci_rel`` is the target relative half-width: stop once
    ``t * s / (sqrt(n) * mean) <= ci_rel`` — at ``confidence``, the true
    mean lies within ±ci_rel of the estimate.  ``min_runs`` recorded
    samples must shape the estimate before it is trusted (the t interval
    is meaningless at n=2 with a lucky pair); ``max_runs`` bounds the
    budget so a heavy-tailed point cannot run forever.  ``statistic``
    switches the CI target to the median (``p50``): the nonparametric
    binomial interval on order statistics, requiring per-point sample
    retention (bounded by max_runs — tiny) instead of streaming
    moments."""

    ci_rel: float = 0.05
    confidence: float = 0.95
    min_runs: int = 5
    max_runs: int = 50
    statistic: str = "mean"

    def __post_init__(self) -> None:
        if not 0.0 < self.ci_rel < 1.0:
            raise ValueError(
                f"ci_rel must be in (0, 1), got {self.ci_rel}"
            )
        if self.statistic not in SUPPORTED_STATISTICS:
            raise ValueError(
                f"statistic must be one of {SUPPORTED_STATISTICS}, "
                f"got {self.statistic!r}"
            )
        if self.confidence not in _T_TABLE:
            raise ValueError(
                f"confidence must be one of {SUPPORTED_CONFIDENCES}, "
                f"got {self.confidence}"
            )
        if self.min_runs < 2:
            raise ValueError(
                f"min_runs must be >= 2 (a variance needs two samples), "
                f"got {self.min_runs}"
            )
        if self.max_runs < self.min_runs:
            raise ValueError(
                f"max_runs ({self.max_runs}) must be >= min_runs "
                f"({self.min_runs})"
            )


class PointController:
    """One sweep point's stop rule: observe every run, vote every round.

    The caller loop is::

        while True:
            runs += 1
            t = measure()
            controller.observe(t)        # None = dropped sample
            record(t)
            if controller.should_stop(runs):
                break

    ``should_stop`` is a collective in a multi-process world: every rank
    calls it after every run, in the same order relative to any other
    collective.  The vote is unanimous-stop (the all-reduced minimum of
    the ranks' verdicts), so the slowest rank to converge sets the shared
    run count and no rank ever stops alone.  ``vote`` injects the
    aggregation (tests, simulated rank sets); with ``n_hosts`` above one
    and no ``vote``, the votes are all-reduced over ``group`` (None: the
    default group) on the world's wire device.
    """

    def __init__(
        self,
        config: AdaptiveConfig,
        *,
        n_hosts: int = 1,
        vote: Callable[[bool], bool] | None = None,
        group=None,
    ):
        self.config = config
        self.n_hosts = max(1, n_hosts)
        self._vote = vote
        self._group = group
        self.welford = Welford()
        self.taken = 0     # recorded samples (fed to the moments)
        self.dropped = 0   # runs lost to noise
        self.stopped_at: int | None = None  # runs executed when stopped
        #: retained samples for the p50 statistic (bounded by max_runs);
        #: None under the streaming mean
        self._samples: list[float] | None = (
            [] if config.statistic == "p50" else None
        )

    @property
    def requested(self) -> int:
        """The budget a fixed-schedule run would burn (the row column)."""
        return self.config.max_runs

    def _push(self, t: float) -> None:
        self.welford.push(t)
        if self._samples is not None:
            self._samples.append(t)

    def observe(self, t: float | None) -> None:
        """Fold one run's sample; ``None`` is a dropped run (it consumes
        budget, since every rank executed it, but shapes no moment)."""
        if t is None:
            self.dropped += 1
        else:
            self.taken += 1
            self._push(t)

    def observe_chunk(self, mean: float | None, reps: int) -> None:
        """Fold one fused chunk (``--fence fused``): the chunk's mean is ONE
        observation, since the runs of one captured chunk are not
        independent samples; the between-chunk variance of chunk means is
        the honest estimator of the overall mean's CI.  The ``reps`` runs
        still count toward the budget (``taken`` stays in runs, so
        min_runs / max_runs keep their meaning)."""
        if reps <= 0:
            raise ValueError(f"reps must be positive, got {reps}")
        if mean is None:
            self.dropped += reps
        else:
            self.taken += reps
            self._push(mean)

    def ci_rel(self) -> float:
        """Current relative CI half-width; ``inf`` while it cannot be
        computed (fewer than two samples, or a non-positive center)."""
        if self._samples is not None:
            return self._ci_rel_median()
        w = self.welford
        if w.n < 2 or w.mean <= 0.0:
            return math.inf
        half = (t_critical(w.n - 1, self.config.confidence) * w.std()
                / math.sqrt(w.n))
        return half / w.mean

    def _ci_rel_median(self) -> float:
        """The p50 statistic's interval: the distribution-free order-
        statistic CI on the median (the binomial / sign construction,
        normal-approximated): ranks ``n/2 +- z*sqrt(n)/2`` bracket the true
        median at the configured confidence.  ``inf`` until the bracket
        fits inside the sample (about 9 samples at 95%)."""
        s = sorted(self._samples)
        n = len(s)
        if n < 2:
            return math.inf
        med = (s[(n - 1) // 2] + s[n // 2]) / 2.0
        if med <= 0.0:
            return math.inf
        half_span = _Z_LIMIT[self.config.confidence] * math.sqrt(n) / 2.0
        lo = math.floor((n - 1) / 2.0 - half_span)
        hi = math.ceil((n - 1) / 2.0 + half_span)
        if lo < 0 or hi > n - 1:
            return math.inf
        return (s[hi] - s[lo]) / (2.0 * med)

    def _local_stop(self, runs_done: int) -> bool:
        if runs_done >= self.config.max_runs:
            return True  # budget bound: identical on every rank
        if self.taken < self.config.min_runs:
            return False
        return self.ci_rel() <= self.config.ci_rel

    def should_stop(self, runs_done: int, *, tracer=None) -> bool:
        """The lockstep decision for this round; in a multi-process world
        EVERY rank calls it after every run, and it may enter a
        collective.  Before ``min_runs`` no rank can stop (taken <=
        runs_done < min_runs), and ``runs_done`` is the same on every
        rank, so those rounds skip the vote on every rank alike.
        ``tracer`` (spans.SpanTracer) records each vote that is taken (a
        collective, or the injected test vote) as a ``stop_vote`` span
        around the exchange alone."""
        if runs_done < self.config.min_runs:
            return False
        local = self._local_stop(runs_done)
        voting = self._vote is not None or self.n_hosts > 1
        ctx = (tracer.span("stop_vote", run_id=runs_done, local=local)
               if tracer is not None and voting
               else contextlib.nullcontext())
        with ctx:  # a vote that raises still closes, and marks, the span
            if self._vote is not None:
                stop = self._vote(local)
            elif self.n_hosts > 1:
                stop = vote_all(local, self._group)
            else:
                stop = local
        if stop and self.stopped_at is None:
            self.stopped_at = runs_done
        return stop

    def summary(self) -> dict:
        """The point's savings record (bench payload, driver totals)."""
        attempted = self.stopped_at if self.stopped_at is not None \
            else self.taken + self.dropped
        ci = self.ci_rel()
        return {
            "requested": self.config.max_runs,
            "attempted": attempted,
            "taken": self.taken,
            "dropped": self.dropped,
            "saved": max(0, self.config.max_runs - attempted),
            "ci_rel": None if not math.isfinite(ci) else round(ci, 6),
            "statistic": self.config.statistic,
        }


def vote_all(local: bool, group=None) -> bool:
    """Unanimous stop over the ranks of ``group``: one ``all_reduce(MIN)``
    of the ranks' votes (1 = stop) on the wire device (the card under
    NCCL, the CPU under gloo)."""
    import torch
    import torch.distributed as dist

    from tpu_perf_torch.parallel.multihost import _wire_device

    t = torch.tensor([1 if local else 0], dtype=torch.int32,
                     device=_wire_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def hbm_depth_cap(point_bytes: int, *, fraction: float = 0.5,
                  fallback: int = 8, ceiling: int = 64,
                  device=None) -> int:
    """``--precompile auto``'s look-ahead depth cap from the card's free
    memory: how many ``point_bytes``-sized points fit in ``fraction`` of
    what ``torch.cuda.mem_get_info`` reports free, clamped to ``[1,
    ceiling]``; ``fallback`` where no memory is reported (the CPU).
    ``device`` is a ``torch.device`` (None: the current card), or any
    object with a ``mem_get_info()`` returning ``(free, total)`` bytes
    (the tests inject one)."""
    if point_bytes < 0:
        raise ValueError(f"point_bytes must be >= 0, got {point_bytes}")
    try:
        if hasattr(device, "mem_get_info"):
            free, total = device.mem_get_info()
        else:
            import torch

            if device is not None and torch.device(device).type != "cuda":
                return fallback
            if not torch.cuda.is_available():
                return fallback
            free, total = torch.cuda.mem_get_info(device)
    except Exception:  # noqa: BLE001 — memory reporting is best effort;
        # the fixed fallback is always a safe answer
        return fallback
    if not total:
        return fallback
    headroom = max(0, free) * fraction
    return max(1, min(ceiling, int(headroom // max(1, point_bytes))))


class PrecompileTuner:
    """``--precompile auto``: pick the pipeline look-ahead depth from the
    measured compile/measure phase ratio.

    A background worker that spends R seconds compiling for every second
    the main thread spends measuring needs to run ~R points ahead to
    keep the consumer from ever blocking — so the depth is
    ``ceil(compile_s / measure_s)`` over the job's cumulative phase
    totals, clamped to ``[1, max_depth]`` (the resident-buffer HBM cap
    the fixed flag also respects).  The first ``min_points`` completed
    points are warm-up: their totals are dominated by the very
    first-compile burst the tuner exists to hide, and would over-steer.
    Cumulative totals also make the tuner self-correcting as adaptive
    early stopping shrinks measure time — the ratio (and the depth)
    grows to match."""

    def __init__(self, *, min_points: int = 2, max_depth: int = 8,
                 initial: int = 1):
        if initial < 1 or max_depth < 1:
            raise ValueError("depths must be >= 1")
        self.min_points = min_points
        self.max_depth = max_depth
        self.depth = initial
        self.points = 0

    def update(self, compile_s: float, measure_s: float) -> int:
        """Fold one completed point's cumulative phase totals; returns
        the depth the pipeline should use from here on.  The first
        ``min_points`` calls hold the current depth (<=, not <: point
        ``min_points`` itself still carries the first-compile burst in
        its cumulative totals and would over-steer)."""
        self.points += 1
        if self.points <= self.min_points or compile_s <= 0.0:
            return self.depth
        ratio = compile_s / max(measure_s, 1e-9)
        self.depth = max(1, min(self.max_depth, math.ceil(ratio)))
        return self.depth
