"""Detectors over the streaming baselines (port of
``tpu_perf/health/detect.py``): the judgement layer.

Each sweep point owns one :class:`PointDetector`; every recorded run of
that point flows through :meth:`PointDetector.observe`, which returns
zero or more :class:`Finding`\\ s.  Four failure shapes are covered:

* **step regression** — the EWMA (short-term level) exceeds the long-run
  P² median by more than the relative threshold.  Stateful: one finding
  on entry, at most one critical escalation while it stands (the EWMA
  converging past twice the threshold after a warning entry), one
  ``recovered`` on exit (with hysteresis at half the threshold), never a
  finding per run — a 2x-degraded link must produce one event, not one
  per measurement.
* **spike** — an isolated outlier: a sample beyond ``spike_z`` standard
  deviations AND beyond the relative threshold whose *successor* returns
  to baseline.  Judged one sample late by construction — consecutive
  high samples are a step, the regression detector's job, so a spike is
  only confirmed when the next sample comes back down.
* **flatline** — ``flatline_run`` consecutive bit-identical samples: a
  stuck clock or wedged measurement path (real wall-clock timings never
  repeat exactly).
* **capture loss** — the per-window dropped-run rate (from
  ``Driver.dropped_runs``) exceeding ``drop_rate``; evaluated per op at
  heartbeat boundaries by the monitor, not per sample.  Unlike the
  per-sample detectors it is stateless by design: each heartbeat window
  is judged independently (one event per degraded window, no
  ``recovered``) — the windows themselves are the episode boundaries.

Thresholds are RELATIVE to each point's own baseline: per-link cost
asymmetries make a single absolute threshold meaningless across ops and
sizes (arXiv:2006.13112).
"""

from __future__ import annotations

import dataclasses

from tpu_perf_torch.health.stats import PointBaseline

#: severity ladder; order is rank (exporter encodes it numerically)
SEVERITIES = ("info", "warning", "critical")
#: the one rank map every consumer shares (monitor gauges, event summaries)
SEVERITY_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector knobs, one set per daemon (baselines stay per-point)."""

    threshold: float = 0.5    # relative step threshold: EWMA vs long-run p50
    spike_z: float = 8.0      # z-score floor for isolated outliers
    warmup: int = 30          # samples before a point is judged
    flatline_run: int = 20    # consecutive identical samples = stuck
    drop_rate: float = 0.25   # per-window capture-loss rate
    ewma_alpha: float = 0.3   # short-term level smoothing

    def __post_init__(self) -> None:
        if self.threshold <= 0:
            raise ValueError(f"threshold must be positive, got {self.threshold}")
        if self.spike_z <= 0:
            raise ValueError(f"spike_z must be positive, got {self.spike_z}")
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {self.warmup}")
        if self.flatline_run < 2:
            raise ValueError(
                f"flatline_run must be >= 2, got {self.flatline_run}"
            )
        if not 0.0 < self.drop_rate <= 1.0:
            raise ValueError(
                f"drop_rate must be in (0, 1], got {self.drop_rate}"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}"
            )


@dataclasses.dataclass(frozen=True)
class Finding:
    """One detector verdict, pre-metadata (the monitor stamps op/point/
    run context into a HealthEvent)."""

    kind: str       # regression | recovered | spike | flatline |
    #                 capture_loss | hook_fail | link_degraded
    severity: str   # one of SEVERITIES
    observed: float
    baseline: float
    unit: str = "s"


class PointDetector:
    """Baseline + alert state for one (op, nbytes, dtype) sweep point."""

    def __init__(self, config: HealthConfig) -> None:
        self.config = config
        self.baseline = PointBaseline(
            warmup=config.warmup, ewma_alpha=config.ewma_alpha
        )
        self.regressed = False
        self.flatlined = False
        #: the standing regression already reached critical (escalation
        #: is one-way per episode; reset on recovery)
        self._critical = False
        #: consecutive samples above the step threshold — a regression
        #: needs persistence (>= 2), so one outlier cannot declare a step
        #: even though it yanks the EWMA over the line for a few runs
        self._elev_run = 0
        #: (observed, mean, median) of a candidate spike awaiting its
        #: successor's verdict
        self._pending_spike: tuple[float, float, float] | None = None

    def observe(self, x: float) -> list[Finding]:
        cfg, b = self.config, self.baseline
        # snapshot BEFORE the update so a single outlier is judged
        # against a baseline it has not yet inflated
        mean, std = b.welford.mean, b.welford.std()
        med = b.p50.value()
        judge = b.ready
        # during an active regression the long-run estimators are frozen:
        # a sustained step would otherwise drift the median up to the
        # degraded level and fire a false recovery while the link is
        # still slow — the clean baseline must stay the reference until
        # the point genuinely recovers
        b.update(x, longrun=not self.regressed)
        if not judge or med is None or med <= 0:
            self._pending_spike = None
            return []
        findings: list[Finding] = []

        # flatline: transition-edged — one event on entry, one recovered
        # on exit, so the standing-severity gauge and event consumers
        # both learn when the value moves again
        if not self.flatlined and b.flat_run >= cfg.flatline_run:
            self.flatlined = True
            findings.append(Finding("flatline", "warning", x, med))
        elif self.flatlined and b.flat_run == 1:
            self.flatlined = False
            findings.append(Finding("recovered", "info", x, med))

        # step regression: smoothed short-term level vs long-run median,
        # transition-edged with hysteresis at threshold/2.  Entry needs
        # BOTH the EWMA over the line and two consecutive elevated
        # samples — persistence separates a step from one spike, and the
        # extra sample lets the EWMA converge toward the new level so
        # the severity reflects the step's true size
        if x > med * (1.0 + cfg.threshold):
            self._elev_run += 1
        else:
            self._elev_run = 0
        ewma = b.ewma.value
        rel = ewma / med - 1.0
        if not self.regressed and rel > cfg.threshold and self._elev_run >= 2:
            self.regressed = True
            self._pending_spike = None  # the step supersedes any candidate
            self._critical = rel > 2.0 * cfg.threshold
            sev = "critical" if self._critical else "warning"
            findings.append(Finding("regression", sev, ewma, med))
        elif self.regressed:
            if not self._critical and rel > 2.0 * cfg.threshold:
                # at entry the EWMA has only partly converged toward the
                # step, so a large step can enter as warning; escalate
                # ONCE when the converged level crosses the critical bar
                # — the standing gauge and pager must see the true size
                self._critical = True
                findings.append(Finding("regression", "critical", ewma, med))
            if rel < cfg.threshold / 2.0:
                self.regressed = False
                self._critical = False
                findings.append(Finding("recovered", "info", ewma, med))

        # spike: confirm the previous candidate only if THIS sample is
        # back at baseline (two high samples in a row are a step)
        if self._pending_spike is not None:
            px, pmean, pmed = self._pending_spike
            self._pending_spike = None
            if not self.regressed and x <= pmed * (1.0 + cfg.threshold):
                findings.append(Finding("spike", "warning", px, pmean))
        if (
            not self.regressed
            and std > 0.0
            and x > med * (1.0 + cfg.threshold)
            and (x - mean) / std > cfg.spike_z
        ):
            self._pending_spike = (x, mean, med)
        return findings


def capture_loss_finding(
    dropped: int, total: int, config: HealthConfig
) -> Finding | None:
    """Judge one op's heartbeat-window drop rate; None below threshold."""
    if total <= 0:
        return None
    rate = dropped / total
    if rate <= config.drop_rate:
        return None
    # >=, not >: with drop_rate >= 0.5 the doubled bar saturates at 1.0
    # and total capture loss (rate == 1.0) must still reach critical
    sev = "critical" if rate >= min(1.0, 2.0 * config.drop_rate) else "warning"
    return Finding("capture_loss", sev, rate, config.drop_rate,
                   unit="drop_rate")
