"""HealthMonitor (port of ``tpu_perf/health/monitor.py``): the per-run
evaluation loop the driver feeds.

One instance per Driver (``--health``).  The driver calls:

* :meth:`maybe_rotate` once per recorded run (same cadence as its own
  logs — the event log is a third rotating family);
* :meth:`observe` for every sample that produced a row,
  :meth:`observe_drop` for every dropped run;
* :meth:`heartbeat` at every stats boundary — capture-loss judgement
  over the window's drop counters plus the exporter refresh;
* :meth:`close` at driver exit — the final partial window is judged for
  capture loss (a bounded run shorter than ``stats_every`` never reaches
  a boundary), the exporter flushed, the event log closed.

The monitor never raises into the measurement loop: a failing textfile
write is reported to stderr and retried at the next boundary, the same
never-fatal stance the ingest hook takes (driver.RotatingCsvLog).
"""

from __future__ import annotations

import sys

from tpu_perf_torch.health.detect import (
    SEVERITY_RANK, Finding, HealthConfig, PointDetector,
    capture_loss_finding,
)
from tpu_perf_torch.health.events import HealthEvent
from tpu_perf_torch.health.exporter import PointGauges, TextfileExporter
from tpu_perf_torch.metrics import bus_bandwidth_gbps, metric_op
from tpu_perf_torch.schema import timestamp_now, window_index


class _PointState:
    """Detector plus the row metadata the exporter needs."""

    def __init__(self, config: HealthConfig, iters: int, n_devices: int):
        self.detector = PointDetector(config)
        self.iters = iters
        self.n_devices = n_devices
        # severity of the standing regression (remembered from its entry
        # event while detector.regressed holds); None when not regressed
        self.regression_sev: str | None = None

    @property
    def last_severity(self) -> str:
        """The standing severity gauge: derived from the detector's
        CURRENT state, not the last event — a transient spike must not
        pin the gauge, and a cleared flatline must release it."""
        sev = "info"
        if self.detector.flatlined:
            sev = "warning"
        if self.detector.regressed and self.regression_sev is not None:
            if SEVERITY_RANK[self.regression_sev] > SEVERITY_RANK[sev]:
                sev = self.regression_sev
        return sev


class HealthMonitor:
    def __init__(
        self,
        config: HealthConfig,
        *,
        job_id: str,
        dtype: str,
        rank: int = 0,
        stats_every: int = 1000,
        event_log=None,   # RotatingCsvLog(prefix="health") or None
        textfile: str | None = None,
        err=None,
        phase_source=None,  # () -> {"compile_s": ..., ...} — the driver's
        #                     PhaseTimer.snapshot; the exporter publishes
        #                     harness-overhead gauges next to the health
        #                     gauges so dashboards can alert on e.g. a
        #                     compile-cache regression doubling compile_s
        adaptive_source=None,  # () -> the driver's cumulative adaptive
        #                     savings dict (or None while no controller
        #                     runs): runs-saved counter + last achieved
        #                     CI land next to the phase gauges
        push_source=None,  # () -> the push plane's meters; None until
        #                     that plane is ported (ROADMAP item 3b)
    ):
        self.config = config
        self.job_id = job_id
        self.dtype = dtype
        self.rank = rank
        self.stats_every = max(1, stats_every)
        self.event_log = event_log
        self.exporter = TextfileExporter(textfile) if textfile else None
        self.phase_source = phase_source
        self.adaptive_source = adaptive_source
        self.push_source = push_source
        self.err = err if err is not None else sys.stderr
        self._points: dict[tuple[str, int], _PointState] = {}
        # heartbeat-window counters, cleared at each boundary
        self._window_seen: dict[str, int] = {}
        self._window_dropped: dict[str, int] = {}
        # last COMPLETED window's drop rates (the exporter gauge)
        self._drop_rates: dict[str, float] = {}
        self.events_total: dict[str, int] = {}
        self._last_run_id = 0  # close() flushes the final partial window

    # -- driver-facing hooks -------------------------------------------

    def maybe_rotate(self) -> None:
        if self.event_log is not None:
            self.event_log.maybe_rotate()

    def observe(
        self,
        op: str,
        nbytes: int,
        iters: int,
        n_devices: int,
        run_id: int,
        t: float,
        span_id: str = "",
    ) -> list[HealthEvent]:
        """Fold one recorded run into its point baseline; judge it.
        ``span_id`` (the driver's enclosing run span, --spans) is
        stamped into any event this run raises."""
        st = self._points.get((op, nbytes))
        if st is None:
            st = self._points[(op, nbytes)] = _PointState(
                self.config, iters, n_devices
            )
        self._window_seen[op] = self._window_seen.get(op, 0) + 1
        self._last_run_id = max(self._last_run_id, run_id)
        findings = st.detector.observe(t)
        events = [self._emit(f, op=op, nbytes=nbytes, run_id=run_id,
                             span_id=span_id)
                  for f in findings]
        for ev in events:
            if ev.kind == "regression":
                st.regression_sev = ev.severity
        if not st.detector.regressed:
            st.regression_sev = None
        return events

    def observe_drop(self, op: str, run_id: int) -> None:
        self._window_dropped[op] = self._window_dropped.get(op, 0) + 1
        self._last_run_id = max(self._last_run_id, run_id)

    def observe_hook_fail(self, run_id: int,
                          span_id: str = "") -> list[HealthEvent]:
        """The driver's rotation ingest hook raised: surface it as a
        health event — telemetry upload failing is fleet degradation
        even when every measured sample is clean.  Stateless per
        occurrence (the hook retries next rotation; each failure is its
        own event).  ``op`` is the synthetic ``ingest_hook`` point:
        hook failures belong to the pipeline, not to any kernel."""
        self._last_run_id = max(self._last_run_id, run_id)
        f = Finding("hook_fail", "warning", 1.0, 0.0, unit="failures")
        return [self._emit(f, op="ingest_hook", nbytes=0, run_id=run_id,
                           span_id=span_id)]

    def heartbeat(self, run_id: int) -> list[HealthEvent]:
        """Stats-boundary work: capture-loss judgement over the window's
        drop counters, then the exporter refresh."""
        events = []
        window_ops = set(self._window_seen) | set(self._window_dropped)
        for op in self._drop_rates:
            # an op absent from this window had no drops in it — the
            # gauge names the LAST window, it must not pin an old rate
            if op not in window_ops:
                self._drop_rates[op] = 0.0
        for op in sorted(window_ops):
            dropped = self._window_dropped.get(op, 0)
            total = dropped + self._window_seen.get(op, 0)
            self._drop_rates[op] = dropped / total if total else 0.0
            finding = capture_loss_finding(dropped, total, self.config)
            if finding is not None:
                # op-level event: nbytes=0 = "all sizes of this op"
                events.append(self._emit(finding, op=op, nbytes=0,
                                         run_id=run_id))
        self._window_seen.clear()
        self._window_dropped.clear()
        self._refresh_exporter()
        return events

    def close(self) -> None:
        """Final partial window first: a bounded run shorter than
        stats_every would otherwise never judge capture loss (or export
        drop-rate gauges) at all.  heartbeat() refreshes the exporter."""
        if self._window_seen or self._window_dropped:
            self.heartbeat(self._last_run_id)
        else:
            self._refresh_exporter()
        if self.event_log is not None:
            self.event_log.close()

    # -- internals ------------------------------------------------------

    def _emit(self, f: Finding, *, op: str, nbytes: int,
              run_id: int, rank: int | None = None,
              span_id: str = "") -> HealthEvent:
        ev = HealthEvent(
            timestamp=timestamp_now(),
            job_id=self.job_id,
            rank=self.rank if rank is None else rank,
            kind=f.kind,
            severity=f.severity,
            op=op,
            nbytes=nbytes,
            dtype=self.dtype,
            run_id=run_id,
            # runs 1..stats_every share window 0 WITH the boundary
            # heartbeat that covers them (which fires at
            # run_id == stats_every), so events join back to the drop
            # counters and heartbeat line of their own window
            window=window_index(run_id, self.stats_every),
            observed=f.observed,
            baseline=f.baseline,
            unit=f.unit,
            span_id=span_id,
        )
        self.events_total[ev.kind] = self.events_total.get(ev.kind, 0) + 1
        if self.event_log is not None:
            self.event_log.write_row(ev)
        if ev.severity != "info":
            # warnings/criticals also go to stderr so a daemon without a
            # logfolder still surfaces degradation at the console
            print(
                f"[tpu-perf-torch health] {ev.severity} {ev.kind}: {ev.op}"
                f"/{ev.nbytes or '*'} run {ev.run_id} observed "
                f"{ev.observed:.6g} vs baseline {ev.baseline:.6g} {ev.unit}",
                file=self.err, flush=True,
            )
        return ev

    def snapshot(self) -> list[PointGauges]:
        """Current per-point gauges (exporter rows)."""
        rows = []
        for (op, nbytes), st in sorted(self._points.items()):
            b = st.detector.baseline
            p50, p99 = b.p50.value(), b.p99.value()
            if p50 is None or p50 <= 0:
                continue
            per_op = p50 / st.iters
            try:
                busbw = bus_bandwidth_gbps(
                    metric_op(op), nbytes, per_op, st.n_devices
                )
            except ValueError:
                busbw = 0.0  # foreign op name: no wire model, gauge 0
            rows.append(PointGauges(
                op=op, nbytes=nbytes, dtype=self.dtype, samples=b.n,
                lat_p50_us=per_op * 1e6,
                lat_p99_us=(p99 or p50) / st.iters * 1e6,
                busbw_gbps=busbw,
                severity=st.last_severity,
            ))
        return rows

    def _refresh_exporter(self) -> None:
        if self.exporter is None:
            return
        try:
            self.exporter.write(
                self.snapshot(), dict(self._drop_rates),
                dict(self.events_total),
                phases=self.phase_source() if self.phase_source else None,
                adaptive=(self.adaptive_source()
                          if self.adaptive_source else None),
                push=self.push_source() if self.push_source else None,
            )
        except OSError as e:
            # never fatal: the gauges go stale for one window, the
            # daemon keeps measuring (same stance as the ingest hook)
            print(f"[tpu-perf-torch health] textfile write failed: {e}",
                  file=self.err, flush=True)
