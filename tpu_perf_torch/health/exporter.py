"""Prometheus textfile exporter (port of ``tpu_perf/health/exporter.py``):
the daemon's current gauges on disk.  The metric names are the JAX
package's, so one dashboard reads either package's textfile.

The node-exporter textfile-collector convention — write a ``.prom`` file
of gauge lines, atomically (write temp + rename), and let the collector
scrape it.  No HTTP server in the measurement process: the daemon's run
cadence must never depend on a scraper's socket, and the textfile path
survives daemon restarts (the last state stays visible).

Refreshed at heartbeat boundaries and once at driver shutdown, so gauge
staleness is bounded by ``stats_every`` runs.
"""

from __future__ import annotations

import dataclasses
import os

#: the shared severity ladder encodes the gauge value (0 ok, 1 warning,
#: 2 critical) — one map for every consumer, so a new level cannot skew
#: the exporter silently
from tpu_perf_torch.health.detect import SEVERITY_RANK


@dataclasses.dataclass(frozen=True)
class PointGauges:
    """One sweep point's current exporter state."""

    op: str
    nbytes: int
    dtype: str
    samples: int
    lat_p50_us: float
    lat_p99_us: float
    busbw_gbps: float
    severity: str  # info | warning | critical


def _escape(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def labels(**kv) -> str:
    """One Prometheus label block, escaped — shared by the health
    exporter and the chaos-verify conformance gauges, so every textfile
    producer renders labels identically."""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in kv.items())
    return "{" + inner + "}"


def render_textfile(
    points: list[PointGauges],
    drop_rates: dict[str, float],
    events_total: dict[str, int],
    phases: dict[str, float] | None = None,
    adaptive: dict | None = None,
    push: dict | None = None,
) -> str:
    """The full textfile contents for the current daemon state.

    ``phases`` (the driver PhaseTimer's ``{"compile_s": ...}`` snapshot)
    adds cumulative harness-overhead counters next to the health gauges
    — the dashboard alert surface for e.g. a compile-cache regression
    doubling compile_s.  ``adaptive`` (the
    driver's cumulative savings totals, the same dict the JSON heartbeat
    carries, plus ``last_ci_rel``) adds the adaptive engine's
    runs-handed-back counter and the most recent point's achieved CI —
    a collector watches the budget saved without parsing heartbeats.
    ``push`` (the push plane's meters) renders the plane's gauges
    (push.sinks.push_gauge_lines)."""
    lines = []

    def family(name: str, help_: str, kind: str = "gauge") -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")

    family("tpu_perf_health_lat_p50_us",
           "Streaming P2 median per-op latency, microseconds.")
    for p in points:
        lines.append(
            f"tpu_perf_health_lat_p50_us"
            f"{labels(op=p.op, nbytes=p.nbytes, dtype=p.dtype)}"
            f" {p.lat_p50_us:.6g}"
        )
    family("tpu_perf_health_lat_p99_us",
           "Streaming P2 p99 per-op latency, microseconds.")
    for p in points:
        lines.append(
            f"tpu_perf_health_lat_p99_us"
            f"{labels(op=p.op, nbytes=p.nbytes, dtype=p.dtype)}"
            f" {p.lat_p99_us:.6g}"
        )
    family("tpu_perf_health_busbw_gbps",
           "Bus bandwidth at the streaming median, GB/s (0 for "
           "latency-only ops).")
    for p in points:
        lines.append(
            f"tpu_perf_health_busbw_gbps"
            f"{labels(op=p.op, nbytes=p.nbytes, dtype=p.dtype)}"
            f" {p.busbw_gbps:.6g}"
        )
    family("tpu_perf_health_samples_total",
           "Recorded runs folded into this point's baseline.", "counter")
    for p in points:
        lines.append(
            f"tpu_perf_health_samples_total"
            f"{labels(op=p.op, nbytes=p.nbytes, dtype=p.dtype)}"
            f" {p.samples}"
        )
    family("tpu_perf_health_point_severity",
           "Standing severity per point (0 ok, 1 warning, 2 critical).")
    for p in points:
        lines.append(
            f"tpu_perf_health_point_severity"
            f"{labels(op=p.op, nbytes=p.nbytes, dtype=p.dtype)}"
            f" {SEVERITY_RANK.get(p.severity, 0)}"
        )
    family("tpu_perf_health_drop_rate",
           "Dropped-run rate of the last completed heartbeat window.")
    for op, rate in sorted(drop_rates.items()):
        lines.append(
            f"tpu_perf_health_drop_rate{labels(op=op)} {rate:.6g}"
        )
    family("tpu_perf_health_events_total",
           "Health events emitted since daemon start, by kind.", "counter")
    for kind, n in sorted(events_total.items()):
        lines.append(
            f"tpu_perf_health_events_total{labels(kind=kind)} {n}"
        )
    if phases:
        family("tpu_perf_harness_phase_seconds",
               "Cumulative harness self-profile: seconds of compile "
               "WORK (including the precompile worker's overlapped "
               "share), measurement, and logging since start.",
               "counter")
        for key, seconds in sorted(phases.items()):
            # snapshot keys are compile_s/measure_s/log_s; the unit
            # lives in the metric name per Prometheus convention
            name = key[:-2] if key.endswith("_s") else key
            lines.append(
                f"tpu_perf_harness_phase_seconds{labels(phase=name)}"
                f" {seconds:.6g}"
            )
    if adaptive is not None:
        family("tpu_perf_adaptive_runs_saved_total",
               "Measurement runs the adaptive early-stop engine handed "
               "back versus the fixed budget, cumulative.", "counter")
        lines.append(
            f"tpu_perf_adaptive_runs_saved_total"
            f" {int(adaptive.get('runs_saved', 0))}"
        )
        family("tpu_perf_adaptive_last_ci_rel",
               "Relative CI half-width the most recently completed "
               "point achieved at its stop.")
        lines.append(
            f"tpu_perf_adaptive_last_ci_rel"
            f" {float(adaptive.get('last_ci_rel', 0.0)):.6g}"
        )
    if push is not None:
        # the push plane's self-observation (tpu_perf_torch.push, --push):
        # one metric vocabulary shared with the plane's own live textfile
        from tpu_perf_torch.push.sinks import push_gauge_lines

        lines.extend(push_gauge_lines(push))
    return "\n".join(lines) + "\n"


def write_textfile(path: str, content: str) -> None:
    """Atomically write a Prometheus textfile (write temp + rename, so a
    scrape never reads a half-written file).  Shared by the daemon's
    gauge exporter and the chaos-verify conformance gauges — one
    textfile contract for every producer."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(content)
    os.replace(tmp, path)


class TextfileExporter:
    """Atomic writer for the rendered textfile."""

    def __init__(self, path: str) -> None:
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def write(
        self,
        points: list[PointGauges],
        drop_rates: dict[str, float],
        events_total: dict[str, int],
        phases: dict[str, float] | None = None,
        adaptive: dict | None = None,
        push: dict | None = None,
    ) -> None:
        write_textfile(
            self.path,
            render_textfile(points, drop_rates, events_total, phases,
                            adaptive, push),
        )
