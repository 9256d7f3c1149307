"""Structured health events (port of ``tpu_perf/health/events.py``): one
JSON line per detector verdict, in the JAX package's bytes.

Events ride the exact telemetry contract the measurement rows use — a
``RotatingCsvLog`` with the ``health-`` prefix (schema.HEALTH_PREFIX),
rotated on the same period, picked up and deleted by the same
delete-only-after-success ingest pass (``tpu-perf-torch ingest`` /
ingest.pipeline) as a third file family next to ``tcp-*`` and ``tpu-*``.
The payload is a JSON object instead of CSV because events are sparse
and self-describing — a Kusto/jq consumer should not need a column map
for a stream it sees a handful of lines a day from.

``tpu-perf-torch health <dir>`` replays event logs into the summary table
(:func:`summarize_events` / :func:`events_to_markdown`).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Iterable

from tpu_perf_torch.sweep import format_size


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One judged observation: what degraded, where, by how much.

    ``window`` is the heartbeat-window index ((run_id - 1) //
    stats_every) the event fell in — runs 1..stats_every and the
    boundary heartbeat covering them share window 0 — so events join
    back to the heartbeat lines and drop counters of the same window.
    ``rank`` attributes the event to the process that judged it (each
    rank runs its own detectors and log on a multi-host daemon — the
    degraded HOST is the answer fleet health exists to give).
    ``nbytes == 0`` marks op-level events (capture loss aggregates every
    size of an op; hook failures carry the synthetic ``ingest_hook``
    op).  ``unit`` names what ``observed``/``baseline`` measure: ``s``
    (run wall seconds) for per-sample detectors, ``drop_rate`` for
    capture loss, ``failures`` for ingest-hook failures.

    ``span_id`` names the enclosing run span when the harness tracer
    (tpu_perf_torch.spans, --spans) is on — the exact join into the
    ``spans-*.log`` family.  Serialized ONLY when non-empty, so with
    tracing off the emitted JSON is byte-identical to pre-span events
    (and pre-span logs parse: the field defaults).
    """

    timestamp: str
    job_id: str
    kind: str      # regression | recovered | spike | flatline |
    #                capture_loss | hook_fail | link_degraded
    severity: str  # info | warning | critical
    op: str
    nbytes: int
    dtype: str
    run_id: int
    window: int
    observed: float
    baseline: float
    unit: str = "s"
    rank: int = 0  # defaulted so pre-rank event logs still parse
    span_id: str = ""  # enclosing run span (--spans); "" = untraced

    def to_json(self) -> str:
        data = dataclasses.asdict(self)
        if not data["span_id"]:
            del data["span_id"]  # untraced events keep pre-span bytes
        return json.dumps(data, sort_keys=True)

    # duck-typed row interface so an event log IS a RotatingCsvLog —
    # same rotation, same ingest family mechanics as the CSV schemas
    def to_csv(self) -> str:
        return self.to_json()

    @classmethod
    def from_json(cls, line: str) -> "HealthEvent":
        data = json.loads(line)
        if not isinstance(data, dict):
            raise ValueError(f"health event line is not an object: {line!r}")
        try:
            return cls(**data)
        except TypeError as e:
            raise ValueError(f"bad health event {line!r}: {e}") from None


def read_jsonl(paths: Iterable[str], parse_line, *, err=None) -> list:
    """Parse JSONL rows from files with ``parse_line`` (which raises
    ValueError on a bad line); blank lines are skipped.  A malformed
    FINAL line is an expected live-daemon state (mid-append or a hard
    kill tears the last line) — skipped with a warning so a replay
    still renders every intact row.  A malformed line anywhere else
    raises (a corrupt log must not silently thin out).  Shared by the
    health-event replay and the chaos-ledger reader: one torn-line
    policy for every JSONL family."""
    out: list = []
    for path in paths:
        with open(path) as fh:
            lines = fh.read().splitlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(parse_line(line))
            except ValueError:
                if i != len(lines) - 1:
                    raise
                print(
                    f"tpu-perf-torch: skipping torn final line of {path}",
                    file=err if err is not None else sys.stderr,
                )
    return out


def read_events(paths: Iterable[str], *, err=None) -> list[HealthEvent]:
    """Parse JSONL events from files (see :func:`read_jsonl` for the
    torn-final-line policy)."""
    return read_jsonl(paths, HealthEvent.from_json, err=err)


@dataclasses.dataclass(frozen=True)
class EventSummary:
    """All events of one (rank, op, nbytes, dtype, kind) key, aggregated
    — per rank, so a multi-host soak names WHICH host degraded."""

    rank: int
    op: str
    nbytes: int
    dtype: str
    kind: str
    severity: str  # worst seen
    count: int
    first_run: int
    last_run: int
    last_observed: float
    last_baseline: float
    unit: str


def summarize_events(events: list[HealthEvent]) -> list[EventSummary]:
    """Group events by (rank, op, nbytes, dtype, kind); keep counts, the
    run span, the worst severity, and the latest observed-vs-baseline
    pair."""
    from tpu_perf_torch.health.detect import SEVERITY_RANK

    groups: dict[tuple, list[HealthEvent]] = {}
    for ev in events:
        groups.setdefault(
            (ev.rank, ev.op, ev.nbytes, ev.dtype, ev.kind), []
        ).append(ev)
    out = []
    for (rank, op, nbytes, dtype, kind), grp in sorted(groups.items()):
        grp = sorted(grp, key=lambda e: e.run_id)
        worst = max(grp, key=lambda e: SEVERITY_RANK.get(e.severity, -1))
        out.append(
            EventSummary(
                rank=rank, op=op, nbytes=nbytes, dtype=dtype, kind=kind,
                severity=worst.severity, count=len(grp),
                first_run=grp[0].run_id, last_run=grp[-1].run_id,
                last_observed=grp[-1].observed,
                last_baseline=grp[-1].baseline, unit=grp[-1].unit,
            )
        )
    # worst news first, then curve order
    out.sort(key=lambda s: (-SEVERITY_RANK.get(s.severity, -1), s.op,
                            s.nbytes, s.dtype, s.kind, s.rank))
    return out


def events_to_markdown(summaries: list[EventSummary]) -> str:
    lines = [
        "| severity | kind | rank | op | size | dtype | events | runs "
        "| last observed | baseline | unit |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for s in summaries:
        size = format_size(s.nbytes) if s.nbytes else "—"
        lines.append(
            f"| {s.severity} | {s.kind} | {s.rank} | {s.op} | {size} "
            f"| {s.dtype} | {s.count} | {s.first_run}-{s.last_run} "
            f"| {s.last_observed:.6g} | {s.last_baseline:.6g} | {s.unit} |"
        )
    return "\n".join(lines)


def events_to_json(events: list[HealthEvent]) -> str:
    """Raw events as a JSON array (for jq / dashboards)."""
    return json.dumps([dataclasses.asdict(e) for e in events], indent=2)
