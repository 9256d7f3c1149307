"""Chrome trace-event export and cross-family span joins (port of
``tpu_perf/trace/export.py``).

The export target is the trace-event JSON object format
(``{"traceEvents": [...], "displayTimeUnit": "ms"}``) that Perfetto and
chrome://tracing load directly: one complete (``"ph": "X"``) event per
span, ``pid`` = rank, ``tid`` = track.  Tracks separate the activities
whose overlap is the whole point of the export:

====  =================  ==========================================
tid   track              spans
====  =================  ==========================================
0     main               job/sweep/point/run/measure/fence/warmup/
                         stop_vote/rotate/inject/probe_schedule/
                         heartbeat
1     precompile-worker  build spans recorded on the pipeline worker
2     ingest-hook        ingest_hook spans (recorded on the main
                         thread, tracked separately so a hook stall
                         is visually distinct from measurement)
3+    <thread>           anything from other threads
====  =================  ==========================================

Export is deterministic: events sort on ``(pid, tid, ts, span_id)``
and serialize with sorted keys and fixed separators, so a seeded run
with injected clocks produces a byte-stable artifact (the golden-file
contract tests/test_spans.py pins).
"""

from __future__ import annotations

import json
import os
from typing import Iterable

_TRACKS = {0: "main", 1: "precompile-worker", 2: "ingest-hook"}

#: span kinds that count as "harness activity" around an anomaly (the
#: report's anomaly-context table and the concurrency checks); ``push``
#: joined when the live telemetry sender became a background activity —
#: a delivery stall concurrent with a latency spike is exactly the
#: correlation this table exists to surface
ACTIVITY_KINDS = ("rotate", "ingest_hook", "build", "probe_schedule",
                  "push")


def _track_of(span: dict) -> int:
    if span.get("kind") == "ingest_hook":
        return 2
    thread = span.get("thread", "main")
    if thread == "worker":
        return 1
    if thread == "main":
        return 0
    return 3


def _name_of(span: dict) -> str:
    op = (span.get("attrs") or {}).get("op")
    return f"{span['kind']}:{op}" if op else span["kind"]


def to_chrome_trace(spans: Iterable[dict],
                    process_names: dict[int, str] | None = None) -> dict:
    """Span dicts (spans.read_span_records) → the trace-event object.

    ``process_names`` overrides the per-pid process labels (default
    ``rank N``) — the JAX package's fleet stitcher maps
    (host, job, rank) lanes onto distinct pids and labels them
    ``host/rank N`` so two hosts' rank 0 never collapse into one
    track."""
    spans = list(spans)
    events: list[dict] = []
    ranks = sorted({int(s.get("rank", 0)) for s in spans})
    tracks = sorted({(int(s.get("rank", 0)), _track_of(s)) for s in spans})
    names = process_names or {}
    for rank in ranks:
        events.append({
            "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
            "args": {"name": names.get(rank, f"rank {rank}")},
        })
    for rank, tid in tracks:
        events.append({
            "ph": "M", "name": "thread_name", "pid": rank, "tid": tid,
            "args": {"name": _TRACKS.get(tid, "other")},
        })
    body = []
    for s in spans:
        attrs = s.get("attrs") or {}
        body.append({
            "ph": "X",
            "name": _name_of(s),
            "cat": s["kind"],
            "ts": round(int(s["t_start_ns"]) / 1e3, 3),   # microseconds
            "dur": round(int(s["dur_ns"]) / 1e3, 3),
            "pid": int(s.get("rank", 0)),
            "tid": _track_of(s),
            "args": {
                "span_id": s["span_id"],
                "parent_id": s.get("parent_id"),
                "job_id": s.get("job_id"),
                **attrs,
            },
        })
    body.sort(key=lambda e: (e["pid"], e["tid"], e["ts"],
                             e["args"]["span_id"]))
    return {"traceEvents": events + body, "displayTimeUnit": "ms"}


def chrome_trace_json(spans: Iterable[dict],
                      process_names: dict[int, str] | None = None) -> str:
    """Deterministic serialization of :func:`to_chrome_trace`."""
    return json.dumps(to_chrome_trace(spans, process_names),
                      sort_keys=True, separators=(",", ":")) + "\n"


def validate_chrome_trace(data) -> list[str]:
    """Structural trace-event validation; returns problems (empty =
    valid).  The CI gate runs this over the exported artifact so a
    malformed export fails loudly instead of failing inside Perfetto."""
    problems = []
    if not isinstance(data, dict) or "traceEvents" not in data:
        return ["not a trace-event object (no traceEvents key)"]
    events = data["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents is not a non-empty list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i} has no phase")
            continue
        if ev["ph"] == "X":
            for key in ("name", "ts", "dur", "pid", "tid"):
                if key not in ev:
                    problems.append(f"event {i} missing {key}")
            for key in ("ts", "dur"):
                if not isinstance(ev.get(key), (int, float)):
                    problems.append(f"event {i} non-numeric {key}")
    if not any(e.get("ph") == "X" for e in events
               if isinstance(e, dict)):
        problems.append("no complete (X) span events")
    return problems


def write_timeline(path: str, content: str) -> None:
    """Atomic artifact write (tmp + rename): a collector or Perfetto
    upload that races the export never reads a torn JSON file — same
    contract as the Prometheus textfile and the phase sidecar."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(content)
    os.replace(tmp, path)


def _narrow(hits: list[dict], op: str | None,
            nbytes: int | None) -> list[dict]:
    """Disambiguate same-run_id hits (finite sweeps restart run_id per
    point) by the record's (op, nbytes)."""
    if op and len(hits) > 1:
        narrowed = [
            s for s in hits
            if (s.get("attrs") or {}).get("op") == op
            and (nbytes is None
                 or (s.get("attrs") or {}).get("nbytes") == nbytes)
        ]
        if narrowed:
            return narrowed
    return hits


def resolve_run_span(
    spans: Iterable[dict],
    *,
    span_id: str = "",
    rank: int | None = None,
    run_id: int | None = None,
    op: str | None = None,
    nbytes: int | None = None,
    job_id: str | None = None,
) -> list[dict]:
    """All spans a record could be enclosed by (an exact join returns
    exactly one).  A stamped ``span_id`` wins outright and matches any
    span kind (rows and chaos entries always point at run spans; a
    linkmap event points at its probe_schedule span); otherwise the
    ``(rank, run_id)`` pair resolves against run spans — run ids are
    globally unique in daemon/chaos mode, and finite sweeps (where
    run_id restarts per point) narrow by the record's (op, nbytes).
    Ledger entries carry no span column by design (their byte-identity
    contract predates — and must survive — tracing), so they always
    resolve this way.  ``rank``/``job_id`` scope the search: span IDs
    are unique per (job, rank), not across them."""
    out = []
    for s in spans:
        if rank is not None and int(s.get("rank", 0)) != rank:
            continue
        if job_id is not None and s.get("job_id") != job_id:
            continue
        if span_id:
            if s["span_id"] == span_id:
                out.append(s)
        elif (run_id is not None and s.get("kind") == "run"
              and (s.get("attrs") or {}).get("run_id") == run_id):
            out.append(s)
    return out if span_id else _narrow(out, op, nbytes)


def join_completeness(
    spans: Iterable[dict],
    *,
    rows=(),
    events=(),
    ledger=(),
    rank: int | None = None,
    job_id: str | None = None,
) -> list[str]:
    """Every record of every family must resolve to EXACTLY one
    enclosing span; returns the violations (empty = complete).

    ``rows`` are schema.ResultRow, ``events`` health.events.HealthEvent,
    ``ledger`` faults.spec.ChaosRecord (or their dicts).  Rows and
    events scope by their own ``job_id`` column (two traced jobs sharing
    a folder must not cross-match same-ID spans); ``rank`` scopes
    records whose files carry the rank (span IDs are unique per (job,
    rank), not across them) and ``job_id`` scopes the ledger, whose
    entries carry neither column.  Skipped by construction: ledger
    ``meta``/``selftest`` records and corrupt-fault records (run_id 0 —
    injected at selftest time, outside any run), and ``link_degraded``
    events without a span stamp (graded by a sweep-level pass, not a
    measured run).  An op-less ledger entry (hook_fail) that matches
    several same-run_id run spans of a finite sweep counts as resolved —
    the ambiguity is in the ledger record's shape, not the span stream.

    Records of an UNTRACED job (no spans carry its job_id — a spans-off
    run sharing the folder with a traced one) make no join claim and
    are skipped: only jobs that emitted spans are audited.

    Indexes once: O(records + spans), so auditing a week-long soak's
    folder stays linear."""
    by_id: dict[tuple, list] = {}
    by_run: dict[tuple, list] = {}
    jobs: set = set()
    ranks: set = set()
    for s in spans:
        key = (s.get("job_id"), int(s.get("rank", 0)))
        jobs.add(key[0])
        ranks.add(key[1])
        by_id.setdefault((*key, s["span_id"]), []).append(s)
        if s.get("kind") == "run":
            run_key = (*key, (s.get("attrs") or {}).get("run_id"))
            by_run.setdefault(run_key, []).append(s)

    def hits(span_id, run_id, op, nbytes, job, rk):
        jl = [job] if job is not None else sorted(jobs, key=str)
        rl = [rk] if rk is not None else sorted(ranks)
        index, key = (by_id, span_id) if span_id else (by_run, run_id)
        out = [s for j in jl for r in rl for s in index.get((j, r, key), [])]
        return out if span_id else _narrow(out, op, nbytes)

    problems = []
    for row in rows:
        if row.job_id not in jobs:
            continue  # untraced job sharing the folder: no claim
        h = hits(row.span_id, row.run_id, row.op, row.nbytes,
                 row.job_id, rank)
        if len(h) != 1:
            problems.append(
                f"row {row.op}/{row.nbytes} run {row.run_id} "
                f"(span_id {row.span_id!r}): {len(h)} enclosing span(s)"
            )
    for ev in events:
        sid = getattr(ev, "span_id", "")
        if ev.job_id not in jobs:
            continue  # untraced job sharing the folder: no claim
        if ev.kind == "link_degraded" and not sid:
            continue  # an untraced linkmap sweep's verdict event
        # link_degraded events carry the link OWNER's rank, not the
        # tracing process's — their span stamp resolves within the job
        rk = (None if ev.kind == "link_degraded"
              else rank if rank is not None else ev.rank)
        h = hits(sid, ev.run_id, ev.op or None, ev.nbytes or None,
                 ev.job_id, rk)
        if len(h) != 1:
            problems.append(
                f"health event {ev.kind} {ev.op} run {ev.run_id} "
                f"(span_id {sid!r}): {len(h)} enclosing span(s)"
            )
    if job_id is not None and job_id not in jobs:
        ledger = ()  # the ledger's job (from its file name) is untraced
    for rec in ledger:
        data = rec.data if hasattr(rec, "data") else rec
        if data.get("record") != "fault" or not data.get("run_id"):
            continue
        op = data.get("op") or None
        h = hits("", data["run_id"], op, data.get("nbytes") or None,
                 job_id, rank)
        ok = len(h) == 1 or (len(h) > 1 and op is None)
        if not ok:
            problems.append(
                f"chaos entry {data.get('kind')} run {data['run_id']}: "
                f"{len(h)} enclosing run span(s)"
            )
    return problems


def build_measure_overlaps(spans: Iterable[dict]) -> list[tuple[dict, dict]]:
    """(build, measure) span pairs whose time windows overlap on the
    same rank with the build on the WORKER track — the compile
    pipeline's concurrency as visible geometry instead of a phase-sum
    inequality."""
    spans = list(spans)
    builds = [s for s in spans
              if s.get("kind") == "build" and s.get("thread") == "worker"]
    measures = [s for s in spans if s.get("kind") == "measure"]
    out = []
    for b in builds:
        b0 = int(b["t_start_ns"])
        b1 = b0 + int(b["dur_ns"])
        for m in measures:
            if m.get("rank") != b.get("rank"):
                continue
            m0 = int(m["t_start_ns"])
            m1 = m0 + int(m["dur_ns"])
            if m0 < b1 and b0 < m1:
                out.append((b, m))
    return out


# -- the report's anomaly-context table ---------------------------------


def activity_label(s: dict) -> str:
    """One concurrent-activity cell (``rotate (m3, 1.2 ms)``) — shared
    by the report's anomaly-context table and chaos verify's
    missed-fault context column, so the two renderings cannot drift."""
    return f"{_name_of(s)} ({s['span_id']}, {int(s['dur_ns']) / 1e6:.3g} ms)"


def overlapping_activity(spans: list[dict], enclosing: dict) -> list[dict]:
    t0 = int(enclosing["t_start_ns"])
    t1 = t0 + int(enclosing["dur_ns"])
    out = []
    for s in spans:
        if s.get("kind") not in ACTIVITY_KINDS:
            continue
        if s.get("rank") != enclosing.get("rank"):
            continue
        s0 = int(s["t_start_ns"])
        s1 = s0 + int(s["dur_ns"])
        if s0 < t1 and t0 < s1:
            out.append(s)
    return out


def anomaly_context(events, spans: Iterable[dict]) -> list[dict]:
    """For each health event: the enclosing run span and any concurrent
    rotation/ingest/build/probe activity — the "was the harness doing
    something when this fired?" answer, per event."""
    spans = list(spans)
    out = []
    for ev in events:
        hits = resolve_run_span(
            spans, span_id=getattr(ev, "span_id", ""),
            # a link_degraded event's rank names the link OWNER, not
            # the process that traced the sweep
            rank=None if ev.kind == "link_degraded" else ev.rank,
            run_id=ev.run_id, op=ev.op or None, nbytes=ev.nbytes or None,
            job_id=ev.job_id,
        )
        enclosing = hits[0] if len(hits) == 1 else None
        concurrent = (overlapping_activity(spans, enclosing)
                      if enclosing is not None else [])
        out.append({
            "event": ev,
            "span": enclosing,
            "concurrent": concurrent,
        })
    return out


def anomaly_to_markdown(context: list[dict]) -> str:
    """Render :func:`anomaly_context` rows (the report table)."""
    lines = [
        "| severity | kind | op | run | enclosing span | concurrent "
        "activity |",
        "|---|---|---|---|---|---|",
    ]
    for row in context:
        ev = row["event"]
        span = row["span"]
        span_cell = span["span_id"] if span is not None else "—"
        acts = [activity_label(s) for s in row["concurrent"]]
        lines.append(
            f"| {ev.severity} | {ev.kind} | {ev.op} | {ev.run_id} "
            f"| {span_cell} | {'; '.join(acts) if acts else '—'} |"
        )
    return "\n".join(lines)
