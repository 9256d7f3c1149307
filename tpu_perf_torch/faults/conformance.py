"""Detector-conformance harness (port of
``tpu_perf/faults/conformance.py``): did the health pipeline notice?

``tpu-perf-torch chaos verify <dir>`` replays a chaos run's two durable
artifacts — the injection ledger (``chaos-*.log``) and the emitted
health events (``health-*.log``) — and verdicts every scheduled fault:

* **caught** — a health event of the fault's expected kind
  (spec.EXPECTED_EVENT), matching the fault's point filter, landed
  within the fault's fired-run span plus a grace tail (detectors are
  late by construction: a spike is confirmed by its successor, a
  regression needs EWMA convergence, capture loss fires at the next
  heartbeat boundary — so the default grace is two stats windows);
* **missed** — no such event (including faults that never fired: a
  window the soak never reached is a coverage miss, not a pass);
* **n/a** — jitter entries, which no detector is supposed to alert on.

Corrupt faults are judged from the ledger's ``selftest`` records (the
driver runs the rx-validation pass at exit): FAIL = the corruption was
caught, ok = it slipped through.

Events not attributable to any fault are **false alarms** (``recovered``
events are exempt: they are episode exits that legitimately trail a
fault window).  The per-detector table reports injected/caught/missed/
false-alarm counts with precision and recall — the "provably detects
faults" table the health subsystem has to earn.
"""

from __future__ import annotations

import dataclasses
import json

from tpu_perf_torch.faults.spec import EXPECTED_EVENT, FaultSpec, parse_spec
from tpu_perf_torch.health.events import HealthEvent, read_jsonl
from tpu_perf_torch.schema import base_op


def read_ledger(paths, *, err=None) -> list[dict]:
    """Parse JSONL chaos records through the family's own record class
    (schema.JsonlRecord — ONE parser per contract, so a torn-line or
    discriminator fix reaches verify too); torn-final-line policy shared
    with the health replay (health.events.read_jsonl — a killed soak can
    tear its last append; corruption anywhere else raises)."""
    from tpu_perf_torch.faults.spec import ChaosRecord

    return read_jsonl(paths, lambda line: ChaosRecord.from_json(line).data,
                      err=err)


@dataclasses.dataclass(frozen=True)
class FaultVerdict:
    """One spec entry's judgement.

    ``context`` names the harness activity (rotations, ingest passes,
    pipeline builds, probe schedules — trace.export.ACTIVITY_KINDS)
    concurrent with the fault's fired runs, resolved through the span
    stream when the soak ran with ``--spans``: a MISSED fault that
    coincided with an ingest stall reads as exactly that, instead of a
    bare "no event" whose cause needs stderr archaeology."""

    spec_index: int
    fault: FaultSpec
    expected: str | None   # event kind, "selftest", or None (jitter)
    verdict: str           # caught | missed | n/a
    injected: int          # fired ledger records
    first_run: int         # 0 when never fired
    last_run: int
    detail: str
    context: str = ""      # concurrent harness activity ("" = untraced)


@dataclasses.dataclass(frozen=True)
class DetectorScore:
    """Aggregate per detector: the precision/recall row."""

    detector: str
    injected: int
    caught: int
    missed: int
    false_alarms: int

    @property
    def precision(self) -> float | None:
        d = self.caught + self.false_alarms
        return self.caught / d if d else None

    @property
    def recall(self) -> float | None:
        d = self.caught + self.missed
        return self.caught / d if d else None


@dataclasses.dataclass(frozen=True)
class ConformanceReport:
    meta: dict
    verdicts: list[FaultVerdict]
    scores: list[DetectorScore]
    false_alarms: list[HealthEvent]
    events_total: int

    @property
    def missed_critical(self) -> list[FaultVerdict]:
        return [v for v in self.verdicts
                if v.verdict == "missed" and v.fault.critical]


def _event_matches(f: FaultSpec, expected: str, ev: HealthEvent,
                   first: int, last: int, grace: int) -> bool:
    if ev.kind != expected:
        return False
    if not first <= ev.run_id <= last + grace:
        return False
    if f.rank is not None and ev.rank != f.rank and f.kind != "skew":
        # a rank-filtered fault is only caught by the host it degraded:
        # the event's rank column must NAME the sick host, or the
        # "which host" answer the filter exists for was never proven.
        # EXCEPT skew — a latency-coupled fault: staggering rank 1's
        # entry inflates every OTHER rank's observed collective (the
        # victims wait for the straggler), so detection legitimately
        # lands on the victim ranks' rows and any rank's event counts
        return False
    if expected == "hook_fail":
        return True  # not point-scoped (op is the synthetic "ingest_hook")
    # arena soaks key health points on the DECORATED op label
    # (``allreduce[ring]``, skew sweeps ``...@500us``, imbalance
    # sweeps ``...%8``, scenarios ``scenario[<name>]``) while fault
    # specs target the raw op the injector filters on — resolve the
    # base name through the ONE shared parser (schema.parse_op_label
    # via base_op) so an injected fault caught under any algorithm's/
    # spread's/ratio's baseline still counts as caught
    if f.op != "*" and ev.op != f.op and base_op(ev.op) != f.op:
        return False
    if expected == "capture_loss":
        return True  # op-level events carry nbytes=0 by contract
    return f.nbytes == 0 or ev.nbytes == f.nbytes


def _span_context(f: FaultSpec, fired: list[dict],
                  spans: list[dict]) -> str:
    """Concurrent-activity attribution for one fault: the harness
    activity spans (trace.export.ACTIVITY_KINDS) overlapping any of the
    fault's fired runs' span windows — the anomaly-context join
    (trace.anomaly_context), pointed at the LEDGER side so a missed
    fault names what the harness was doing when the detector stayed
    quiet."""
    from tpu_perf_torch.trace.export import activity_label, overlapping_activity

    fired_ids = {int(r["run_id"]) for r in fired if r.get("run_id")}
    if not fired_ids or not spans:
        return ""
    hits: dict[str, str] = {}
    for s in spans:
        if s.get("kind") != "run":
            continue
        attrs = s.get("attrs") or {}
        if attrs.get("run_id") not in fired_ids:
            continue
        if f.op != "*" and attrs.get("op") not in (None, f.op):
            continue
        # one overlap test + one label rendering for the whole stack
        # (the report's anomaly-context table uses the same pair)
        for act in overlapping_activity(spans, s):
            hits[act["span_id"]] = activity_label(act)
    return "; ".join(hits[k] for k in sorted(hits))


def run_conformance(
    records: list[dict],
    events: list[HealthEvent],
    *,
    grace_runs: int | None = None,
    spans: list[dict] | None = None,
) -> ConformanceReport:
    """Join the ledger against the events; judge every scheduled fault.
    ``spans`` (spans.read_span_records of the soak's folder, if it ran
    with --spans) adds concurrent-activity attribution to each missed
    fault's verdict (:func:`_span_context`)."""
    metas = [r for r in records if r.get("record") == "meta"]
    if not metas:
        raise ValueError(
            "no meta record in the chaos ledger — was this folder written "
            "by `tpu-perf chaos`?"
        )
    # one soak writes ONE meta (a multi-rank soak writes one identical
    # meta per rank); distinct metas mean the folder holds ledgers from
    # different soaks, whose fault records would pool under each other's
    # spec indices and run-id space — a garbage join must not be judged
    if len({json.dumps(m, sort_keys=True) for m in metas}) > 1:
        raise ValueError(
            f"{len(metas)} disagreeing meta records: these ledgers mix "
            "more than one chaos soak — point verify at one soak's files "
            "(or clean the log folder between soaks)"
        )
    meta = metas[0]
    stats_every = int(meta.get("stats_every", 1000))
    if grace_runs is None:
        grace_runs = 2 * stats_every
    faults = parse_spec(meta.get("faults", []))
    fired: dict[int, list[dict]] = {}
    for r in records:
        if r.get("record") == "fault":
            fired.setdefault(int(r["spec"]), []).append(r)
    selftests = {r["op"]: r for r in records if r.get("record") == "selftest"}

    verdicts: list[FaultVerdict] = []
    attributed: set[int] = set()  # indices into `events`
    for idx, f in enumerate(faults):
        expected = EXPECTED_EVENT[f.kind]
        recs = fired.get(idx, [])
        runs = sorted(int(r["run_id"]) for r in recs)
        first, last = (runs[0], runs[-1]) if runs else (0, 0)
        if expected is None:
            verdicts.append(FaultVerdict(
                idx, f, None, "n/a", len(recs), first, last,
                "injected noise; no detector should fire",
            ))
            continue
        if expected == "selftest":
            st = selftests.get(f.op)
            if st is None:
                verdict, detail = "missed", "no selftest record in ledger"
            elif st["status"] == "fail":
                verdict, detail = "caught", f"selftest FAIL: {st['detail']}"
            else:
                verdict = "missed"
                detail = f"selftest {st['status']}: corruption slipped through"
            verdicts.append(FaultVerdict(
                idx, f, expected, verdict, len(recs), first, last, detail,
            ))
            continue
        if not recs:
            verdicts.append(FaultVerdict(
                idx, f, expected, "missed", 0, 0, 0,
                "never fired — the soak did not cover this window",
            ))
            continue
        hits = [
            i for i, ev in enumerate(events)
            if _event_matches(f, expected, ev, first, last, grace_runs)
        ]
        attributed.update(hits)
        if hits:
            ev = events[hits[0]]
            verdicts.append(FaultVerdict(
                idx, f, expected, "caught", len(recs), first, last,
                f"{ev.kind} event at run {ev.run_id} "
                f"({ev.severity}, observed {ev.observed:.6g})",
            ))
        else:
            verdicts.append(FaultVerdict(
                idx, f, expected, "missed", len(recs), first, last,
                f"no {expected} event in runs [{first}, {last + grace_runs}]",
                context=_span_context(f, recs, spans or []),
            ))
    # `recovered` events are exempt from false-alarm accounting
    # unconditionally: they are episode exits, not alerts (their entry
    # event is what gets attributed or flagged)
    false_alarms = [
        ev for i, ev in enumerate(events)
        if i not in attributed and ev.kind != "recovered"
    ]

    detectors: dict[str, dict[str, int]] = {}
    for v in verdicts:
        if v.expected is None:
            continue
        d = detectors.setdefault(
            v.expected, {"injected": 0, "caught": 0, "missed": 0, "fp": 0}
        )
        d["injected"] += 1
        if v.verdict == "caught":
            d["caught"] += 1
        elif v.verdict == "missed":
            d["missed"] += 1
    for ev in false_alarms:
        d = detectors.setdefault(
            ev.kind, {"injected": 0, "caught": 0, "missed": 0, "fp": 0}
        )
        d["fp"] += 1
    scores = [
        DetectorScore(k, d["injected"], d["caught"], d["missed"], d["fp"])
        for k, d in sorted(detectors.items())
    ]
    return ConformanceReport(
        meta=meta, verdicts=verdicts, scores=scores,
        false_alarms=false_alarms, events_total=len(events),
    )


def _pct(x: float | None) -> str:
    return "—" if x is None else f"{100.0 * x:.0f}%"


def report_to_markdown(rep: ConformanceReport) -> str:
    lines = [
        "| # | kind | op | size | window | fired | expected | verdict "
        "| detail | concurrent activity |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    from tpu_perf_torch.sweep import format_size

    for v in rep.verdicts:
        f = v.fault
        size = format_size(f.nbytes) if f.nbytes else "*"
        end = f.end if f.end is not None else "∞"
        lines.append(
            f"| {v.spec_index} | {f.kind} | {f.op} | {size} "
            f"| {f.start}-{end} | {v.injected} | {v.expected or '—'} "
            f"| {v.verdict} | {v.detail} | {v.context or '—'} |"
        )
    lines += [
        "",
        "| detector | injected | caught | missed | false alarms "
        "| precision | recall |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in rep.scores:
        lines.append(
            f"| {s.detector} | {s.injected} | {s.caught} | {s.missed} "
            f"| {s.false_alarms} | {_pct(s.precision)} | {_pct(s.recall)} |"
        )
    caught = sum(1 for v in rep.verdicts if v.verdict == "caught")
    judged = sum(1 for v in rep.verdicts if v.expected is not None)
    lines.append("")
    lines.append(
        f"{caught}/{judged} fault(s) caught, "
        f"{len(rep.missed_critical)} critical miss(es), "
        f"{len(rep.false_alarms)} false alarm(s) over "
        f"{rep.events_total} event(s)."
    )
    return "\n".join(lines)


def render_conformance_textfile(rep: ConformanceReport, *,
                                now: float) -> str:
    """Prometheus gauges for one ``chaos verify`` run — the dashboard
    feed for SCHEDULED conformance soaks, so detector drift shows up on
    a graph instead of in unread markdown.  Same label/escaping
    conventions as the health exporter; write through
    ``health.exporter.write_textfile`` (atomic)."""
    from tpu_perf_torch.health.exporter import labels

    lines = []

    def family(name: str, help_: str, kind: str = "gauge") -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")

    per = {
        "injected": "Faults injected for this detector in the judged soak.",
        "caught": "Faults the detector caught.",
        "missed": "Faults the detector missed.",
        "false_alarms": "Events not attributable to any injected fault.",
    }
    for field, help_ in per.items():
        family(f"tpu_perf_chaos_detector_{field}", help_)
        for s in rep.scores:
            lines.append(
                f"tpu_perf_chaos_detector_{field}"
                f"{labels(detector=s.detector)} {getattr(s, field)}"
            )
    family("tpu_perf_chaos_missed_critical",
           "Critical faults missed — the exit-5 gate condition.")
    lines.append(f"tpu_perf_chaos_missed_critical {len(rep.missed_critical)}")
    family("tpu_perf_chaos_false_alarms_total",
           "Unattributable events across all detectors.")
    lines.append(f"tpu_perf_chaos_false_alarms_total {len(rep.false_alarms)}")
    family("tpu_perf_chaos_last_verify_timestamp_seconds",
           "Unix time of the last completed chaos verify run.")
    lines.append(f"tpu_perf_chaos_last_verify_timestamp_seconds {now:.3f}")
    return "\n".join(lines) + "\n"


def report_to_json(rep: ConformanceReport) -> str:
    return json.dumps({
        "meta": rep.meta,
        "faults": [
            {
                "spec_index": v.spec_index,
                **dataclasses.asdict(v.fault),
                "expected": v.expected,
                "verdict": v.verdict,
                "injected": v.injected,
                "first_run": v.first_run,
                "last_run": v.last_run,
                "detail": v.detail,
                "context": v.context,
            }
            for v in rep.verdicts
        ],
        "detectors": [
            {
                "detector": s.detector,
                "injected": s.injected,
                "caught": s.caught,
                "missed": s.missed,
                "false_alarms": s.false_alarms,
                "precision": s.precision,
                "recall": s.recall,
            }
            for s in rep.scores
        ],
        "false_alarms": [dataclasses.asdict(e) for e in rep.false_alarms],
        "missed_critical": [v.spec_index for v in rep.missed_critical],
    }, indent=2)
