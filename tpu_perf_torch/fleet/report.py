"""`tpu-perf-torch fleet report`: collect → roll up → grade → render
(port of ``tpu_perf/fleet/report.py``).

One pass over the fleet root produces every fleet surface at once: the
markdown report (or JSON artifact), the Prometheus textfile, and —
with a log folder — the durable ``fleet-*.log`` rollup records the
ingest pass ships to Kusto.  The pass is streaming end to end
(fleet.collect), so its memory is O(hosts × points) no matter how many
rows a soak left behind.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

from tpu_perf_torch.fleet.collect import discover_hosts, last_seen, stream_jsonl
from tpu_perf_torch.fleet.rollup import (
    FleetGradeConfig, FleetRecord, FleetShift, HostRollup, HostVerdict,
    TuneDisagreement, adaptive_json, adaptive_to_markdown, curves_json,
    curves_to_markdown, detect_shifts, disagreements_to_markdown,
    events_to_markdown, fleet_medians, fleet_winners, grade_hosts,
    host_summaries, hosts_to_markdown, links_to_markdown,
    render_fleet_textfile, shifts_to_markdown, verdicts_to_markdown,
    winners_to_markdown,
)
from tpu_perf_torch.schema import (
    CHAOS_PREFIX, EXT_PREFIX, HEALTH_PREFIX, LINKMAP_PREFIX,
)

#: the fleet artifact's machine-consumption schema; bump on breaking
#: shape changes (the shift detector reads old artifacts as baselines)
ARTIFACT_VERSION = 1


@dataclasses.dataclass
class FleetReport:
    """Everything one collection pass learned about the fleet."""

    root: str
    hosts: dict[str, HostRollup]
    config: FleetGradeConfig
    now: float
    verdicts: list[HostVerdict]
    shifts: list[FleetShift]
    medians: list[dict]
    summaries: list[dict]
    tune_majority: list[dict] = dataclasses.field(default_factory=list)
    tune_disagreements: list[TuneDisagreement] = dataclasses.field(
        default_factory=list)

    @property
    def tune_disagreeing_hosts(self) -> list[str]:
        return sorted({d.host for d in self.tune_disagreements})

    @property
    def sick_hosts(self) -> list[str]:
        return sorted({v.host for v in self.verdicts
                       if v.verdict != "ok"})

    @property
    def stale_hosts(self) -> list[str]:
        return [s["host"] for s in self.summaries if s["stale"]]


def collect_host(host: str, folder: str, *, err=None) -> HostRollup:
    """Stream one host folder's families into a rollup.  A family whose
    mid-file corruption raises is recorded as a host problem — the
    fleet pass keeps walking, one bad host must not blind the report to
    the other N-1 — and every intact record folded before the bad line
    still counts."""
    err = err if err is not None else sys.stderr
    from tpu_perf_torch.faults.spec import ChaosRecord
    from tpu_perf_torch.fleet.collect import host_paths, stream_parsed, stream_rows
    from tpu_perf_torch.health.events import HealthEvent
    from tpu_perf_torch.linkmap.probe import LinkmapRecord
    from tpu_perf_torch.report import read_phases

    roll = HostRollup(host, folder)

    def guarded(family, it, fold):
        try:
            for rec in it:
                fold(rec)
        except ValueError as e:
            roll.problems.append(f"{family}: {e}")
            print(f"tpu-perf-torch: host {host}: bad {family} record "
                  f"({e}); rest of the host still collected", file=err)

    guarded("rows",
            stream_rows(host_paths(folder, EXT_PREFIX), err=err),
            roll.fold_row)
    guarded("health",
            stream_parsed(host_paths(folder, HEALTH_PREFIX),
                          HealthEvent.from_json, err=err),
            roll.fold_event)
    guarded("chaos",
            stream_jsonl(host_paths(folder, CHAOS_PREFIX), ChaosRecord,
                         err=err),
            roll.fold_chaos)
    guarded("linkmap",
            stream_jsonl(host_paths(folder, LINKMAP_PREFIX), LinkmapRecord,
                         err=err),
            roll.fold_linkmap)
    roll.fold_phases(read_phases(folder))
    roll.last_seen = last_seen(folder)
    return roll


def build_report(root: str, *, config: FleetGradeConfig | None = None,
                 baseline: list[dict] | None = None,
                 now: float | None = None, err=None) -> FleetReport:
    """The whole pass.  ``now`` is injectable so staleness tests (and
    byte-stable renders) never race the wall clock."""
    err = err if err is not None else sys.stderr
    cfg = config or FleetGradeConfig()
    now = time.time() if now is None else now
    hosts = {host: collect_host(host, folder, err=err)
             for host, folder in discover_hosts(root).items()}
    verdicts = grade_hosts(hosts, cfg)
    medians = fleet_medians(hosts)
    shifts = (detect_shifts(medians, baseline, cfg)
              if baseline is not None else [])
    sick = {v.host for v in verdicts if v.verdict != "ok"}
    summaries = host_summaries(hosts, now=now, cfg=cfg, sick=sick)
    majority, disagreements = fleet_winners(hosts)
    return FleetReport(root=root, hosts=hosts, config=cfg, now=now,
                       verdicts=verdicts, shifts=shifts, medians=medians,
                       summaries=summaries, tune_majority=majority,
                       tune_disagreements=disagreements)


def report_to_json(rep: FleetReport) -> str:
    data = {
        "version": ARTIFACT_VERSION,
        "root": rep.root,
        "generated": rep.now,
        "config": dataclasses.asdict(rep.config),
        "hosts": rep.summaries,
        "curves": curves_json(rep.hosts),
        "fleet": rep.medians,
        "verdicts": [dataclasses.asdict(v) for v in rep.verdicts],
        "shifts": [dataclasses.asdict(s) for s in rep.shifts],
        "adaptive": adaptive_json(rep.hosts),
        "tune": {
            "winners": rep.tune_majority,
            "disagreements": [dataclasses.asdict(d)
                              for d in rep.tune_disagreements],
        },
        "summary": {
            "hosts": len(rep.hosts),
            "sick_hosts": rep.sick_hosts,
            "stale_hosts": rep.stale_hosts,
            "shifts": len(rep.shifts),
            "tune_disagreeing_hosts": rep.tune_disagreeing_hosts,
        },
    }
    return json.dumps(data, indent=2, sort_keys=True)


def report_to_markdown(rep: FleetReport) -> str:
    out = [f"# Fleet report — {len(rep.hosts)} host(s)", ""]
    out += ["## Hosts", "", hosts_to_markdown(rep.summaries), ""]
    if any(r.points for r in rep.hosts.values()):
        out += ["## Curves (per host)", "",
                curves_to_markdown(rep.hosts), ""]
    judged = [v for v in rep.verdicts]
    if judged:
        out += ["## Cross-host grading", "",
                verdicts_to_markdown(judged), ""]
    else:
        out += ["## Cross-host grading", "",
                f"No point was measured by >= "
                f"{rep.config.min_hosts} hosts — nothing to grade "
                "(cross-host comparison needs peers).", ""]
    if rep.shifts:
        out += ["## Fleet-wide shifts (vs baseline)", "",
                shifts_to_markdown(rep.shifts), ""]
    if any(r.events for r in rep.hosts.values()):
        out += ["## Health events", "", events_to_markdown(rep.hosts), ""]
    if any(r.adaptive for r in rep.hosts.values()):
        out += ["## Adaptive savings", "",
                adaptive_to_markdown(rep.hosts), ""]
    if any(r.links_bad_total for r in rep.hosts.values()):
        out += ["## Degraded links", "", links_to_markdown(rep.hosts), ""]
    if rep.tune_majority:
        out += ["## Crossover winners (fleet majority)", "",
                winners_to_markdown(rep.tune_majority), ""]
    if rep.tune_disagreements:
        out += ["## Crossover disagreements", "",
                disagreements_to_markdown(rep.tune_disagreements), ""]
    sick = rep.sick_hosts
    stale = rep.stale_hosts
    disagree = rep.tune_disagreeing_hosts
    out.append(
        f"{len(rep.hosts)} host(s): "
        f"{len(sick)} sick ({', '.join(sick) or 'none'}), "
        f"{len(stale)} stale ({', '.join(stale) or 'none'}), "
        f"{len(rep.shifts)} fleet-wide shift(s), "
        f"{len(disagree)} crossover-disagreeing "
        f"({', '.join(disagree) or 'none'})."
    )
    return "\n".join(out)


def render_textfile(rep: FleetReport) -> str:
    return render_fleet_textfile(rep.summaries, now=rep.now,
                                 shifts=len(rep.shifts))


def fleet_records(rep: FleetReport, *, job_id: str,
                  drains=()) -> list[FleetRecord]:
    """The rollup as records: a meta record, one ``host`` record per
    host, every verdict + shift + crossover disagreement, and — when
    `--drain-hook` acted — one
    ``drain`` record per sick host naming what the control plane did
    about the verdict (fleet.drain.DrainOutcome).  One builder feeds
    both the durable ``fleet-*.log`` write and the live `--push` tee,
    so the two surfaces can never carry different judgements."""
    records = [FleetRecord(
        record="meta", job_id=job_id, root=rep.root,
        hosts=sorted(rep.hosts),
        config=dataclasses.asdict(rep.config),
        sick_hosts=rep.sick_hosts, stale_hosts=rep.stale_hosts,
        shifts=len(rep.shifts),
    )]
    for s in rep.summaries:
        records.append(FleetRecord(record="host", job_id=job_id, **s))
    for v in rep.verdicts:
        records.append(FleetRecord(
            record="verdict", job_id=job_id, **dataclasses.asdict(v)))
    for sh in rep.shifts:
        records.append(FleetRecord(
            record="shift", job_id=job_id, **dataclasses.asdict(sh)))
    for d in drains:
        records.append(FleetRecord(
            record="drain", job_id=job_id, **d.to_record_fields()))
    for td in rep.tune_disagreements:
        rec = td.to_record()
        rec.data["job_id"] = job_id
        records.append(rec)
    return records


def write_fleet_records(folder: str, rep: FleetReport, *,
                        job_id: str, drains=()) -> None:
    """Persist the rollup as the seventh rotating family: one finished
    ``fleet-*.log`` per report (huge refresh = never rotates mid-write;
    lazy ``.open`` until closed, like every JSONL family)."""
    from tpu_perf_torch.driver import RotatingCsvLog
    from tpu_perf_torch.schema import FLEET_PREFIX

    log = RotatingCsvLog(folder, job_id, 0, refresh_sec=10**9,
                         prefix=FLEET_PREFIX, lazy=True)
    try:
        for rec in fleet_records(rep, job_id=job_id, drains=drains):
            log.write_row(rec)
    finally:
        log.close()


def read_fleet_records(paths, *, err=None) -> list[dict]:
    """Replay fleet-*.log records (the non-streaming read is fine here:
    rollup records are O(hosts + verdicts), not O(rows))."""
    from tpu_perf_torch.health.events import read_jsonl

    recs = read_jsonl(paths, lambda line: FleetRecord.from_json(line).data,
                      err=err)
    return [r for r in recs if "record" in r]
