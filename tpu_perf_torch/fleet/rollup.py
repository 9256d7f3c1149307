"""Topology-aware fleet rollups: per-host streaming stats, cross-host
MAD grading, fleet-wide shift detection, and staleness (port of
``tpu_perf/fleet/rollup.py``).

The single-host instruments judge every host against its own local
baseline — which is exactly the comparison that CANNOT see a fleet-wide
regression (every host that has it looks "normal" to itself) or name a
straggler host (one slow host skews every collective it joins, the
imbalanced-arrival failure mode of arXiv:1804.05349).  This module makes
the two missing comparisons:

* **cross-host** — per (op, nbytes, dtype, mode) sweep point, each
  host's streamed p50 latency is judged against its PEER hosts through
  the same robust-z MAD machinery that grades links
  (linkmap.grade.mad_robust_z): z over the peer MAD AND a relative
  excess over the peer median, so the worst hosts fleet-wide are
  *named*, not averaged away;
* **fleet-vs-baseline** — when a previous fleet artifact is supplied,
  the CURRENT fleet median at each point is compared against the
  baseline fleet median; a move beyond the shift threshold is flagged
  as a *fleet-wide shift* at that point — the regression every host's
  local baseline absorbs silently.

Aggregation is streaming end to end: per (host, point) state is one
Welford + three P² quantile estimators (health.stats — the same O(1)
machinery the daemon baselines use), so memory is O(hosts × points),
never O(rows).  Chaos-mode rows are excluded from grading (their
samples are deliberately perturbed) and daemon/oneshot modes never
pool — the don't-blend discipline the report pivots established.

Rollups persist as the SEVENTH rotating family (``fleet-*.log``,
schema.FLEET_PREFIX, JSONL, lazy ``.open``) so the ingest pass ships
fleet-level verdicts to their own Kusto table (FleetRollupTPU).
"""

from __future__ import annotations

import dataclasses
import json

from tpu_perf_torch.health.stats import P2Quantile, Welford
from tpu_perf_torch.linkmap.grade import mad_robust_z
from tpu_perf_torch.schema import JsonlRecord, decorate_op, parse_op_label
from tpu_perf_torch.sweep import format_size


class FleetRecord(JsonlRecord):
    """One ``fleet-*.log`` JSONL line (record = meta | host | verdict |
    shift | tune_disagreement) — the durable/queryable form of one
    fleet report."""

    __slots__ = ()
    FAMILY = "fleet"


#: bound on the per-host sick-link list a rollup retains (the TOTAL is
#: always counted — a capped table says "top N of M", never "M == N")
LINK_BAD_CAP = 20


class PointStats:
    """One (host, op, nbytes, dtype, mode) point's streaming state:
    Welford mean + P² p50/p95/p99 latency and P² p50 bus bandwidth —
    O(1) per row, no sample retention."""

    __slots__ = ("runs", "lat_mean", "lat_p50", "lat_p95", "lat_p99",
                 "bus_p50", "n_devices")

    def __init__(self) -> None:
        self.runs = 0
        self.lat_mean = Welford()
        self.lat_p50 = P2Quantile(0.5)
        self.lat_p95 = P2Quantile(0.95)
        self.lat_p99 = P2Quantile(0.99)
        self.bus_p50 = P2Quantile(0.5)
        self.n_devices = 0

    def push(self, lat_us: float, busbw_gbps: float, n_devices: int) -> None:
        self.runs += 1
        self.lat_mean.push(lat_us)
        self.lat_p50.push(lat_us)
        self.lat_p95.push(lat_us)
        self.lat_p99.push(lat_us)
        self.bus_p50.push(busbw_gbps)
        self.n_devices = max(self.n_devices, n_devices)

    def snapshot(self) -> dict:
        return {
            "runs": self.runs,
            "n_devices": self.n_devices,
            "lat_us": {
                "avg": self.lat_mean.mean,
                "p50": self.lat_p50.value() or 0.0,
                "p95": self.lat_p95.value() or 0.0,
                "p99": self.lat_p99.value() or 0.0,
            },
            "busbw_gbps": {"p50": self.bus_p50.value() or 0.0},
        }


class HostRollup:
    """Everything one host contributes to the fleet view, O(points)."""

    def __init__(self, host: str, folder: str) -> None:
        self.host = host
        self.folder = folder
        #: (op, nbytes, dtype, mode) -> PointStats
        self.points: dict[tuple, PointStats] = {}
        self.jobs: set[str] = set()
        self.rows = 0
        #: (kind, severity) -> count
        self.events: dict[tuple[str, str], int] = {}
        self.event_last_run: dict[str, int] = {}
        #: (job_id, op, nbytes, dtype) -> final-row adaptive verdict
        self.adaptive: dict[tuple, dict] = {}
        self.chaos_injections = 0
        #: worst non-ok linkmap verdicts (capped; total always counted)
        self.links_bad: list[dict] = []
        self.links_bad_total = 0
        self.phase: dict[str, float] = {}
        self.wall_s = 0.0
        self.last_seen: float | None = None
        #: per-family read problems (a corrupt mid-file log) — surfaced
        #: in the report instead of killing the whole fleet pass
        self.problems: list[str] = []

    # -- streaming folds ------------------------------------------------

    def fold_row(self, row) -> None:
        self.rows += 1
        self.jobs.add(row.job_id)
        # arena and skew-axis rows fold under the decorated op name
        # (schema.decorate_op — the same op[algo]@Nus spelling the
        # driver's health keys and the report tables use): an algorithm
        # or arrival-spread experiment must neither blend into a host's
        # native synchronized curve nor get the host MAD-flagged
        # against peers running the clean lowering; same for a
        # contention row's load coordinate (op[algo]&load)
        op = decorate_op(row.op, row.algo, row.skew_us, row.imbalance,
                         getattr(row, "load", ""))
        key = (op, row.nbytes, row.dtype, row.mode)
        stats = self.points.get(key)
        if stats is None:
            stats = self.points[key] = PointStats()
        stats.push(row.lat_us, row.busbw_gbps, row.n_devices)
        if row.runs_requested > 0:
            # the adaptive columns stream; the point's final row (max
            # run_id) carries the controller verdict — keep only that
            akey = (row.job_id, op, row.nbytes, row.dtype)
            cur = self.adaptive.get(akey)
            if cur is None or row.run_id > cur["runs_attempted"]:
                self.adaptive[akey] = {
                    "job_id": row.job_id, "op": op,
                    "nbytes": row.nbytes, "dtype": row.dtype,
                    "runs_requested": row.runs_requested,
                    "runs_attempted": row.run_id,
                    "runs_taken": row.runs_taken,
                    "ci_rel": row.ci_rel,
                }

    def fold_event(self, ev) -> None:
        key = (ev.kind, ev.severity)
        self.events[key] = self.events.get(key, 0) + 1
        self.event_last_run[ev.kind] = max(
            self.event_last_run.get(ev.kind, 0), ev.run_id)

    def fold_chaos(self, rec: dict) -> None:
        if rec.get("record") == "fault":
            self.chaos_injections += 1

    def fold_linkmap(self, rec: dict) -> None:
        if rec.get("record") != "verdict" or rec.get("verdict") == "ok":
            return
        self.links_bad_total += 1
        entry = {
            "op": rec.get("op", ""),
            "verdict": rec.get("verdict", ""),
            "rel": rec.get("rel"),
            "rank": rec.get("rank", 0),
            "axis": rec.get("axis", ""),
        }
        self.links_bad.append(entry)
        if len(self.links_bad) > LINK_BAD_CAP:
            # keep the worst by relative excess (None sorts best)
            self.links_bad.sort(
                key=lambda r: -(r["rel"] if r["rel"] is not None else -1.0))
            del self.links_bad[LINK_BAD_CAP:]

    def fold_phases(self, entries: list[dict]) -> None:
        for e in entries:
            self.wall_s += float(e.get("wall_s") or 0.0)
            for k, v in (e.get("phase") or {}).items():
                self.phase[k] = self.phase.get(k, 0.0) + float(v)

    # -- views ----------------------------------------------------------

    @property
    def worst_severity(self) -> str:
        from tpu_perf_torch.health.detect import SEVERITY_RANK

        worst = ""
        rank = -1
        for (_, sev), _n in self.events.items():
            r = SEVERITY_RANK.get(sev, 0)
            if r > rank:
                rank, worst = r, sev
        return worst

    @property
    def events_total(self) -> int:
        return sum(self.events.values())


@dataclasses.dataclass(frozen=True)
class FleetGradeConfig:
    """Cross-host grading knobs — deliberately the linkmap grader's
    shape (same robust-z core, same AND-gate), at host granularity."""

    mad_z: float = 6.0            # robust z bar vs the peer hosts
    rel_threshold: float = 0.25   # AND a +25% excess over the peer median
    min_hosts: int = 3            # peers needed before a point is judged
    shift_threshold: float = 0.25  # fleet median vs baseline artifact
    stale_after: float = 3600.0   # seconds without a write = stale

    def __post_init__(self) -> None:
        if self.mad_z <= 0 or self.rel_threshold <= 0:
            raise ValueError("mad_z and rel_threshold must be positive")
        if self.min_hosts < 2:
            raise ValueError(
                f"min_hosts must be >= 2, got {self.min_hosts}")
        if self.shift_threshold <= 0:
            raise ValueError(
                f"shift_threshold must be positive, "
                f"got {self.shift_threshold}")
        if self.stale_after <= 0:
            raise ValueError(
                f"stale_after must be positive, got {self.stale_after}")


@dataclasses.dataclass(frozen=True)
class HostVerdict:
    """One host judged at one sweep point against its fleet peers."""

    host: str
    op: str
    nbytes: int
    dtype: str
    mode: str
    lat_p50_us: float
    peer_p50_us: float | None  # peer-host median (the healthy baseline)
    mad_z: float | None
    rel: float | None
    verdict: str               # ok | slow
    detail: str

    def to_record(self) -> FleetRecord:
        return FleetRecord(record="verdict",
                           **dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class FleetShift:
    """The fleet median itself moved at one point — the regression no
    per-host comparison (local baseline OR cross-host MAD) can see."""

    op: str
    nbytes: int
    dtype: str
    mode: str
    fleet_p50_us: float
    baseline_p50_us: float
    ratio: float  # current / baseline; > 1 reads as 'slower now'

    def to_record(self) -> FleetRecord:
        return FleetRecord(record="shift", **dataclasses.asdict(self))


def grade_hosts(hosts: dict[str, HostRollup],
                cfg: FleetGradeConfig) -> list[HostVerdict]:
    """Judge every (host, point) against the OTHER hosts at that point.

    Chaos-mode points are excluded outright (deliberately perturbed
    samples must not flag a host sick, nor shield a sick peer by
    inflating the population spread).  Points measured by fewer than
    ``min_hosts`` hosts are not judged — two hosts cannot outvote each
    other.  Verdicts come back for every judged (host, point), ok rows
    included, so the artifact records what WAS compared."""
    by_point: dict[tuple, dict[str, float]] = {}
    for host, roll in hosts.items():
        for (op, nbytes, dtype, mode), stats in roll.points.items():
            if mode == "chaos":
                continue
            p50 = stats.lat_p50.value()
            if p50 is not None and stats.runs > 0:
                by_point.setdefault((op, nbytes, dtype, mode), {})[host] = p50
    verdicts: list[HostVerdict] = []
    for (op, nbytes, dtype, mode), vals in sorted(by_point.items()):
        if len(vals) < cfg.min_hosts:
            continue
        for host in sorted(vals):
            t = vals[host]
            pop = [v for h, v in vals.items() if h != host]
            z, rel, med = mad_robust_z(t, pop,
                                       rel_threshold=cfg.rel_threshold)
            common = dict(host=host, op=op, nbytes=nbytes, dtype=dtype,
                          mode=mode, lat_p50_us=t,
                          peer_p50_us=med, mad_z=z, rel=rel)
            if (z is not None and rel is not None
                    and z > cfg.mad_z and rel > cfg.rel_threshold):
                verdicts.append(HostVerdict(
                    **common, verdict="slow",
                    detail=f"+{100 * rel:.3g}% vs {len(pop)} peer host(s) "
                           f"(robust z {z:.3g})",
                ))
            else:
                verdicts.append(HostVerdict(**common, verdict="ok",
                                            detail=""))
    return verdicts


def fleet_medians(hosts: dict[str, HostRollup]) -> list[dict]:
    """Per-point fleet summary: host count and the median of the hosts'
    p50s (median-of-medians — robust to one straggler, which is the
    cross-host grader's job to name)."""
    from tpu_perf_torch.metrics import percentile

    by_point: dict[tuple, list[tuple[float, float]]] = {}
    for roll in hosts.values():
        for (op, nbytes, dtype, mode), stats in roll.points.items():
            if mode == "chaos":
                continue
            p50 = stats.lat_p50.value()
            if p50 is not None:
                by_point.setdefault((op, nbytes, dtype, mode), []).append(
                    (p50, stats.bus_p50.value() or 0.0))
    out = []
    for (op, nbytes, dtype, mode), vals in sorted(by_point.items()):
        out.append({
            "op": op, "nbytes": nbytes, "dtype": dtype, "mode": mode,
            "hosts": len(vals),
            "fleet_lat_p50_us": percentile([v[0] for v in vals], 50),
            "fleet_busbw_p50_gbps": percentile([v[1] for v in vals], 50),
        })
    return out


def detect_shifts(current: list[dict], baseline: list[dict],
                  cfg: FleetGradeConfig) -> list[FleetShift]:
    """Compare the CURRENT fleet medians against a previous artifact's.

    A point whose fleet median latency moved beyond ``shift_threshold``
    is a fleet-wide shift: flagged as such — at fleet scope, naming the
    point — instead of being absorbed into every host's local baseline
    (where it looks "normal" to each host individually) or cancelling
    out of the cross-host MAD (where a uniform shift has zero spread)."""
    base = {(b["op"], b["nbytes"], b["dtype"], b["mode"]):
            b["fleet_lat_p50_us"] for b in baseline}
    shifts = []
    for cur in current:
        key = (cur["op"], cur["nbytes"], cur["dtype"], cur["mode"])
        b = base.get(key)
        if not b or b <= 0 or cur["fleet_lat_p50_us"] <= 0:
            continue
        ratio = cur["fleet_lat_p50_us"] / b
        if ratio > 1.0 + cfg.shift_threshold:
            shifts.append(FleetShift(
                op=key[0], nbytes=key[1], dtype=key[2], mode=key[3],
                fleet_p50_us=cur["fleet_lat_p50_us"], baseline_p50_us=b,
                ratio=ratio,
            ))
    return shifts


def load_baseline_artifact(path: str) -> list[dict]:
    """The ``fleet`` section of a previous ``fleet report --format
    json`` artifact (or ``-o`` file) — the shift detector's reference."""
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "fleet" not in data:
        raise ValueError(
            f"{path!r} is not a fleet report artifact (no 'fleet' key)")
    return data["fleet"]


# -------------------------------------------- tuner winner-table rollup


@dataclasses.dataclass(frozen=True)
class TuneDisagreement:
    """One host whose local crossover winner disagrees with the fleet
    majority at one point — a sick-link smell (a host whose fabric
    degrades one decomposition more than its peers' fabrics do) the
    linkmap can then localize."""

    host: str
    op: str
    nbytes: int
    dtype: str
    skew_us: int
    imbalance: int
    load: str
    local_winner: str
    fleet_winner: str
    votes: int   # hosts voting the fleet winner
    hosts: int   # hosts voting at all

    def to_record(self) -> FleetRecord:
        return FleetRecord(record="tune_disagreement",
                           **dataclasses.asdict(self))

    def describe(self) -> str:
        return (f"{self.host}: {self.op}@{self.nbytes}B/{self.dtype} "
                f"local winner {self.local_winner!r} vs fleet majority "
                f"{self.fleet_winner!r} ({self.votes}/{self.hosts} "
                f"hosts)")


def host_winner_table(roll: HostRollup) -> dict[tuple, dict]:
    """One host's crossover winner table, derived from the rollup's
    decorated-op points (parse_op_label — the algo rode the label into
    the fold, so no second pass over rows is needed): per (op, nbytes,
    dtype, skew, imbalance, load) slot that raced any decomposition,
    the fastest algorithm by p50 with its margin.  Chaos-mode points
    are excluded (compare_arena's rule: injected degradation must not
    crown a winner); when one algorithm measured under several modes,
    the one-shot largest-mesh point takes the slot (the pivot
    preference); native-only slots are dropped (no race, no verdict);
    ties break lexicographically (the arena's determinism rule)."""
    slots: dict[tuple, dict[str, tuple]] = {}
    for (label, nbytes, dtype, mode), stats in roll.points.items():
        if mode == "chaos":
            continue
        p50 = stats.lat_p50.value()
        if p50 is None or stats.runs == 0:
            continue
        op, algo, skew_us, imbalance, load = parse_op_label(label)
        algo = algo or "native"
        pref = (mode == "oneshot", stats.n_devices, stats.runs)
        slot = slots.setdefault(
            (op, nbytes, dtype, skew_us, imbalance, load), {})
        cur = slot.get(algo)
        if cur is None or pref > cur[0]:
            slot[algo] = (pref, p50, stats)
    out: dict[tuple, dict] = {}
    for key, slot in sorted(slots.items()):
        if not any(a != "native" for a in slot):
            continue
        ordered = sorted(slot.items(), key=lambda kv: (kv[1][1], kv[0]))
        winner, (_, p50, stats) = ordered[0]
        runner_up, runner_p50 = ("", 0.0)
        if len(ordered) >= 2:
            runner_up, runner_p50 = ordered[1][0], ordered[1][1][1]
        native = slot.get("native")
        out[key] = {
            "winner": winner, "lat_p50_us": p50,
            "runner_up": runner_up, "runner_up_p50_us": runner_p50,
            "margin": (runner_p50 / p50) if runner_up and p50 else 0.0,
            "native_p50_us": native[1] if native else 0.0,
            "algos": sorted(slot), "samples": stats.runs,
            "n_devices": stats.n_devices,
        }
    return out


def fleet_winners(hosts: dict[str, HostRollup],
                  ) -> tuple[list[dict], list[TuneDisagreement]]:
    """Fold per-host winner tables into the fleet view: per point, the
    majority winner (ties break lexicographically, so the verdict is
    deterministic) with pooled stats from the hosts that voted for it —
    and a named disagreement for every host whose local winner differs
    from the majority.  A disagreeing host is never averaged away: its
    fabric crowned a different algorithm than its peers', which is a
    signal, not noise."""
    from tpu_perf_torch.metrics import percentile

    tables = {h: host_winner_table(hosts[h]) for h in sorted(hosts)}
    keys = sorted({k for t in tables.values() for k in t})
    majority: list[dict] = []
    disagreements: list[TuneDisagreement] = []
    for key in keys:
        votes = {h: t[key] for h, t in tables.items() if key in t}
        counts: dict[str, int] = {}
        for v in votes.values():
            counts[v["winner"]] = counts.get(v["winner"], 0) + 1
        fleet_winner = min(counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))[0]
        backers = [v for v in votes.values()
                   if v["winner"] == fleet_winner]
        op, nbytes, dtype, skew_us, imbalance, load = key
        native_p50s = [v["native_p50_us"] for v in backers
                       if v["native_p50_us"] > 0]
        majority.append({
            "op": op, "nbytes": nbytes, "dtype": dtype,
            "skew_us": skew_us, "imbalance": imbalance, "load": load,
            "winner": fleet_winner,
            "votes": counts[fleet_winner], "hosts": len(votes),
            "lat_p50_us": percentile(
                [b["lat_p50_us"] for b in backers], 50),
            "margin": percentile([b["margin"] for b in backers], 50),
            "native_p50_us": percentile(native_p50s, 50)
            if native_p50s else 0.0,
            "samples": sum(v["samples"] for v in votes.values()),
            "n_devices": max(v["n_devices"] for v in votes.values()),
            "algos": sorted({a for v in votes.values()
                             for a in v["algos"]}),
        })
        for h in sorted(votes):
            if votes[h]["winner"] != fleet_winner:
                disagreements.append(TuneDisagreement(
                    host=h, op=op, nbytes=nbytes, dtype=dtype,
                    skew_us=skew_us, imbalance=imbalance, load=load,
                    local_winner=votes[h]["winner"],
                    fleet_winner=fleet_winner,
                    votes=counts[fleet_winner], hosts=len(votes)))
    return majority, disagreements


def merge_fleet_selection(hosts: dict[str, HostRollup], *,
                          generated: str, generated_unix: float,
                          device_kind: str = "", source: str = ""):
    """One merged fleet selection artifact (tpu_perf_torch.tuner
    SelectionArtifact) from the majority winner table: the artifact
    `fleet report --tune-out` publishes and pushes through the live
    plane.  Fleet entries carry the majority-backing hosts' pooled
    stats; the per-host runner-up identity does not survive the merge
    (margins do — the median of the backing hosts').  ``device_kind`` is
    the card's name and ``chip`` its short name in the port's card table,
    as the port's ``tune`` writes them."""
    from tpu_perf_torch.arena.hierarchy import hier_axis_pairs, mesh_shape_label
    from tpu_perf_torch.tuner.artifact import (
        TUNER_SCHEMA_VERSION, SelectionArtifact, SelectionEntry, _chip_of,
    )

    majority, _ = fleet_winners(hosts)
    entries = []
    n_max = 0
    for r in majority:
        pairs = next((hier_axis_pairs(a) for a in r["algos"]
                      if hier_axis_pairs(a)), None)
        native_vs_best = (r["native_p50_us"] / r["lat_p50_us"]
                          if r["native_p50_us"] and r["lat_p50_us"]
                          else 0.0)
        entries.append(SelectionEntry(
            op=r["op"], nbytes=r["nbytes"], dtype=r["dtype"],
            skew_us=r["skew_us"], imbalance=r["imbalance"],
            load=r["load"], winner=r["winner"],
            winner_p50_us=round(r["lat_p50_us"], 3),
            runner_up="", runner_up_p50_us=0.0,
            margin=round(r["margin"], 6),
            native_p50_us=round(r["native_p50_us"], 3),
            native_vs_best=round(native_vs_best, 6),
            n_devices=r["n_devices"], mesh=mesh_shape_label(pairs),
            samples=r["samples"], algos=tuple(r["algos"]),
        ))
        n_max = max(n_max, r["n_devices"])
    fingerprint = {
        "tuner_schema": TUNER_SCHEMA_VERSION,
        "device_kind": device_kind,
        "chip": _chip_of(device_kind),
        "n_devices": n_max,
        "hosts": len(hosts),
    }
    return SelectionArtifact(
        version=TUNER_SCHEMA_VERSION, generated=generated,
        generated_unix=generated_unix, fingerprint=fingerprint,
        entries=tuple(entries), source=source,
    )


# ------------------------------------------------------------ rendering


def _age(now: float, seen: float | None) -> float | None:
    return None if seen is None else max(0.0, now - seen)


def host_summaries(hosts: dict[str, HostRollup], *, now: float,
                   cfg: FleetGradeConfig,
                   sick: set[str]) -> list[dict]:
    out = []
    for host in sorted(hosts):
        roll = hosts[host]
        age = _age(now, roll.last_seen)
        out.append({
            "host": host,
            "rows": roll.rows,
            "jobs": len(roll.jobs),
            "points": len(roll.points),
            "events": roll.events_total,
            "worst_severity": roll.worst_severity,
            "chaos_injections": roll.chaos_injections,
            "links_bad": roll.links_bad_total,
            "last_seen": roll.last_seen,
            "age_s": age,
            "stale": age is None or age > cfg.stale_after,
            "sick": host in sick,
            "problems": list(roll.problems),
        })
    return out


def curves_json(hosts: dict[str, HostRollup]) -> list[dict]:
    out = []
    for host in sorted(hosts):
        for (op, nbytes, dtype, mode), stats in sorted(
                hosts[host].points.items()):
            out.append({"host": host, "op": op, "nbytes": nbytes,
                        "dtype": dtype, "mode": mode, **stats.snapshot()})
    return out


def adaptive_json(hosts: dict[str, HostRollup]) -> list[dict]:
    out = []
    for host in sorted(hosts):
        for key in sorted(hosts[host].adaptive):
            out.append({"host": host, **hosts[host].adaptive[key]})
    return out


def _fmt(v, spec=".4g"):
    return format(v, spec) if v is not None else "—"


def _age_cell(age: float | None) -> str:
    if age is None:
        return "never"
    if age < 120:
        return f"{age:.0f}s"
    if age < 7200:
        return f"{age / 60:.0f}m"
    return f"{age / 3600:.1f}h"


def hosts_to_markdown(summaries: list[dict]) -> str:
    lines = [
        "| host | rows | jobs | points | events | worst | injections "
        "| bad links | last seen | status |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for s in summaries:
        status = []
        if s["sick"]:
            status.append("SICK")
        if s["stale"]:
            status.append("STALE")
        if s["problems"]:
            status.append(f"{len(s['problems'])} read problem(s)")
        lines.append(
            f"| {s['host']} | {s['rows']} | {s['jobs']} | {s['points']} "
            f"| {s['events']} | {s['worst_severity'] or '—'} "
            f"| {s['chaos_injections']} | {s['links_bad']} "
            f"| {_age_cell(s['age_s'])} | {', '.join(status) or 'ok'} |"
        )
    return "\n".join(lines)


def curves_to_markdown(hosts: dict[str, HostRollup]) -> str:
    lines = [
        "| host | op | size | dtype | mode | runs | lat p50 (us) "
        "| lat p95 (us) | busbw p50 (GB/s) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for row in curves_json(hosts):
        lines.append(
            f"| {row['host']} | {row['op']} | {format_size(row['nbytes'])} "
            f"| {row['dtype']} | {row['mode']} | {row['runs']} "
            f"| {row['lat_us']['p50']:.2f} | {row['lat_us']['p95']:.2f} "
            f"| {row['busbw_gbps']['p50']:.4g} |"
        )
    return "\n".join(lines)


def verdicts_to_markdown(verdicts: list[HostVerdict]) -> str:
    lines = [
        "| host | op | size | dtype | mode | host p50 (us) "
        "| peer p50 (us) | rel | robust z | verdict | detail |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for v in verdicts:
        lines.append(
            f"| {v.host} | {v.op} | {format_size(v.nbytes)} | {v.dtype} "
            f"| {v.mode} | {v.lat_p50_us:.2f} | {_fmt(v.peer_p50_us, '.2f')} "
            f"| {_fmt(v.rel, '+.3g')} | {_fmt(v.mad_z, '.3g')} "
            f"| {v.verdict} | {v.detail or '—'} |"
        )
    return "\n".join(lines)


def shifts_to_markdown(shifts: list[FleetShift]) -> str:
    lines = [
        "| op | size | dtype | mode | fleet p50 (us) | baseline p50 (us) "
        "| ratio |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in shifts:
        lines.append(
            f"| {s.op} | {format_size(s.nbytes)} | {s.dtype} | {s.mode} "
            f"| {s.fleet_p50_us:.2f} | {s.baseline_p50_us:.2f} "
            f"| {s.ratio:.3g}x |"
        )
    return "\n".join(lines)


def winners_to_markdown(majority: list[dict]) -> str:
    lines = [
        "| op | size | dtype | winner | votes | fleet p50 (us) "
        "| margin | native p50 (us) | samples |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in majority:
        op = decorate_op(r["op"], skew_us=r["skew_us"],
                         imbalance=r["imbalance"], load=r["load"])
        lines.append(
            f"| {op} | {format_size(r['nbytes'])} | {r['dtype']} "
            f"| {r['winner']} | {r['votes']}/{r['hosts']} "
            f"| {r['lat_p50_us']:.2f} | {_fmt(r['margin'] or None, '.3g')} "
            f"| {_fmt(r['native_p50_us'] or None, '.2f')} "
            f"| {r['samples']} |"
        )
    return "\n".join(lines)


def disagreements_to_markdown(disagreements: list[TuneDisagreement]) -> str:
    lines = [
        "| host | op | size | dtype | local winner | fleet winner "
        "| votes |",
        "|---|---|---|---|---|---|---|",
    ]
    for d in disagreements:
        op = decorate_op(d.op, skew_us=d.skew_us,
                         imbalance=d.imbalance, load=d.load)
        lines.append(
            f"| {d.host} | {op} | {format_size(d.nbytes)} | {d.dtype} "
            f"| {d.local_winner} | {d.fleet_winner} "
            f"| {d.votes}/{d.hosts} |"
        )
    return "\n".join(lines)


def events_to_markdown(hosts: dict[str, HostRollup]) -> str:
    lines = [
        "| host | kind | severity | events | last run |",
        "|---|---|---|---|---|",
    ]
    for host in sorted(hosts):
        roll = hosts[host]
        for (kind, sev), n in sorted(roll.events.items()):
            lines.append(
                f"| {host} | {kind} | {sev} | {n} "
                f"| {roll.event_last_run.get(kind, 0)} |")
    return "\n".join(lines)


def adaptive_to_markdown(hosts: dict[str, HostRollup]) -> str:
    lines = [
        "| host | job | op | size | dtype | requested | attempted "
        "| saved | CI achieved |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    tot_req = tot_att = 0
    for row in adaptive_json(hosts):
        saved = row["runs_requested"] - row["runs_attempted"]
        tot_req += row["runs_requested"]
        tot_att += row["runs_attempted"]
        lines.append(
            f"| {row['host']} | {row['job_id'][:8]} | {row['op']} "
            f"| {format_size(row['nbytes'])} | {row['dtype']} "
            f"| {row['runs_requested']} | {row['runs_attempted']} "
            f"| {saved} | {row['ci_rel']:.2%} |"
        )
    pct = f"{(tot_req - tot_att) / tot_req:.0%}" if tot_req else "—"
    lines.append(f"| **total** | | | | | {tot_req} | {tot_att} "
                 f"| {tot_req - tot_att} ({pct}) | |")
    return "\n".join(lines)


def links_to_markdown(hosts: dict[str, HostRollup]) -> str:
    lines = [
        "| host | link | axis | rank | verdict | rel |",
        "|---|---|---|---|---|---|",
    ]
    for host in sorted(hosts):
        roll = hosts[host]
        for rec in roll.links_bad:
            lines.append(
                f"| {host} | {rec['op']} | {rec['axis']} | {rec['rank']} "
                f"| {rec['verdict']} | {_fmt(rec['rel'], '+.3g')} |")
        if roll.links_bad_total > len(roll.links_bad):
            lines.append(
                f"| {host} | … | | | | ({roll.links_bad_total} total; "
                f"worst {len(roll.links_bad)} shown) |")
    return "\n".join(lines)


# ------------------------------------------------- textfile + records


def render_fleet_textfile(summaries: list[dict], *, now: float,
                          shifts: int = 0) -> str:
    """The fleet Prometheus textfile: per-host last-seen/staleness and
    sick gauges plus fleet totals — the collector-side alerting surface
    (a host that stopped writing shows up on a graph, not in a missed
    cron mail).  Same label escaping and atomic-write contract as the
    daemon exporter (health.exporter.labels / write_textfile)."""
    from tpu_perf_torch.health.exporter import labels

    lines = []

    def family(name: str, help_: str, kind: str = "gauge") -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")

    family("tpu_perf_fleet_host_last_seen_timestamp_seconds",
           "Unix mtime of the host's newest record file (0 = no records).")
    for s in summaries:
        lines.append(
            f"tpu_perf_fleet_host_last_seen_timestamp_seconds"
            f"{labels(host=s['host'])} {(s['last_seen'] or 0.0):.3f}")
    family("tpu_perf_fleet_host_stale",
           "1 when the host has written nothing for --stale-after "
           "seconds (or ever).")
    for s in summaries:
        lines.append(f"tpu_perf_fleet_host_stale{labels(host=s['host'])} "
                     f"{int(s['stale'])}")
    family("tpu_perf_fleet_host_sick",
           "1 when cross-host MAD grading named this host slow at any "
           "point.")
    for s in summaries:
        lines.append(f"tpu_perf_fleet_host_sick{labels(host=s['host'])} "
                     f"{int(s['sick'])}")
    family("tpu_perf_fleet_host_rows_total",
           "Result rows collected from this host.", "counter")
    for s in summaries:
        lines.append(
            f"tpu_perf_fleet_host_rows_total{labels(host=s['host'])} "
            f"{s['rows']}")
    family("tpu_perf_fleet_host_events_total",
           "Health events collected from this host.", "counter")
    for s in summaries:
        lines.append(
            f"tpu_perf_fleet_host_events_total{labels(host=s['host'])} "
            f"{s['events']}")
    family("tpu_perf_fleet_hosts", "Hosts discovered in the fleet root.")
    lines.append(f"tpu_perf_fleet_hosts {len(summaries)}")
    family("tpu_perf_fleet_sick_hosts", "Hosts graded sick fleet-wide.")
    lines.append(
        f"tpu_perf_fleet_sick_hosts {sum(1 for s in summaries if s['sick'])}")
    family("tpu_perf_fleet_stale_hosts", "Hosts past the staleness bar.")
    lines.append(
        f"tpu_perf_fleet_stale_hosts "
        f"{sum(1 for s in summaries if s['stale'])}")
    family("tpu_perf_fleet_shifts",
           "Sweep points whose fleet median shifted beyond the "
           "threshold vs the baseline artifact.")
    lines.append(f"tpu_perf_fleet_shifts {shifts}")
    family("tpu_perf_fleet_last_report_timestamp_seconds",
           "Unix time of the last completed fleet report.")
    lines.append(f"tpu_perf_fleet_last_report_timestamp_seconds {now:.3f}")
    return "\n".join(lines) + "\n"
