"""Linkmap rendering + replay: heatmap, matrix table, JSON artifact (copy
of ``tpu_perf/linkmap/report.py``).

Operates on plain record dicts (the ``linkmap-*.log`` JSONL shapes), so
a live ``tpu-perf-torch linkmap`` run and a ``linkmap report``
replay of the durable logs render through exactly one code path — the
same live/replay contract the health events follow.
"""

from __future__ import annotations

import json
import os
import sys

from tpu_perf_torch.health.events import read_jsonl
from tpu_perf_torch.linkmap.probe import LinkmapRecord
# the one None-as-em-dash cell formatter: a placeholder-rendering change
# must hit every table at once
from tpu_perf_torch.report import _fmt

#: heatmap cell glyphs, one per verdict (``·`` = link not probed)
HEATMAP_GLYPHS = {"ok": "o", "slow": "S", "dead": "D"}


def read_linkmap(paths, *, err=None) -> tuple[dict, list[dict], list[dict]]:
    """Parse linkmap JSONL records from files; returns
    ``(meta, probe_records, verdict_records)``.

    Torn-final-line policy shared with every JSONL family
    (health.events.read_jsonl).  A fleet log folder accumulates one
    linkmap file per sweep (rotation never deletes them without a real
    ingest backend), so multiple sweeps are the NORMAL directory state,
    not an error: records are grouped per sweep by the meta's job_id
    (probe/verdict rows live in their sweep's own file by construction)
    and the NEWEST sweep — by file mtime — is replayed, with a note
    naming how many older sweeps were skipped.  Files of one sweep
    whose metas disagree (a multi-rank sweep gone inconsistent) still
    refuse the garbage join, like the chaos conformance reader."""
    by_job: dict[str, dict] = {}
    for path in paths:
        records = [r.data for r in read_jsonl(
            [path], LinkmapRecord.from_json, err=err)]
        metas = [r for r in records if r.get("record") == "meta"]
        if not metas:
            raise ValueError(
                f"no meta record in {path} — was it written by "
                "`tpu-perf-torch linkmap`?"
            )
        if len({json.dumps(m, sort_keys=True) for m in metas}) > 1:
            raise ValueError(
                f"{path} holds disagreeing meta records — not one sweep's "
                "file"
            )
        job = str(metas[0].get("job_id"))
        slot = by_job.setdefault(job, {"meta": metas[0], "records": [],
                                       "mtime": 0.0})
        if json.dumps(slot["meta"], sort_keys=True) != \
                json.dumps(metas[0], sort_keys=True):
            raise ValueError(
                f"sweep {job} has disagreeing meta records across files"
            )
        slot["records"].extend(records)
        try:
            slot["mtime"] = max(slot["mtime"], os.path.getmtime(path))
        except OSError:
            pass
    if not by_job:
        raise ValueError(
            "no meta record in the linkmap logs — were these written by "
            "`tpu-perf-torch linkmap`?"
        )
    job, slot = max(by_job.items(), key=lambda kv: kv[1]["mtime"])
    if len(by_job) > 1:
        print(
            f"tpu-perf-torch: {len(by_job)} linkmap sweeps found; "
            f"replaying the newest (job {job}) — name one sweep's file to "
            "replay an older one",
            file=err if err is not None else sys.stderr,
        )
    records = slot["records"]
    probes = [r for r in records if r.get("record") == "probe"]
    verdicts = [r for r in records if r.get("record") == "verdict"]
    return slot["meta"], probes, verdicts


def heatmap(n: int, verdicts: list[dict]) -> str:
    """The N×N ASCII link matrix (rows = source device, columns =
    destination): ``o`` ok, ``S`` slow, ``D`` dead, ``·`` not probed.
    Column indices render mod 10 so wide fabrics stay aligned."""
    cells = [["·"] * n for _ in range(n)]
    for v in verdicts:
        cells[v["src"]][v["dst"]] = HEATMAP_GLYPHS.get(v["verdict"], "?")
    lines = ["src\\dst " + " ".join(str(d % 10) for d in range(n))]
    for s in range(n):
        lines.append(f"{s:>7} " + " ".join(cells[s]))
    lines.append("(o ok, S slow, D dead, · unprobed)")
    return "\n".join(lines)


def verdicts_to_markdown(verdicts: list[dict]) -> str:
    """The per-link verdict table, worst news first then link order."""
    order = {"dead": 0, "slow": 1, "ok": 2}
    rows = sorted(verdicts, key=lambda v: (
        order.get(v["verdict"], 3), v["src"], v["dst"]))
    lines = [
        "| link | axis | rank | host | lat mean (us) | bw (GB/s) "
        "| roofline | MAD z | verdict | detail |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for v in rows:
        frac = v.get("roofline_frac")
        lines.append(
            f"| {v['op']} | {v['axis']} | {v['rank']} | {v['host']} "
            f"| {_fmt(v.get('lat_us'), '.4g')} "
            f"| {_fmt(v.get('bw_gbps'), '.4g')} "
            f"| {_fmt(None if frac is None else 100 * frac, '.3g')}"
            f"{'' if frac is None else '%'} "
            f"| {_fmt(v.get('mad_z'), '.3g')} | {v['verdict']} "
            f"| {v.get('detail', '')} |"
        )
    return "\n".join(lines)


def summary_line(verdicts: list[dict]) -> str:
    counts = {"ok": 0, "slow": 0, "dead": 0}
    for v in verdicts:
        counts[v["verdict"]] = counts.get(v["verdict"], 0) + 1
    total = len(verdicts)
    if total and counts["ok"] == total:
        return f"all {total} link(s) ok."
    sick = [v for v in verdicts if v["verdict"] != "ok"]
    named = "; ".join(
        f"{v['op']} {v['verdict']} (rank {v['rank']}, {v['host']})"
        for v in sick[:4]
    )
    more = "" if len(sick) <= 4 else f" (+{len(sick) - 4} more)"
    return (
        f"{total} link(s): {counts['ok']} ok, {counts['slow']} slow, "
        f"{counts['dead']} dead — {named}{more}"
    )


def linkmap_to_markdown(meta: dict, verdicts: list[dict]) -> str:
    shape = "x".join(str(s) for s in meta.get("shape", []))
    head = (
        f"linkmap: {meta.get('mode', 'neighbor')} sweep over {meta['n']} "
        f"device(s) ({shape or 'flat'}), {meta['nbytes']} B x "
        f"{meta['iters']} iter(s) x {meta['runs']} run(s), "
        f"fence {meta['fence']}"
        + (", synthetic" if meta.get("synthetic") else "")
    )
    return "\n\n".join([
        head,
        heatmap(meta["n"], verdicts),
        verdicts_to_markdown(verdicts),
        summary_line(verdicts),
    ])


def linkmap_to_json(meta: dict, probes: list[dict],
                    verdicts: list[dict], *,
                    diff: dict | None = None) -> str:
    """The machine artifact: meta + raw probe rows + verdicts, one
    object (the linkmap analogue of ``report --format json``).  The ONE
    definition of the artifact shape — ``load_linkmap_artifact``
    validates ``--diff`` baselines against exactly this writer.
    ``diff`` appends a cross-sweep diff block (``linkmap report
    --diff``) without changing the base shape, so a diffed report's
    output is itself a valid future baseline."""
    data: dict = {"meta": meta, "probes": probes, "verdicts": verdicts}
    if diff is not None:
        data["diff"] = diff
    return json.dumps(data, indent=2)


# --- cross-sweep diffing (`linkmap report --diff BASE`) ---------------


def load_linkmap_artifact(path: str) -> tuple[dict, list[dict]]:
    """Read a ``linkmap --format json`` artifact back as ``(meta,
    verdicts)`` — the baseline side of a cross-sweep diff.  Anything
    that is not that artifact shape raises (a typo'd baseline must
    never silently diff against nothing)."""
    with open(path) as fh:
        try:
            data = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path!r} is not JSON: {e}") from None
    if not isinstance(data, dict) or not isinstance(data.get("meta"), dict) \
            or not isinstance(data.get("verdicts"), list):
        raise ValueError(
            f"{path!r} is not a `tpu-perf-torch linkmap --format json` "
            "artifact (need meta + verdicts keys)"
        )
    return data["meta"], data["verdicts"]


def diff_linkmaps(base: list[dict], new: list[dict], *,
                  threshold_pct: float = 30.0) -> list[dict]:
    """Pair two sweeps' per-link verdicts on the directed-link key
    ``(axis, src, dst)`` and judge each link's mean latency drift.

    This is the gate that catches a slowly-dying link BETWEEN soaks: a
    hop degraded 30% since the last sweep can still sit comfortably
    inside its own sweep's MAD band (every peer is healthy, the excess
    is under ``rel_threshold``) — only the cross-sweep comparison sees
    the trend, and on a (dcn, ici) mesh it is the slow-axis hop, with
    its wide healthy band, that dies this way.

    Verdict per link: ``degraded`` (latency rose more than
    ``threshold_pct``, or the link died since the base sweep),
    ``improved`` (fell more than the threshold), ``ok`` (within it),
    ``incomparable`` (either side has no surviving latency),
    ``base-only`` / ``new-only`` (coverage changed).  The caller gates
    on ``degraded``."""
    if threshold_pct <= 0:
        raise ValueError(
            f"threshold_pct must be positive, got {threshold_pct}"
        )

    def key(v: dict):
        return (v.get("axis"), v.get("src"), v.get("dst"))

    base_by = {key(v): v for v in base}
    new_by = {key(v): v for v in new}
    out = []
    for k in sorted(set(base_by) | set(new_by),
                    key=lambda t: (str(t[0]), t[1] or 0, t[2] or 0)):
        bv, nv = base_by.get(k), new_by.get(k)
        some = nv or bv
        row = {
            "op": some.get("op"), "axis": k[0], "src": k[1], "dst": k[2],
            "base_lat_us": None if bv is None else bv.get("lat_us"),
            "new_lat_us": None if nv is None else nv.get("lat_us"),
            "base_verdict": None if bv is None else bv.get("verdict"),
            "new_verdict": None if nv is None else nv.get("verdict"),
            "delta_pct": None,
        }
        if bv is None or nv is None:
            row["diff"] = "new-only" if bv is None else "base-only"
        elif nv.get("verdict") == "dead" and bv.get("verdict") != "dead":
            # a link with no surviving samples has no latency to diff,
            # but dying since the base sweep IS the degradation
            row["diff"] = "degraded"
            row["detail"] = "died since the base sweep"
        elif not row["base_lat_us"] or row["new_lat_us"] is None:
            row["diff"] = "incomparable"
        else:
            delta = (row["new_lat_us"] - row["base_lat_us"]) \
                / row["base_lat_us"] * 100.0
            row["delta_pct"] = delta
            if delta > threshold_pct:
                row["diff"] = "degraded"
                row["detail"] = (f"+{delta:.3g}% latency vs the base "
                                 f"sweep (gate {threshold_pct:g}%)")
            elif delta < -threshold_pct:
                row["diff"] = "improved"
            else:
                row["diff"] = "ok"
        row.setdefault("detail", "")
        out.append(row)
    return out


def linkdiff_to_markdown(diffs: list[dict]) -> str:
    """The cross-sweep diff table, worst news first then link order."""
    order = {"degraded": 0, "base-only": 1, "new-only": 1,
             "incomparable": 2, "improved": 3, "ok": 4}
    rows = sorted(diffs, key=lambda d: (
        order.get(d["diff"], 5), str(d["axis"]), d["src"] or 0,
        d["dst"] or 0))
    lines = [
        "| link | axis | base lat (us) | new lat (us) | Δ% "
        "| base/new verdict | diff | detail |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for d in rows:
        lines.append(
            f"| {d['op']} | {d['axis']} "
            f"| {_fmt(d['base_lat_us'], '.4g')} "
            f"| {_fmt(d['new_lat_us'], '.4g')} "
            f"| {_fmt(d['delta_pct'], '+.1f')} "
            f"| {d['base_verdict'] or '—'}/{d['new_verdict'] or '—'} "
            f"| {d['diff']} | {d.get('detail', '')} |"
        )
    return "\n".join(lines)


def linkdiff_summary(diffs: list[dict], threshold_pct: float) -> str:
    degraded = [d for d in diffs if d["diff"] == "degraded"]
    if not degraded:
        return (f"link diff: {len(diffs)} link(s) compared, none "
                f"degraded > {threshold_pct:g}% vs the base sweep.")
    named = "; ".join(
        f"{d['op']} ({d.get('detail') or 'degraded'})"
        for d in degraded[:4]
    )
    more = "" if len(degraded) <= 4 else f" (+{len(degraded) - 4} more)"
    return (f"link diff: {len(degraded)} of {len(diffs)} link(s) "
            f"degraded > {threshold_pct:g}% vs the base sweep — "
            f"{named}{more}")
