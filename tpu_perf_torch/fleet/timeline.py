"""Multi-process / multi-host timeline stitching with clock alignment
(port of ``tpu_perf/fleet/timeline.py``).

Span timestamps come from each process's ``perf_counter`` — an epoch
that starts roughly at process start, so two processes launched seconds
apart disagree by seconds, and two HOSTS disagree by whatever their
uptimes differ by.  Merging their spans raw (what ``tpu-perf-torch timeline``
did before this module) draws concurrent work seconds apart.

The alignment anchor is physical, not statistical: at every stats
boundary the driver's heartbeat allreduce is a cross-process barrier
every rank exits together, and the tracer wraps it in a ``heartbeat``
span carrying the boundary's ``run_id``.  Two ranks' heartbeat spans
for the same (job, run_id) therefore END at one shared instant — the
per-rank clock offset is the difference of their recorded ends, and the
median over all shared anchors rejects the per-anchor jitter (rank 0's
stderr print, scheduler noise).

Ranks with no heartbeat anchors (pre-heartbeat-span logs, or a sweep
shorter than ``stats_every``) fall back to run-span ends keyed by
(op, nbytes, run_id): on a multi-host job every measured run IS a
collective, so matching run ends are near-simultaneous too — an
approximate anchor, taken at the median, noted on stderr.  Ranks of
DIFFERENT jobs share no anchors and no clock: they are never aligned
against each other (offset 0 — each job stays on its own clock, which
is the honest statement of what is known).

In the port the heartbeat's collective is
``parallel.multihost.allreduce_times`` over ``torch.distributed`` (gloo
on the CPU, NCCL on the card): every rank leaves it together, so the
anchors are the JAX package's.
"""

from __future__ import annotations

import sys

from tpu_perf_torch.metrics import percentile


def _lane(span: dict) -> tuple:
    return (span.get("job_id"), int(span.get("rank", 0)))


def _anchor_maps(spans) -> tuple[dict, dict]:
    """Per (job, rank): heartbeat anchors {run_id: end_ns} and fallback
    run anchors {(op, nbytes, run_id): end_ns} (first span wins)."""
    hb: dict[tuple, dict] = {}
    runs: dict[tuple, dict] = {}
    for s in spans:
        kind = s.get("kind")
        if kind not in ("heartbeat", "run"):
            continue
        attrs = s.get("attrs") or {}
        end = int(s["t_start_ns"]) + int(s["dur_ns"])
        lane = _lane(s)
        if kind == "heartbeat":
            hb.setdefault(lane, {}).setdefault(attrs.get("run_id"), end)
        else:
            key = (attrs.get("op"), attrs.get("nbytes"),
                   attrs.get("run_id"))
            runs.setdefault(lane, {}).setdefault(key, end)
    return hb, runs


def clock_offsets(spans, *, err=None) -> dict[tuple, int]:
    """Per-(job_id, rank) clock offset in ns: ADD it to a lane's
    timestamps to land on the job's reference clock (its lowest rank
    carrying anchors).  Median over shared anchors; heartbeat anchors
    preferred, run-span anchors the noted fallback."""
    err = err if err is not None else sys.stderr
    hb, runs = _anchor_maps(spans)
    lanes = sorted({_lane(s) for s in spans}, key=lambda k: (str(k[0]), k[1]))
    offsets: dict[tuple, int] = {}
    by_job: dict = {}
    for lane in lanes:
        by_job.setdefault(lane[0], []).append(lane)
    for job, job_lanes in by_job.items():
        # reference: the lowest rank that has any anchors at all (a
        # rank with none cannot serve as the zero point)
        ref = next((ln for ln in job_lanes if ln in hb or ln in runs),
                   job_lanes[0])
        for lane in job_lanes:
            if lane == ref:
                offsets[lane] = 0
                continue
            deltas = [ref_end - end
                      for rid, end in hb.get(lane, {}).items()
                      if (ref_end := hb.get(ref, {}).get(rid)) is not None]
            if not deltas:
                deltas = [ref_end - end
                          for key, end in runs.get(lane, {}).items()
                          if (ref_end := runs.get(ref, {}).get(key))
                          is not None]
                if deltas:
                    print(
                        f"tpu-perf-torch: rank {lane[1]} of job "
                        f"{str(job)[:8]} has no heartbeat anchors; "
                        f"aligning on {len(deltas)} run-span end(s) "
                        "(approximate)", file=err)
            if deltas:
                offsets[lane] = int(percentile([float(d) for d in deltas],
                                               50))
            else:
                offsets[lane] = 0
                if len(job_lanes) > 1:
                    print(
                        f"tpu-perf-torch: rank {lane[1]} of job "
                        f"{str(job)[:8]} shares no anchors with rank "
                        f"{ref[1]}; left on its own clock", file=err)
    return offsets


def align_spans(spans, offsets: dict[tuple, int]) -> list[dict]:
    """Shifted copies of ``spans`` (originals untouched): each lane's
    ``t_start_ns`` moved onto its job's reference clock."""
    out = []
    for s in spans:
        off = offsets.get(_lane(s), 0)
        if off:
            s = dict(s, t_start_ns=int(s["t_start_ns"]) + off)
        out.append(s)
    return out


def stitch_hosts(host_spans: dict[str, list[dict]], *,
                 align: bool = True,
                 err=None) -> tuple[list[dict], dict[int, str]]:
    """Merge per-host span sets into one exportable stream.

    Every (host, job, rank) lane gets its own Chrome-trace process id —
    two independent hosts both running rank 0 must not collapse into
    one track — with a ``host/rank N`` process name.  Within each job
    (a multi-host job's ranks span host folders) clocks are aligned via
    :func:`clock_offsets` first; independent jobs keep their own
    clocks.  Returns ``(spans, process_names)`` for
    ``trace.to_chrome_trace(spans, process_names=...)``."""
    merged: list[tuple[str, dict]] = []
    for host in sorted(host_spans):
        merged.extend((host, s) for s in host_spans[host])
    if align:
        flat = [s for _, s in merged]
        aligned = align_spans(flat, clock_offsets(flat, err=err))
        merged = [(h, s) for (h, _), s in zip(merged, aligned)]
    lanes = sorted({(h, *_lane(s)) for h, s in merged},
                   key=lambda k: (k[0], str(k[1]), k[2]))
    pid_of = {lane: i for i, lane in enumerate(lanes)}
    names = {i: f"{lane[0]}/rank {lane[2]}"
             for i, lane in enumerate(lanes)}
    out = [dict(s, rank=pid_of[(h, *_lane(s))]) for h, s in merged]
    return out, names
