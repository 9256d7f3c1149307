"""Fleet observability plane (port of ``tpu_perf/fleet``): the first
instrument that sees the fleet instead of a host.

* :mod:`tpu_perf_torch.fleet.collect` — streaming readers over N hosts'
  record folders (bounded memory; live tails, torn lines, rotation
  races, and quarantined files tolerated);
* :mod:`tpu_perf_torch.fleet.rollup` — per-(host, op, size) streaming
  percentiles, cross-host robust-z grading (the linkmap MAD machinery
  at host granularity), fleet-wide shift detection vs a baseline
  artifact, staleness, and the ``fleet-*.log`` seventh rotating family;
* :mod:`tpu_perf_torch.fleet.timeline` — clock-offset alignment anchored on
  the heartbeat collectives' shared boundaries, and multi-host span
  stitching for one Perfetto view;
* :mod:`tpu_perf_torch.fleet.report` — the `tpu-perf-torch fleet report`
  orchestration (markdown / JSON artifact / Prometheus textfile /
  rollup records in one pass).
"""

from tpu_perf_torch.fleet.collect import (  # noqa: F401
    discover_hosts, last_seen, stream_jsonl, stream_parsed, stream_rows,
)
from tpu_perf_torch.fleet.drain import (  # noqa: F401
    DRAIN_STATE_FILE, DrainOutcome, load_drain_state, run_drain_hooks,
    save_drain_state,
)
from tpu_perf_torch.fleet.report import (  # noqa: F401
    FleetReport, build_report, fleet_records, read_fleet_records,
    render_textfile, report_to_json, report_to_markdown,
    write_fleet_records,
)
from tpu_perf_torch.fleet.rollup import (  # noqa: F401
    FleetGradeConfig, FleetRecord, FleetShift, HostRollup, HostVerdict,
    detect_shifts, fleet_medians, grade_hosts, load_baseline_artifact,
    render_fleet_textfile,
)
from tpu_perf_torch.fleet.timeline import (  # noqa: F401
    align_spans, clock_offsets, stitch_hosts,
)
