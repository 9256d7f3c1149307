"""Live telemetry push plane (``--push``; port of ``tpu_perf/push/``):
streaming sinks for every record family, teed from the rotating-log
write boundary.  Host-only: nothing here touches the card.

The pull plane (rotate -> ingest) leaves a detection-to-operator latency
of one rotation plus one scan; this plane closes it.  The public
surface:

* :class:`PushPlane` / :data:`NULL_PUSHER` — the bounded tee queue +
  background sender (plane.py), inert-by-default like the span tracer;
* :class:`HttpSink` (NDJSON POST, per-family endpoint routing
  mirroring the Kusto table map) and :class:`TextfileSink` (live
  Prometheus meters) — sinks.py;
* the dead-letter spool riding the ingest quarantine/requeue contract
  — spool.py, replayed by `tpu-perf-torch push replay` or any healthy plane;
* :func:`plane_from_options` — the driver/CLI constructor.
"""

from tpu_perf_torch.push.plane import (  # noqa: F401
    DEFAULT_QUEUE, NULL_PUSHER, NullPusher, PUSH_THREAD_NAME, PushPlane,
)
from tpu_perf_torch.push.sinks import (  # noqa: F401
    HttpSink, METER_KEYS, PUSH_ROUTES, PushError, TEE_FREE_FAMILIES,
    TextfileSink, push_gauge_lines, push_records_once,
    render_push_textfile,
)
from tpu_perf_torch.push.spool import (  # noqa: F401
    live_spool_files, parse_spool_family, read_spool, spool_depth,
    write_spool,
)


def plane_from_options(opts, *, rank: int = 0, tracer=None, err=None):
    """The driver's (and CLI's) one constructor: NULL_PUSHER unless a
    push knob is set; the textfile sink on rank 0 only (per-rank
    writers would fight over one path, the health-exporter precedent);
    the spool next to the rotating logs."""
    if not getattr(opts, "push_url", None) \
            and not getattr(opts, "push_textfile", None):
        return NULL_PUSHER
    sinks = []
    if opts.push_url:
        sinks.append(HttpSink(opts.push_url))
    textfile = None
    if opts.push_textfile and rank == 0:
        textfile = TextfileSink(opts.push_textfile, err=err)
    return PushPlane(
        sinks,
        job_id=opts.uuid,
        rank=rank,
        spool_dir=opts.logfolder,
        maxlen=opts.push_queue or DEFAULT_QUEUE,
        textfile=textfile,
        tracer=tracer,
        err=err,
    )
