"""Push-plane sinks (port of ``tpu_perf/push/sinks.py``): where teed
records go, live.

The pull plane (tpu_perf_torch.ingest) ships *finished files* on rotation; a
detector that fires at t cannot reach an operator until the next
rotation + cron scan.  The push plane tees each record at the
rotating-log **write boundary** (driver.RotatingCsvLog) into a bounded
queue (tpu_perf_torch.push.plane) whose background sender delivers batches
through the sinks here:

* :class:`HttpSink` — NDJSON POST over stdlib urllib, one endpoint per
  record family.  :data:`PUSH_ROUTES` mirrors the Kusto table map the
  ingest pipeline routes finished files by (pipeline.KustoBackend), so
  the live path and the batch path land records in the SAME logical
  tables — a collector behind the endpoint needs no second routing
  convention.
* :class:`TextfileSink` — a live Prometheus textfile of the plane's
  own meters plus per-family delivery counters, refreshed every sender
  cycle instead of once per rotation (the node-exporter textfile
  convention the health exporter already follows).

The chaos ledger (schema.CHAOS_PREFIX) is deliberately absent from the
routing map: its byte-identity contract (same seed + spec => identical
``chaos-*.log``) is the determinism proof every CI gate diffs, and a
tee is an observable the contract must not depend on.
:data:`TEE_FREE_FAMILIES` declares that exclusion: every family in
schema.ALL_PREFIXES must either route here or be declared tee-free, so a
new family cannot ship half-wired, and a tee-free family can never gain
a route by accident.
"""

from __future__ import annotations

import sys
import urllib.request

from tpu_perf_torch.health.exporter import labels, write_textfile
from tpu_perf_torch.ingest.pipeline import (
    FLEET_TABLE, HEALTH_TABLE, LINKMAP_TABLE, SPANS_TABLE, TPU_TABLE,
    TUNE_TABLE,
)
from tpu_perf_torch.schema import (
    CHAOS_PREFIX, EXT_PREFIX, FLEET_PREFIX, HEALTH_PREFIX, LEGACY_PREFIX,
    LINKMAP_PREFIX, SPANS_PREFIX, TUNE_PREFIX,
)

#: family prefix -> endpoint table name, mirroring the ingest
#: pipeline's per-family Kusto routing (KustoBackend.ingest) so the
#: live and batch paths share one table convention.  Every family of
#: schema.ALL_PREFIXES routes here or is tee-free.
PUSH_ROUTES = {
    LEGACY_PREFIX: "PerfLogsMPI",  # the reference's default table
    EXT_PREFIX: TPU_TABLE,
    HEALTH_PREFIX: HEALTH_TABLE,
    LINKMAP_PREFIX: LINKMAP_TABLE,
    SPANS_PREFIX: SPANS_TABLE,
    FLEET_PREFIX: FLEET_TABLE,
    TUNE_PREFIX: TUNE_TABLE,
}

#: families that must NEVER tee: the chaos ledger's byte-identity
#: contract is the determinism proof, and the push plane must be
#: provably absent from it.
TEE_FREE_FAMILIES = (CHAOS_PREFIX,)


class PushError(RuntimeError):
    """A sink could not deliver a batch (retried by the sender)."""


class HttpSink:
    """NDJSON HTTP POST per family: ``<base>/v1/<Table>``.

    Stdlib urllib only (the no-new-deps contract); one request per
    batch, ``Content-Type: application/x-ndjson``, the family prefix
    echoed in a header so a generic collector can route without
    parsing the path.  Any non-2xx / connection / timeout failure
    raises — the sender owns retry, backoff, and the dead-letter
    spool; the sink stays a dumb pipe.  Delivery is at-least-once: a
    batch that failed AFTER the server processed it is re-sent, so
    collectors should key on the records' own identity columns
    (job_id, rank, run_id / span_id), which every family carries.
    """

    def __init__(self, base_url: str, *, timeout: float = 5.0,
                 routes: dict[str, str] | None = None):
        if not base_url:
            raise ValueError("HttpSink needs a base URL")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.routes = dict(PUSH_ROUTES if routes is None else routes)

    def endpoint(self, family: str) -> str:
        table = self.routes.get(family)
        if table is None:
            raise PushError(
                f"no push route for family {family!r} (routes: "
                f"{sorted(self.routes)}) — a tee-free family can never "
                "be sent, and a new family must be added to PUSH_ROUTES"
            )
        return f"{self.base_url}/v1/{table}"

    def send(self, family: str, lines: list[str]) -> None:
        data = ("\n".join(lines) + "\n").encode()
        req = urllib.request.Request(
            self.endpoint(family),
            data=data,
            headers={
                "Content-Type": "application/x-ndjson",
                "X-TpuPerf-Family": family,
            },
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                status = getattr(resp, "status", 200)
                if status >= 300:
                    raise PushError(
                        f"{self.endpoint(family)} answered {status}")
        except PushError:
            raise
        except Exception as e:  # noqa: BLE001 — URLError, HTTPError,
            # socket timeouts, connection resets: all one retryable
            # delivery failure to the sender
            raise PushError(f"{self.endpoint(family)}: {e}") from e

    def describe(self) -> str:
        return self.base_url


#: cumulative meter keys the plane reports (heartbeat / sidecar /
#: exporter all render this one shape — one spelling, every surface)
METER_KEYS = ("sent", "dropped", "retried", "spooled", "replayed")


def push_gauge_lines(totals: dict) -> list[str]:
    """The plane's self-observation as Prometheus lines — shared by the
    live :class:`TextfileSink` and the health exporter's textfile
    (health.exporter.render_textfile), so a dashboard alerting on
    ``tpu_perf_push_dropped_total`` reads one metric name whichever
    file its collector scrapes."""
    lines = [
        "# HELP tpu_perf_push_sent_total Records delivered live through "
        "the push plane since start.",
        "# TYPE tpu_perf_push_sent_total counter",
        f"tpu_perf_push_sent_total {int(totals.get('sent', 0))}",
        "# HELP tpu_perf_push_dropped_total Records dropped at the "
        "bounded tee queue (overflow — counted, never silent).",
        "# TYPE tpu_perf_push_dropped_total counter",
        f"tpu_perf_push_dropped_total {int(totals.get('dropped', 0))}",
        "# HELP tpu_perf_push_retried_total Failed delivery attempts "
        "(each retried with jittered exponential backoff).",
        "# TYPE tpu_perf_push_retried_total counter",
        f"tpu_perf_push_retried_total {int(totals.get('retried', 0))}",
        "# HELP tpu_perf_push_spooled_total Records dead-lettered to "
        "the on-disk spool after exhausted retries.",
        "# TYPE tpu_perf_push_spooled_total counter",
        f"tpu_perf_push_spooled_total {int(totals.get('spooled', 0))}",
        "# HELP tpu_perf_push_replayed_total Spooled records replayed "
        "to a revived sink.",
        "# TYPE tpu_perf_push_replayed_total counter",
        f"tpu_perf_push_replayed_total {int(totals.get('replayed', 0))}",
        "# HELP tpu_perf_push_queued Records currently waiting in the "
        "tee queue + the sender's pending batches.",
        "# TYPE tpu_perf_push_queued gauge",
        f"tpu_perf_push_queued {int(totals.get('queued', 0))}",
        "# HELP tpu_perf_push_spool_depth Dead-letter spool files on "
        "disk (live + quarantined).",
        "# TYPE tpu_perf_push_spool_depth gauge",
        f"tpu_perf_push_spool_depth {int(totals.get('spool_depth', 0))}",
        "# HELP tpu_perf_push_backoff 1 while the sender is backing "
        "off a failing sink, else 0.",
        "# TYPE tpu_perf_push_backoff gauge",
        f"tpu_perf_push_backoff {int(totals.get('backoff', 0))}",
    ]
    return lines


def render_push_textfile(sent_by_family: dict[str, int],
                         totals: dict) -> str:
    """The live textfile's full contents: the shared gauge block plus
    per-family delivery counters (which family a stalled pipeline is
    starving is the first triage question)."""
    lines = push_gauge_lines(totals)
    lines.append("# HELP tpu_perf_push_family_sent_total Records "
                 "delivered per rotating family.")
    lines.append("# TYPE tpu_perf_push_family_sent_total counter")
    for family, n in sorted(sent_by_family.items()):
        lines.append(
            f"tpu_perf_push_family_sent_total{labels(family=family)} {n}"
        )
    return "\n".join(lines) + "\n"


class TextfileSink:
    """Atomic writer for the plane's live Prometheus textfile —
    refreshed every sender cycle, not once per rotation, so the
    exporter surface follows the fleet in near-real time.  Never
    raises into the sender (a full disk must not take the delivery
    path down with it)."""

    def __init__(self, path: str, *, err=None):
        self.path = path
        self.err = err

    def _stream(self):
        return self.err if self.err is not None else sys.stderr

    def write(self, sent_by_family: dict[str, int], totals: dict) -> None:
        try:
            write_textfile(self.path,
                           render_push_textfile(sent_by_family, totals))
        except OSError as e:
            print(f"[tpu-perf-torch push] textfile write failed: {e}",
                  file=self._stream(), flush=True)


def push_records_once(url: str, family: str, lines: list[str], *,
                      err=None, timeout: float = 5.0) -> bool:
    """One-shot synchronous push for the CLI record writers (linkmap
    sweeps, fleet reports): the records are already durable on disk, so
    a delivery failure is reported — loudly — and never fatal, and no
    spool is involved (re-running the command re-pushes)."""
    stream = err if err is not None else sys.stderr
    if not lines:
        return True
    try:
        HttpSink(url, timeout=timeout).send(family, lines)
        return True
    except Exception as e:  # noqa: BLE001 — one-shot: report, never raise
        print(f"[tpu-perf-torch push] could not push {len(lines)} {family} "
              f"record(s) to {url}: {e} (records remain on disk)",
              file=stream, flush=True)
        return False
