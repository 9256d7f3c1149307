"""Timeline export + cross-family joins over the harness span stream
(port of ``tpu_perf/trace``).

``tpu_perf_torch.spans`` records what the harness did; this package turns the
durable ``spans-*.log`` records into consumables:

* :func:`to_chrome_trace` / :func:`chrome_trace_json` — Chrome
  trace-event JSON (Perfetto-loadable) with the main thread, the
  compile-pipeline worker, and the ingest hook as separate tracks per
  rank, so the compile/measure overlap and adaptive early stops are
  visible instead of inferred from phase sums;
* :func:`validate_chrome_trace` — the structural check the CI gate runs
  on an exported artifact;
* :func:`resolve_run_span` / :func:`join_completeness` — the exact
  cross-family join: every result row, health event, and chaos ledger
  entry resolves to exactly one enclosing run span;
* :func:`anomaly_context` — the report table naming, for each health
  event, its enclosing span and any concurrent rotation/ingest/build
  activity.

Not to be confused with ``tpu_perf_torch.traceparse`` (the profiler-trace
parser): that reads the device's clock, this
reads the harness's own activity spans.
"""

from tpu_perf_torch.trace.export import (  # noqa: F401
    anomaly_context,
    anomaly_to_markdown,
    build_measure_overlaps,
    chrome_trace_json,
    join_completeness,
    resolve_run_span,
    to_chrome_trace,
    validate_chrome_trace,
)
