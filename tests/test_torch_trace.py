"""The port's trace joins and export (``tpu_perf_torch.trace``) against the
JAX package's (``tpu_perf.trace``) on the same span records.

The records come from the port's own chaos soaks (faults, ``--health``,
``--spans``, a daemon and a finite run); both packages' functions must
give equal results on them: the Chrome trace, its validation, the
cross-family join (complete, and the same violations once a span is
taken away), the run-span resolution, and the anomaly-context table,
also as ``report`` renders it.
"""

import glob
import io
import json

import pytest

from tpu_perf import cli as jcli
from tpu_perf import trace as jtrace

from tpu_perf_torch import cli
from tpu_perf_torch import trace as ttrace
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.faults import FaultSpec, read_ledger
from tpu_perf_torch.health.events import read_events
from tpu_perf_torch.report import read_rows
from tpu_perf_torch.spans import read_span_records

FAULTS = [FaultSpec(kind="spike", op="ring", nbytes=32, start=30, end=40,
                    magnitude=30.0),
          FaultSpec(kind="delay", op="exchange", nbytes=8, start=60,
                    end=120, magnitude=3.0),
          FaultSpec(kind="drop_run", op="ring", nbytes=8, start=41, end=50),
          FaultSpec(kind="hook_fail", start=52, end=53)]


def _soak(folder, *, sample=1, daemon=True, precompile=0):
    opts = Options(op="ring,exchange", sweep="8,32", iters=1,
                   num_runs=-1 if daemon else 40,
                   max_runs=120 if daemon else None, fence="block",
                   synthetic_s=1e-3, fault_seed=7, faults=list(FAULTS),
                   health=True, health_warmup=8, stats_every=10,
                   spans=True, spans_sample=sample, precompile=precompile,
                   logfolder=str(folder), uuid=f"job-{sample}-{daemon}",
                   device="cpu", sim_ranks=8)
    Driver(opts, err=io.StringIO()).run()
    return folder


@pytest.fixture(scope="module", params=[(1, True), (3, True), (1, False)],
                ids=["daemon", "daemon-sampled", "finite"])
def soak(request, tmp_path_factory):
    sample, daemon = request.param
    folder = _soak(tmp_path_factory.mktemp("soak"), sample=sample,
                   daemon=daemon)

    def paths(prefix):
        return sorted(glob.glob(str(folder / f"{prefix}-*.log")))

    return {
        "folder": folder,
        "spans": read_span_records(paths("spans")),
        "rows": read_rows(paths("tpu")),
        "events": read_events(paths("health")),
        "ledger": read_ledger(paths("chaos")),
    }


def test_the_chrome_trace_is_jaxs(soak):
    spans = soak["spans"]
    want = jtrace.to_chrome_trace(spans)
    assert ttrace.to_chrome_trace(spans) == want
    assert ttrace.chrome_trace_json(spans) == jtrace.chrome_trace_json(spans)
    assert ttrace.validate_chrome_trace(want) == [] == \
        jtrace.validate_chrome_trace(want)


@pytest.mark.parametrize("broken", [
    None, {}, {"traceEvents": []},
    {"traceEvents": [{"ph": "X", "name": "run"}]},
    {"traceEvents": [{"ph": "X", "name": "run", "ts": 1, "dur": -1,
                      "pid": 0, "tid": 0}]},
])
def test_validation_problems_are_jaxs(broken):
    assert ttrace.validate_chrome_trace(broken) == \
        jtrace.validate_chrome_trace(broken)


def test_every_record_joins_one_run_span(soak):
    kw = dict(rows=soak["rows"], events=soak["events"],
              ledger=soak["ledger"])
    assert soak["rows"] and soak["events"]
    assert any(r.get("record") == "fault" for r in soak["ledger"])
    assert ttrace.join_completeness(soak["spans"], **kw) == []
    assert jtrace.join_completeness(soak["spans"], **kw) == []


@pytest.mark.parametrize("drop", [0, 7, -1])
def test_a_missing_run_span_breaks_the_join_as_in_jax(soak, drop):
    runs = [s for s in soak["spans"] if s["kind"] == "run"]
    gone = runs[drop]["span_id"]
    spans = [s for s in soak["spans"] if s["span_id"] != gone]
    kw = dict(rows=soak["rows"], events=soak["events"],
              ledger=soak["ledger"])
    got = ttrace.join_completeness(spans, **kw)
    assert got == jtrace.join_completeness(spans, **kw)
    assert got  # the rows of that run no longer resolve


def test_run_span_resolution_is_jaxs(soak):
    for r in soak["rows"][::7]:
        for kw in (dict(span_id=r.span_id), dict(run_id=r.run_id, op=r.op),
                   dict(run_id=r.run_id, op=r.op, nbytes=r.nbytes)):
            got = ttrace.resolve_run_span(soak["spans"], **kw)
            assert got == jtrace.resolve_run_span(soak["spans"], **kw)
            assert len(got) >= 1


def test_anomaly_context_is_jaxs(soak):
    got = ttrace.anomaly_context(soak["events"], soak["spans"])
    assert got == jtrace.anomaly_context(soak["events"], soak["spans"])
    assert len(got) == len(soak["events"])
    assert ttrace.anomaly_to_markdown(got) == jtrace.anomaly_to_markdown(got)


def test_activity_labels_are_jaxs(soak):
    from tpu_perf.trace import export as jexp
    from tpu_perf_torch.trace import export as texp

    runs = [s for s in soak["spans"] if s["kind"] == "run"]
    for run in runs[::5]:
        got = texp.overlapping_activity(soak["spans"], run)
        assert got == jexp.overlapping_activity(soak["spans"], run)
        assert [texp.activity_label(s) for s in got] == \
            [jexp.activity_label(s) for s in got]


def test_report_renders_jaxs_anomaly_section(soak, capsys):
    folder = str(soak["folder"])
    assert cli.main(["report", folder]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["report", folder]) == 0
    want = capsys.readouterr().out
    head = "### Anomaly context"
    assert head in out
    assert out[out.index(head):] == want[want.index(head):]


def test_pipelined_builds_overlap_measures_as_jax_reads_them(tmp_path):
    """--precompile: the worker's build spans land on its own track; the
    overlap pairs are the JAX function's on the same records."""
    folder = _soak(tmp_path, daemon=False, precompile=2)
    spans = read_span_records(sorted(glob.glob(str(folder / "spans-*"))))
    workers = [s for s in spans if s["thread"] == "worker"]
    assert workers and {s["kind"] for s in workers} == {"build"}
    assert all(s["span_id"].startswith("w") for s in workers)
    got = ttrace.build_measure_overlaps(spans)
    assert got == jtrace.build_measure_overlaps(spans)
    trace = ttrace.to_chrome_trace(spans)
    tids = {e["tid"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert 1 in tids  # the precompile-worker track
    assert json.loads(ttrace.chrome_trace_json(spans)) == trace
