"""The live telemetry push plane (``tpu_perf_torch.push``) against the JAX
package's.

The plane is host-only Python: a bounded tee queue a background thread
drains to NDJSON HTTP endpoints (``URL/v1/<Table>``), retrying with
jittered exponential backoff and dead-lettering what it cannot deliver
to a spool beside the logs.  Here it is driven by hand (``_cycle`` under
an injected clock) and through the driver into a loopback
``http.server``: a zero-drop soak delivers every durable row and span,
overflow drops are counted, the spool -> ``ingest --requeue`` -> ``push
replay`` round trip loses nothing, the chaos ledger is byte-identical
with the plane on and off (it is never teed), and the gauges, routes,
spool names, textfile and report table are the JAX package's.
"""

import glob
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import tpu_perf.push as jpush
from tpu_perf.report import push_to_markdown as jpush_md

from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.faults import FaultSpec
from tpu_perf_torch.ingest.pipeline import (
    QUARANTINE_SUFFIX, list_quarantined, requeue_quarantined,
)
from tpu_perf_torch.push import (
    DEFAULT_QUEUE, NULL_PUSHER, PUSH_ROUTES, TEE_FREE_FAMILIES, HttpSink,
    PushError, PushPlane, live_spool_files, parse_spool_family,
    plane_from_options, push_gauge_lines, read_spool, render_push_textfile,
    spool_depth, write_spool,
)
from tpu_perf_torch.push import spool as spool_mod
from tpu_perf_torch.report import push_to_markdown
from tpu_perf_torch.schema import (
    ALL_PREFIXES, CHAOS_PREFIX, EXT_PREFIX, HEALTH_PREFIX, LEGACY_PREFIX,
    SPANS_PREFIX,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class ListSink:
    """An in-process sink with a switchable outage."""

    def __init__(self):
        self.fail = False
        self.batches = []

    def send(self, family, lines):
        if self.fail:
            raise PushError("sink down")
        self.batches.append((family, list(lines)))

    @property
    def lines(self):
        return [ln for _, batch in self.batches for ln in batch]


def _plane(tmp_path, sink=None, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("jitter", lambda: 0.5)  # the jitter factor pinned to 1
    return PushPlane([sink] if sink is not None else [], job_id="job-p",
                     rank=0, spool_dir=str(tmp_path), start=False,
                     err=io.StringIO(), **kw)


class _Collector:
    """A loopback http.server sink: every NDJSON POST kept per (path,
    family header); it can refuse (500) or tear the connection."""

    def __init__(self):
        self.got = {}
        self.mode = "ok"
        collector = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode()
                if collector.mode == "tear":
                    self.connection.close()
                    return
                if collector.mode == "refuse":
                    self.send_response(500)
                    self.end_headers()
                    return
                fam = self.headers.get("X-TpuPerf-Family", "?")
                collector.got.setdefault((self.path, fam), []).extend(
                    body.splitlines())
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def lines(self, family):
        return [ln for (_, fam), v in self.got.items() if fam == family
                for ln in v]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture()
def collector():
    c = _Collector()
    yield c
    c.close()


# --- the plane, by hand ---------------------------------------------------


def test_the_null_pusher_is_inert():
    assert NULL_PUSHER.enabled is False
    assert NULL_PUSHER.tee_for(EXT_PREFIX) is None
    NULL_PUSHER.tee(EXT_PREFIX, "row")
    assert NULL_PUSHER.totals() is None
    assert plane_from_options(Options(op="ring")) is NULL_PUSHER


def test_overflow_drops_are_counted_and_noted(tmp_path):
    p = _plane(tmp_path, ListSink(), maxlen=5, drop_note_every=1000)
    for i in range(8):
        p.tee(EXT_PREFIX, f"row{i}")
    t = p.totals()
    assert t["dropped"] == 3 and t["queued"] == 5
    assert "queue full" in p.err.getvalue()
    p.close()


def test_the_chaos_ledger_is_never_teed(tmp_path):
    p = _plane(tmp_path, ListSink())
    assert p.tee_for(CHAOS_PREFIX) is None
    p.tee(CHAOS_PREFIX, "ledger-line")
    p._cycle()
    assert p.totals()["sent"] == 0 and p.totals()["queued"] == 0
    p.close()


def test_delivery_batches_per_family(tmp_path):
    sink = ListSink()
    p = _plane(tmp_path, sink)
    for fam, line in ((EXT_PREFIX, "a"), (HEALTH_PREFIX, "h"),
                      (EXT_PREFIX, "b")):
        p.tee(fam, line)
    p._cycle()
    assert sorted(sink.batches) == [(HEALTH_PREFIX, ["h"]),
                                    (EXT_PREFIX, ["a", "b"])]
    assert p.totals()["sent"] == 3
    p.close()


def test_the_backoff_schedule_is_jaxs(tmp_path):
    # the same outage through both planes: the same delays, doubled from
    # 0.25 s and capped, and the same meters
    def delays(plane_cls, sink_err):
        class Sink:
            fail = True

            def send(self, family, lines):
                if self.fail:
                    raise sink_err("down")

        sink, clk = Sink(), FakeClock()
        p = plane_cls([sink], job_id="j", spool_dir=str(tmp_path),
                      start=False, err=io.StringIO(), clock=clk,
                      jitter=lambda: 0.5, max_attempts=10, backoff_max=0.8)
        p.tee(EXT_PREFIX, "a")
        out = []
        for _ in range(4):
            p._cycle()
            out.append(round(p._next_try - clk.t, 6))
            clk.t = p._next_try
        sink.fail = False
        p._cycle()
        meters = p.totals()
        p.close()
        return out, {k: meters[k] for k in ("sent", "retried", "dropped")}

    assert delays(PushPlane, PushError) == \
        delays(jpush.PushPlane, jpush.PushError) == \
        ([0.25, 0.5, 0.8, 0.8], {"sent": 1, "retried": 4, "dropped": 0})


def test_exhausted_retries_dead_letter_and_a_requeue_replays(tmp_path):
    sink = ListSink()
    sink.fail = True
    clk = FakeClock()
    p = _plane(tmp_path, sink, clock=clk, max_attempts=3)
    p.tee(EXT_PREFIX, "a")
    p.tee(EXT_PREFIX, "b")
    for _ in range(3):
        p._cycle()
        clk.t = max(clk.t, p._next_try)
    t = p.totals()
    assert t["spooled"] == 2 and t["spool_depth"] == 1
    (path,) = list_quarantined(str(tmp_path))
    assert parse_spool_family(path) == EXT_PREFIX
    assert read_spool(path) == ["a", "b"]
    assert live_spool_files(str(tmp_path)) == []
    assert len(requeue_quarantined(str(tmp_path))) == 1
    sink.fail = False
    clk.t += 1000.0
    p._cycle()
    t = p.totals()
    assert t["replayed"] == 2 and t["sent"] == 2 and t["spool_depth"] == 0
    p.close()


def test_close_flushes_then_spools_the_rest(tmp_path):
    sink = ListSink()
    p = _plane(tmp_path, sink)
    p.tee(EXT_PREFIX, "flushed")
    p.close()
    assert sink.lines == ["flushed"]
    down = ListSink()
    down.fail = True
    p2 = _plane(tmp_path, down)
    p2.tee(EXT_PREFIX, "stranded")
    p2.close()
    assert p2.totals()["spooled"] == 1


def test_the_routes_partition_every_family():
    for fam in ALL_PREFIXES:
        assert (fam in PUSH_ROUTES) != (fam in TEE_FREE_FAMILIES)
    assert TEE_FREE_FAMILIES == jpush.TEE_FREE_FAMILIES == (CHAOS_PREFIX,)
    # the port's families route to the JAX package's tables
    for fam, table in PUSH_ROUTES.items():
        assert jpush.PUSH_ROUTES[fam] == table
    assert DEFAULT_QUEUE == jpush.DEFAULT_QUEUE


def test_the_http_sink_routes_and_retries_as_jaxs(collector):
    sink = HttpSink(collector.url)
    sink.send(EXT_PREFIX, ["row1", "row2"])
    sink.send(HEALTH_PREFIX, ['{"kind":"spike"}'])
    assert collector.got[("/v1/PerfLogsTPU", EXT_PREFIX)] == ["row1", "row2"]
    assert collector.got[("/v1/HealthEventsTPU", HEALTH_PREFIX)] == [
        '{"kind":"spike"}']
    assert sink.endpoint(SPANS_PREFIX) == \
        jpush.HttpSink(collector.url).endpoint(SPANS_PREFIX)
    with pytest.raises(PushError, match="no push route"):
        sink.endpoint(CHAOS_PREFIX)
    for mode in ("refuse", "tear"):
        collector.mode = mode
        with pytest.raises(PushError):
            sink.send(EXT_PREFIX, ["r"])


@pytest.mark.parametrize("totals", [
    {}, {"sent": 7, "dropped": 1, "retried": 2, "spooled": 3,
         "replayed": 4, "queued": 5, "spool_depth": 6, "backoff": 1}])
def test_the_gauges_and_the_textfile_are_jaxs(totals):
    assert push_gauge_lines(totals) == jpush.push_gauge_lines(totals)
    fams = {EXT_PREFIX: 7, HEALTH_PREFIX: 2}
    assert render_push_textfile(fams, totals) == \
        jpush.render_push_textfile(fams, totals)


def test_the_spool_names_are_jaxs(tmp_path):
    name = spool_mod.spool_name(SPANS_PREFIX, "job-a-b", 3, 12)
    assert name == jpush.spool.spool_name(SPANS_PREFIX, "job-a-b", 3, 12)
    assert parse_spool_family(name) == SPANS_PREFIX
    assert parse_spool_family(name + QUARANTINE_SUFFIX) == SPANS_PREFIX
    assert parse_spool_family("tpu-job-0-x.log") is None
    a = write_spool(str(tmp_path), EXT_PREFIX, "j", 0, ["a"], seq=1)
    b = write_spool(str(tmp_path), EXT_PREFIX, "j", 0, ["b"], seq=1)
    assert a != b and read_spool(a) == ["a"] and read_spool(b) == ["b"]
    assert spool_depth(str(tmp_path)) == jpush.spool_depth(str(tmp_path))
    assert sorted(list_quarantined(str(tmp_path))) == sorted([a, b])


@pytest.mark.parametrize("kw", [
    dict(push_queue=50), dict(push_queue=-1, push_url="http://x"),
    dict(push_queue=50, push_textfile="x.prom"),
])
def test_the_push_options_refuse_as_jaxs(kw):
    from tpu_perf.config import Options as JOptions

    with pytest.raises(ValueError) as ours:
        Options(op="ring", **kw)
    with pytest.raises(ValueError) as theirs:
        JOptions(op="ring", **kw)
    assert str(ours.value) == str(theirs.value)


def test_the_push_plane_refuses_the_c_backend():
    with pytest.raises(ValueError, match="torch driver's record plane"):
        Options(op="allreduce", backend="mpi", push_url="http://x")


# --- through the driver ----------------------------------------------------


def _opts(folder, url, **kw):
    base = dict(op="ring", sweep="8,32", iters=1, num_runs=4,
                fence="block", synthetic_s=1e-3, uuid="job-push",
                logfolder=str(folder), push_url=url, device="cpu",
                sim_ranks=8)
    base.update(kw)
    return Options(**base)


def test_a_soak_delivers_every_family_with_zero_drops(tmp_path, collector):
    opts = _opts(tmp_path, collector.url, spans=True, health=True,
                 push_textfile=str(tmp_path / "push.prom"))
    d = Driver(opts, err=io.StringIO())
    rows = d.run()
    t = d.pusher.totals()
    assert t["dropped"] == 0 and t["queued"] == 0 and t["sent"] > 0
    (log,) = glob.glob(str(tmp_path / "tpu-*.log"))
    with open(log) as fh:
        durable = fh.read().splitlines()
    assert collector.lines(EXT_PREFIX) == durable
    assert len(collector.lines(LEGACY_PREFIX)) == len(rows)
    span_lines = collector.lines(SPANS_PREFIX)
    (slog,) = glob.glob(str(tmp_path / "spans-*.log"))
    with open(slog) as fh:
        durable_spans = fh.read().splitlines()
    assert span_lines and set(span_lines) <= set(durable_spans)
    assert "run" in {json.loads(ln)["kind"] for ln in span_lines}
    assert "push" in {json.loads(ln)["kind"] for ln in durable_spans}
    prom = (tmp_path / "push.prom").read_text()
    assert "tpu_perf_push_dropped_total 0" in prom
    (side,) = glob.glob(str(tmp_path / "phase-*.json"))
    with open(side) as fh:
        push = json.load(fh)["push"]
    assert push["dropped"] == 0 and push["sent"] == t["sent"]


def test_a_daemon_soak_into_the_loopback_server_loses_nothing(
        tmp_path, collector):
    # the daemon path at a size a real soak runs, with the default queue
    err = io.StringIO()
    opts = _opts(tmp_path, collector.url, num_runs=-1, max_runs=500,
                 stats_every=100, heartbeat_format="json")
    d = Driver(opts, err=err)
    d.run()
    t = d.pusher.totals()
    assert (t["dropped"], t["queued"], t["spooled"]) == (0, 0, 0)
    durable = []
    for path in sorted(glob.glob(str(tmp_path / "tpu-*.log"))):
        with open(path) as fh:
            durable += fh.read().splitlines()
    assert len(durable) == 500
    assert sorted(collector.lines(EXT_PREFIX)) == sorted(durable)
    beats = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{") and '"heartbeat"' in ln]
    assert len(beats) == 5
    for b in beats:
        assert set(b["push"]) >= {"sent", "dropped", "retried", "spooled",
                                  "replayed", "queued", "spool_depth",
                                  "backoff"}


def test_the_plane_off_is_the_null_pusher(tmp_path):
    d = Driver(_opts(tmp_path, None), err=io.StringIO())
    assert d.pusher is NULL_PUSHER
    d.run()
    (side,) = glob.glob(str(tmp_path / "phase-*.json"))
    with open(side) as fh:
        assert "push" not in json.load(fh)


def test_the_chaos_ledger_is_byte_identical_with_push_on_and_off(
        tmp_path, collector):
    faults = [FaultSpec(kind="spike", op="ring", nbytes=32, start=2, end=3,
                        magnitude=30.0)]
    outs = {}
    for mode in ("off", "on"):
        folder = tmp_path / mode
        url = collector.url if mode == "on" else None
        Driver(_opts(folder, url, faults=faults, fault_seed=11),
               err=io.StringIO()).run()
        (ledger,) = glob.glob(str(folder / "chaos-*.log"))
        with open(ledger) as fh:
            outs[mode, "ledger"] = fh.read()
        (log,) = glob.glob(str(folder / "tpu-*.log"))
        with open(log) as fh:
            outs[mode, "rows"] = [",".join(ln.split(",")[1:])
                                  for ln in fh.read().splitlines()]
    assert outs["on", "ledger"] == outs["off", "ledger"]
    assert outs["on", "rows"] == outs["off", "rows"]
    assert collector.lines(CHAOS_PREFIX) == []


def test_the_spool_requeue_replay_round_trip_through_the_cli(
        tmp_path, collector, capsys, monkeypatch):
    # the sink is down for the whole soak: every batch dead-letters; the
    # operator's requeue and `push replay` then deliver every row
    collector.mode = "refuse"
    d = Driver(_opts(tmp_path, collector.url), err=io.StringIO())
    d.pusher.max_attempts = 1
    d.pusher.backoff_base = 0.0
    d.run()
    t = d.pusher.totals()
    assert t["spooled"] > 0 and t["sent"] == 0 and t["spool_depth"] > 0
    (log,) = glob.glob(str(tmp_path / "tpu-*.log"))
    with open(log) as fh:
        durable = fh.read().splitlines()
    assert cli.main(["push", "replay", str(tmp_path), "--url",
                     collector.url]) == 0
    assert "quarantined" in capsys.readouterr().err  # requeue first
    monkeypatch.setenv("TPU_PERF_INGEST", "local:" + str(tmp_path / "sink"))
    assert cli.main(["ingest", "-d", str(tmp_path), "-f", "0",
                     "--requeue"]) == 0
    collector.mode = "ok"
    assert cli.main(["push", "replay", str(tmp_path), "--url",
                     collector.url]) == 0
    assert sorted(collector.lines(EXT_PREFIX)) == sorted(durable)
    assert spool_depth(str(tmp_path)) == 0


def test_the_report_renders_jaxs_push_table(tmp_path, collector, capsys):
    assert cli.main(["run", "--op", "ring", "--sweep", "8,32", "-i", "1",
                     "-r", "3", "--device", "cpu", "--sim-ranks", "8",
                     "-l", str(tmp_path), "--push", collector.url]) == 0
    from tpu_perf_torch.report import read_phases

    entries = read_phases(str(tmp_path))
    assert push_to_markdown(entries) == jpush_md(entries)
    capsys.readouterr()
    assert cli.main(["report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "### Push plane" in out and push_to_markdown(entries) in out


def test_the_exporter_carries_the_push_gauges(tmp_path, collector):
    prom = tmp_path / "health.prom"
    Driver(_opts(tmp_path, collector.url, health=True, num_runs=-1,
                 max_runs=20, stats_every=10,
                 health_textfile=str(prom)), err=io.StringIO()).run()
    text = prom.read_text()
    assert "tpu_perf_push_sent_total" in text
    assert "tpu_perf_push_dropped_total 0" in text
    assert os.path.exists(prom)
