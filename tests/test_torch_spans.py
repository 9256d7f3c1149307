"""The port's span tracer (``tpu_perf_torch.spans``) and its driver wiring
against the JAX package's (``tpu_perf.spans``, ``tpu_perf.driver``).

The tracer alone, under an injected clock, writes the JAX tracer's records
byte for byte, a deferred span included.  Both drivers, run on the same
options under injected clocks, emit spans alike in kind, parent, lane ID
and attrs.  A recording clock shows that no span record is written
inside a run's timed window (the block fence's span is written after the
run's end read), and rows and chaos ledgers are byte-identical with
``--spans`` off but for the span column.
"""

import glob
import io
import json
import sys

import pytest

from tpu_perf import spans as jspans
from tpu_perf.config import Options as JOptions
from tpu_perf.driver import Driver as JDriver
from tpu_perf.parallel import make_mesh

from tpu_perf_torch import spans as tspans
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.faults import FaultSpec
from tpu_perf_torch.schema import ResultRow


@pytest.fixture(scope="module")
def mesh(eight_devices):
    return make_mesh()


class FakeNs:
    """Deterministic perf_ns: +1 us a call."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1000
        return self.t


class FakeClock:
    """Deterministic seconds clock (the drivers' clock and perf_clock)."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def __call__(self):
        self.t += 1e-4
        return self.t


def _drive_tracer(mod, *, defer: bool):
    """One fixed sequence of tracer operations; the port's fence spans
    deferred when ``defer``."""
    tr = mod.SpanTracer("job", rank=1, retain=True, perf_ns=FakeNs(),
                        sample=2)
    kw = {"defer": True} if defer else {}
    with tr.span("job", op="ring"):
        with tr.span("sweep", points=2) as sweep:
            tr.set_anchor(sweep)
            for run_id in range(1, 5):
                with tr.run_span(run_id, op="ring", nbytes=8):
                    with tr.span("measure", run_id=run_id):
                        with tr.span("fence", mode="block", **kw):
                            pass
                        if defer:
                            tr.flush()
                    tr.emit("inject", tr.now(), 5, run_id=run_id, fired=1)
            with tr.stream_span(1, "dispatch", label="ring", **kw):
                pass
            with tr.stream_span(1, "stream_fence", label="ring", **kw):
                pass
            if defer:
                tr.flush()
            hook = tr.wrap_hook(lambda: None)
            hook()
            tr.emit_run(9, 100, 50, op="ring", nbytes=32)
            with pytest.raises(RuntimeError):
                with tr.span("warmup", op="ring"):
                    raise RuntimeError("boom")
    tr.close()
    return tr.records


def test_the_tracer_writes_jaxs_records():
    want = _drive_tracer(jspans, defer=False)
    assert _drive_tracer(tspans, defer=False) == want
    # a deferred span's record is the one an undeferred span writes,
    # in the same place of the stream
    assert _drive_tracer(tspans, defer=True) == want
    kinds = {r["kind"] for r in want}
    assert {"run", "fence", "inject", "dispatch", "stream_fence",
            "ingest_hook", "warmup"} <= kinds


@pytest.mark.parametrize("sample,kept", [(1, 12), (2, 10), (4, 9)])
def test_spans_sample_keeps_jaxs_records(sample, kept):
    def drive(mod):
        tr = mod.SpanTracer("j", retain=True, perf_ns=FakeNs(),
                            sample=sample)
        for run_id in range(1, 5):
            with tr.run_span(run_id):
                with tr.span("measure", run_id=run_id):
                    pass
                tr.emit("rotate", 1, 1, run_id=run_id)
        return tr.records

    got = drive(tspans)
    assert got == drive(jspans) and len(got) == kept


def test_null_tracer_is_inert():
    t = tspans.NULL_TRACER
    with t.span("x", defer=True, a=1) as sid:
        assert sid == ""
    with t.stream_span(0, "dispatch", defer=True) as sid:
        assert sid == ""
    assert t.emit_run(1, 0, 0) == "" and t.now() == 0
    t.flush()
    assert t.wrap_hook(None) is None and t.records is None


def _span_key(s: dict) -> tuple:
    attrs = dict(s["attrs"])
    if s["kind"] == "job":
        attrs["backend"] = "*"  # jax / torch: the package's own name
    return (s["kind"], s["span_id"], s["parent_id"], s["thread"],
            json.dumps(attrs, sort_keys=True))


_BASE = dict(op="ring,exchange", sweep="8,32", iters=1, num_runs=4,
             fence="block", synthetic_s=1e-3, fault_seed=7,
             uuid="job-fixed", spans=True)


def _jax_opts(**kw):
    return JOptions(**{**_BASE, **kw})


def _torch_opts(**kw):
    return Options(**{**_BASE, "device": "cpu", "sim_ranks": 8, **kw})


def test_a_finite_run_emits_jaxs_spans(mesh):
    j = JDriver(_jax_opts(), mesh, clock=FakeClock(), perf_clock=FakeClock(),
                err=io.StringIO())
    j.run()
    t = Driver(_torch_opts(), clock=FakeClock(), perf_clock=FakeClock(),
               err=io.StringIO())
    t.run()
    assert [_span_key(s) for s in t.tracer.records] == \
        [_span_key(s) for s in j.tracer.records]
    assert [r.span_id for r in t.result_rows] == \
        [r.span_id for r in j.result_rows]


CHAOS = [FaultSpec(kind="spike", op="ring", nbytes=32, start=30, end=40,
                   magnitude=30.0),
         FaultSpec(kind="drop_run", op="exchange", nbytes=8, start=41,
                   end=50),
         FaultSpec(kind="hook_fail", start=52, end=53)]


@pytest.mark.parametrize("sample", [1, 3])
def test_a_chaos_daemon_emits_jaxs_spans(mesh, tmp_path, sample):
    """The daemon under faults and --health: inject, rotate, ingest_hook
    and heartbeat spans inside their runs, alike in both packages."""
    from tpu_perf.faults import FaultSpec as JFaultSpec

    jfaults = [JFaultSpec(**vars(f)) for f in CHAOS]
    kw = dict(health=True, health_warmup=8, stats_every=10,
              spans_sample=sample)
    j = JDriver(_jax_opts(faults=jfaults, logfolder=str(tmp_path / "j"),
                          num_runs=-1, **kw),
                mesh, clock=FakeClock(), perf_clock=FakeClock(),
                err=io.StringIO(), max_runs=60)
    j.run()
    t = Driver(_torch_opts(faults=list(CHAOS), logfolder=str(tmp_path / "t"),
                           max_runs=60, num_runs=-1, **kw),
               clock=FakeClock(), perf_clock=FakeClock(), err=io.StringIO())
    t.run()
    recs = {}
    for side in ("j", "t"):
        recs[side] = jspans.read_span_records(
            sorted(glob.glob(str(tmp_path / side / "spans-*.log"))))
    assert [_span_key(s) for s in recs["t"]] == \
        [_span_key(s) for s in recs["j"]]
    kinds = {s["kind"] for s in recs["t"]}
    assert {"inject", "rotate", "ingest_hook", "heartbeat", "run"} <= kinds


class _Recorder:
    """A perf clock that notes which function read it, and a span log
    that notes each record written, in one sequence."""

    def __init__(self):
        self.t = 0.0
        self.seq: list[tuple[str, str]] = []

    def __call__(self):
        self.t += 1e-6
        self.seq.append(("clock", sys._getframe(1).f_code.co_name))
        return self.t

    def log(self, tracer):
        plain = tracer.log.write_row

        def write_row(row):
            self.seq.append(("write", row.data["kind"]))
            plain(row)

        tracer.log.write_row = write_row


@pytest.mark.parametrize("fence", ["block", "readback"])
def test_no_span_is_written_inside_a_timed_window(tmp_path, fence):
    rec = _Recorder()
    opts = Options(op="pl_allreduce", buff_sz=64, iters=2, num_runs=5,
                   fence=fence, spans=True, logfolder=str(tmp_path),
                   device="cpu", sim_ranks=4)
    d = Driver(opts, perf_clock=rec, err=io.StringIO())
    rec.log(d.tracer)
    d.run()
    open_window, fences = False, 0
    for what, who in rec.seq:
        if what == "clock" and who == "_measure":
            open_window = not open_window  # the run's start, then end read
        elif what == "write":
            assert not open_window, f"a {who} span written inside a run"
            fences += who == "fence"
    assert fences == 5 and not open_window


def test_rows_and_ledgers_are_byte_identical_with_spans_off(tmp_path):
    faults = [FaultSpec(kind="spike", op="ring", nbytes=32, start=2, end=3,
                        magnitude=30.0)]
    outs = {}
    for mode in ("off", "on"):
        folder = tmp_path / mode
        opts = _torch_opts(spans=False, faults=faults,
                           logfolder=str(folder))
        if mode == "on":
            opts = _torch_opts(faults=faults, logfolder=str(folder))
        Driver(opts, err=io.StringIO()).run()
        (log,) = glob.glob(str(folder / "tpu-*.log"))
        (ledger,) = glob.glob(str(folder / "chaos-*.log"))
        outs[mode] = (open(log).read().splitlines(), open(ledger).read())
    assert outs["on"][1] == outs["off"][1]
    # the rows differ by the trailing span column alone (timestamps are
    # the wall clock's)
    on = [",".join(ln.split(",")[1:18]) for ln in outs["on"][0]]
    off = [",".join(ln.split(",")[1:]) for ln in outs["off"][0]]
    assert on == off
    assert {len(ln.split(",")) for ln in outs["on"][0]} == {19}
    assert {len(ln.split(",")) for ln in outs["off"][0]} == {18}
    rows = [ResultRow.from_csv(ln) for ln in outs["on"][0]]
    assert all(r.span_id.startswith("r") for r in rows)


def test_the_engine_traces_its_lanes_outside_their_windows(tmp_path):
    """--streams 2: a dispatch and a stream_fence span a lane a run, on
    the lane's s<id>. ID lane, none written while a lane is in flight."""
    rec = _Recorder()
    opts = Options(op="pl_allreduce,pl_ring", buff_sz=64, iters=2,
                   num_runs=3, streams=2, spans=True,
                   logfolder=str(tmp_path), device="cpu", sim_ranks=4)
    d = Driver(opts, perf_clock=rec, err=io.StringIO())
    rec.log(d.tracer)
    d.run()
    in_flight = 0
    for what, who in rec.seq:
        if what == "clock" and who == "dispatch":
            in_flight += 1
        elif what == "clock" and who == "fence":
            in_flight -= 1
        elif what == "write":
            assert in_flight == 0, f"a {who} span written with lanes live"
    spans = tspans.read_span_records(glob.glob(str(tmp_path / "spans-*")))
    lanes = sorted(s["span_id"] for s in spans
                   if s["kind"] in ("dispatch", "stream_fence"))
    assert lanes == sorted(f"s{k}.{i}" for k in (0, 1) for i in range(1, 7))
