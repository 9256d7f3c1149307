"""The port's stream engine, overlapped sweep and contention race against
the JAX package, on the CPU: the static plans, the engine's lane rules
(on the CPU a lane is a plain sequential call), ``run --streams K``,
``contend`` and its interference matrix, the options' refusals, and the
kernels' device counters, kept per card and stream.  Everything compared
is exact: plans, row coordinates and messages are data, and both reports
summarize the same floats."""

import dataclasses

import pytest
import torch

import tpu_perf.config as jconfig
import tpu_perf.report as jreport
import tpu_perf.schema as jschema
import tpu_perf.streams.plans as jplans
from tpu_perf.parallel import make_mesh
from tpu_perf.streams.contend import COMPUTE_LOADS as JAX_COMPUTE_LOADS
from tpu_perf.streams.contend import CONTEND_FENCES as JAX_CONTEND_FENCES
from tpu_perf.streams.contend import run_contend as jax_run_contend

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import cli, report
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.schema import ResultRow
from tpu_perf_torch.streams import contend, plans
from tpu_perf_torch.streams.engine import StreamEngine
from tpu_perf_torch.world import SimWorld

CPU = torch.device("cpu")


# --- the plans: pure functions, the JAX package's -----------------------


@pytest.mark.parametrize("fn,args,kw", [
    ("wave_plan", (range(7), 3), {}),
    ("wave_plan", (["a", "b"], 4), {}),
    ("wave_plan", ([], 2), {}),
    ("wave_plan", (range(4), 1), {}),
    ("wave_plan", (range(3), 0), {}),
    ("split_slices", (10, 3), {}),
    ("split_slices", (10, 3), {"itemsize": 4}),
    ("split_slices", (2, 5), {"itemsize": 2}),
    ("split_slices", (4096, 4), {"itemsize": 4}),
    ("split_slices", (0, 2), {}),
    ("split_slices", (8, 2), {"itemsize": 0}),
    ("split_slices", (8, 0), {}),
    ("lane_schedules", (["s0", "s1", "s2"], 5), {}),
    ("lane_schedules", (["s0"], 2), {}),
    ("lane_schedules", ([], 2), {}),
    ("lane_schedules", (["s0"], 0), {}),
])
def test_plans_match_jax(fn, args, kw):
    def call(mod):
        try:
            return ("ok", getattr(mod, fn)(*args, **kw))
        except ValueError as e:
            return ("error", str(e))

    assert call(plans) == call(jplans)


# --- the engine (CPU lanes) ---------------------------------------------


def _clock():
    now = [0.0]

    def clock():
        now[0] += 1.0
        return now[0]

    return clock


def test_engine_fences_in_dispatch_order_and_times_each_lane():
    engine = StreamEngine(3, perf_clock=_clock())
    x = torch.arange(4.0)
    outs = [engine.dispatch(lane, lambda y, k=lane: y + k, x)
            for lane in (2, 0)]
    assert engine.in_flight == (0, 2)
    assert [o.tolist() for o in outs] == [[2, 3, 4, 5], [0, 1, 2, 3]]
    # clock: dispatch 2 at 1, dispatch 0 at 2; fences at 3 and 4, in
    # dispatch order: lane 2 first
    assert engine.fence_all() == {2: 2.0, 0: 2.0}
    assert list(engine.fence_all()) == []
    assert engine.in_flight == ()
    assert engine._lanes == {}  # no stream object on the CPU


@pytest.mark.parametrize("act,err,match", [
    ("occupied", RuntimeError, "already has a step in flight"),
    ("empty", RuntimeError, "nothing in flight"),
    ("range", ValueError, "out of range"),
])
def test_engine_lane_rules(act, err, match):
    engine = StreamEngine(2)
    x = torch.ones(2)
    with pytest.raises(err, match=match):
        if act == "occupied":
            engine.dispatch(1, torch.neg, x, label="first")
            engine.dispatch(1, torch.neg, x)
        elif act == "empty":
            engine.fence(0)
        else:
            engine.dispatch(2, torch.neg, x)


@pytest.mark.parametrize("kw,match", [(dict(n_streams=0), "n_streams"),
                                      (dict(n_streams=2, fence_mode="slope"),
                                       "fence_mode")])
def test_engine_refuses_bad_configs(kw, match):
    with pytest.raises(ValueError, match=match):
        StreamEngine(**kw)


def test_readback_lanes_return_the_steps_output():
    engine = StreamEngine(2, fence_mode="readback")
    out = engine.dispatch(0, lambda y: y * 2, torch.ones(3))
    assert engine.fence(0) > 0 and out.tolist() == [2.0, 2.0, 2.0]


# --- the options ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(streams=0), dict(streams=-2), dict(streams=2, num_runs=-1),
    dict(streams=3, fence="fused"), dict(streams=2, fence="slope"),
    dict(streams=2, fence="trace"), dict(streams=2, fence="readback"),
    dict(streams=2, op="extern", extern_cmd="echo"),
    dict(load="hbm_stream", num_runs=-1),
    dict(load="hbm_stream", op="extern", extern_cmd="echo"),
    dict(load="mxu_gemm"),
])
def test_streams_and_load_options_match_jax(kw):
    def make(cls):
        try:
            cls(**kw)
            return "ok"
        except ValueError as e:
            return str(e)

    assert make(Options) == make(jconfig.Options)


def test_other_backends_refuse_streams_and_loads():
    with pytest.raises(ValueError, match="backend='mpi' has no in-flight"):
        Options(streams=2, backend="mpi")
    with pytest.raises(ValueError, match="cannot race them"):
        Options(load="hbm_stream", backend="mpi")


# --- the overlapped sweep -----------------------------------------------


FAMILY = "allreduce,pl_ring,pl_hbm_copy,ring"


def test_streams_sweep_rows_are_the_serial_sweeps(eight_devices):
    kw = dict(op=FAMILY, sweep="64,1K", iters=2, num_runs=3, device="cpu")
    serial = Driver(Options(**kw)).run()
    driver = Driver(Options(**kw, streams=3))
    lanes = driver.run()

    def coords(rows):
        return sorted((r.op, r.nbytes, r.run_id, r.iters, r.n_devices)
                      for r in rows)

    assert coords(lanes) == coords(serial)
    # 8 points on 3 lanes: waves of 3, 3 and 2; a wave's point i on lane i
    plan = [(op, nb) for op in FAMILY.split(",") for nb in (64, 1024)]
    want = {p: lane + 1 for wave in plans.wave_plan(plan, 3)
            for lane, p in wave}
    assert {((r.op, r.nbytes), r.stream) for r in lanes} == set(want.items())
    assert {r.stream for r in serial} == {0}
    assert driver.stream_totals["waves"] == 3
    assert driver.stream_totals["window_s"] > 0
    # the serial and the overlapped walk have the JAX package's coordinates
    ref = jax_run_rows(dict(op=FAMILY, sweep="64,1K", iters=2, num_runs=3))
    assert coords(serial) == sorted(
        (r.op, r.nbytes, r.run_id, r.iters, r.n_devices) for r in ref)


def jax_run_rows(kw):
    from tpu_perf.driver import Driver as JDriver

    return JDriver(jconfig.Options(**kw), make_mesh()).run()


def test_cli_streams_rows_carry_the_lane_column(capsys):
    assert cli.main(["run", "--op", "allreduce,pl_ring", "--sweep", "64,1K",
                     "-i", "2", "-r", "2", "--streams", "3",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith(",span_id,algo,skew_us,imbalance,stream")
    rows = [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]
    assert len(rows) == 8 and {r.stream for r in rows} == {1, 2, 3}
    assert all(ln.count(",") == lines[0].count(",") for ln in lines)


def test_the_driver_refuses_a_load():
    with pytest.raises(ValueError, match="not valid on the run/monitor path"):
        Driver(Options(op="allreduce", load="hbm_stream", device="cpu")).run()


# --- contend ----------------------------------------------------------


def test_contend_constants_are_the_jax_ones():
    assert contend.COMPUTE_LOADS == JAX_COMPUTE_LOADS
    assert contend.CONTEND_FENCES == JAX_CONTEND_FENCES


@pytest.mark.parametrize("load", ["hbm_stream", "mxu_gemm", "pl_hbm_copy",
                                  "allreduce"])
def test_contend_rows_idle_then_loaded(load):
    opts = Options(op="allreduce", sweep="4K,16K", iters=2, num_runs=3,
                   load=load, device="cpu")
    rows = contend.run_contend(opts, world=SimWorld(8, CPU))
    assert len(rows) == 12
    for nbytes, group in ((4096, rows[:6]), (16384, rows[6:])):
        idle, loaded = group[:3], group[3:]
        assert [(r.load, r.stream) for r in idle] == [("", 0)] * 3
        assert [(r.load, r.stream) for r in loaded] == [(load, 1)] * 3
        assert {(r.op, r.nbytes, r.iters, r.backend, r.n_devices)
                for r in group} == {("allreduce", nbytes, 2, "torch-sim", 8)}
        assert [r.run_id for r in group] == [1, 2, 3] * 2


def test_contend_rows_have_the_jax_coordinates(eight_devices):
    kw = dict(op="allreduce", sweep="4K,16K", iters=2, num_runs=3,
              load="hbm_stream")
    ours = contend.run_contend(Options(**kw, device="cpu"),
                               world=SimWorld(8, CPU))
    theirs = jax_run_contend(jconfig.Options(**kw), mesh=make_mesh())

    def coords(rows):
        return [(r.op, r.nbytes, r.iters, r.run_id, r.n_devices, r.load,
                 r.stream) for r in rows]

    assert coords(ours) == coords(theirs)


@pytest.mark.parametrize("kw,err,match", [
    (dict(), ValueError, "needs a load selection"),
    (dict(load="nope"), ValueError, "unknown load op"),
    (dict(load="hbm_stream", op="allreduce,ring"), ValueError,
     "single victim op"),
    (dict(load="hbm_stream", fence="slope"), ValueError, "per-run fence"),
    # the split-channel shape is ported: what it still refuses is JAX's
    # (the id is the case's name from before the port)
    pytest.param(dict(load="split:2", op="allreduce"), ValueError,
                 "slices a ppermute payload",
                 id="kw4-NotImplementedError-not yet ported"),
])
def test_run_contend_refusals(kw, err, match):
    opts = Options(**{"op": "allreduce", "device": "cpu", **kw})
    with pytest.raises(err, match=match):
        contend.run_contend(opts, world=SimWorld(8, CPU))


@pytest.mark.parametrize("flags", [
    # the split-channel shape is ported and runs on a ppermute victim
    ["--split", "2", "--op", "ppermute"],
    # the axis flags run (tests/test_torch_contend_axes.py), beside the
    # split-channel shape too
    ["--split", "2", "--op", "ppermute", "--victim-axis", "x"],
    # the arena's --algo and the push plane are ported: these run
    ["--load", "hbm_stream", "--load-axis", "x", "--algo", "ring"],
    ["--load", "hbm_stream", "--push-textfile", "push.prom"],
    ["--load", "hbm_stream", "--algo", "ring"],
])
def test_contend_flags_not_yet_ported(flags, capsys, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["contend", "-b", "4K", "--device", "cpu", "--csv"]
                  + flags)
    out, err = capsys.readouterr()
    assert rc == 0, err
    rows = [ln.split(",") for ln in out.splitlines()[1:]]
    algos = {r[19] for r in rows}
    assert algos == ({"ring"} if "--algo" in flags else {""})
    if "--split" in flags:
        assert {r[23] for r in rows} == {"", "split:2"}
        assert {r[22] for r in rows} <= {"", "0"}  # no single lane


@pytest.mark.parametrize("flags,match", [
    ([], "name exactly one load shape"),
    (["--load", "hbm_stream", "--split", "2"], "name exactly one load shape"),
    (["--split", "1"], "K >= 2"),
    (["--load", "hbm_stream", "--streams", "2"], "--streams applies to"),
    (["--load", "hbm_stream", "--backend", "mpi"], "drives the torch"),
])
def test_contend_cli_refusals(flags, match, capsys):
    assert cli.main(["contend", "--device", "cpu"] + flags) == 2
    assert match in capsys.readouterr().err


def test_contend_cli_rows_and_the_reports_interference_matrix(tmp_path,
                                                               capsys):
    for load in ("hbm_stream", "mxu_gemm"):
        assert cli.main(["contend", "--load", load, "-b", "4K", "-i", "2",
                         "-r", "3", "--device", "cpu", "-l",
                         str(tmp_path)]) == 0
    err = capsys.readouterr().err
    assert "allreduce @ 4096 B under mxu_gemm: slowdown" in err
    assert cli.main(["report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    matrix = out.split("### Interference matrix\n", 1)[1].splitlines()
    cells = [ln for ln in matrix if ln.startswith("| allreduce |")]
    assert [c.split(" | ")[3] for c in cells] == ["hbm_stream", "mxu_gemm"]
    # a report without loaded rows renders no matrix
    assert cli.main(["run", "--op", "ring", "-b", "64", "-r", "2", "-l",
                     str(tmp_path / "quiet"), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["report", str(tmp_path / "quiet")]) == 0
    assert "Interference" not in capsys.readouterr().out


def test_contend_cli_csv_is_rectangular(capsys):
    assert cli.main(["contend", "--load", "pl_hbm_copy", "-b", "4K", "-i",
                     "1", "-r", "2", "--sim-ranks", "2",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith(",stream,load")
    assert {ln.count(",") for ln in lines} == {lines[0].count(",")}
    rows = [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]
    assert [(r.load, r.stream) for r in rows] == \
        [("", 0)] * 2 + [("pl_hbm_copy", 1)] * 2


# --- the interference matrix against the JAX package's -----------------


def _race_rows():
    rows = []
    for op, nbytes, load, lats in (
            ("allreduce", 4096, "", (10.0, 11.0, 12.0)),
            ("allreduce", 4096, "hbm_stream", (15.0, 16.5, 18.0)),
            ("allreduce", 4096, "mxu_gemm", (30.0, 31.0, 29.0)),
            ("pl_allreduce", 4096, "hbm_stream", (7.0, 7.5, 8.0)),
            ("ring", 64, "", (3.0, 3.0, 3.0))):
        for run_id, lat in enumerate(lats, start=1):
            rows.append(ResultRow(
                timestamp="2026-01-01 00:00:00.000", job_id="j",
                backend="torch-sim", op=op, nbytes=nbytes, iters=2,
                run_id=run_id, n_devices=8, lat_us=lat, algbw_gbps=1.0,
                busbw_gbps=lat / 10, time_ms=lat * 2e-3, load=load,
                stream=1 if load else 0))
    return rows


def test_interference_matrix_matches_jax():
    rows = _race_rows()
    ours = report.interference_matrix(report.aggregate(rows))
    jrows = [dataclasses.replace(jschema.ResultRow.from_csv(r.to_csv()),
                                 backend="jax") for r in rows]
    theirs = jreport.interference_matrix(jreport.aggregate(jrows))
    assert [(c.op, c.nbytes, c.load, c.slowdown) for c in ours] == \
        [(c.op, c.nbytes, c.load, c.slowdown) for c in theirs]
    assert len(ours) == 3 and ours[2].idle is None
    assert ours[0].slowdown == pytest.approx(16.5 / 11.0)
    assert report.interference_to_markdown(ours) == \
        jreport.interference_to_markdown(theirs)
    # a literal copy of the JAX filter keeps only backend "jax": the
    # port's own rows would render an empty matrix
    assert jreport.interference_matrix(report.aggregate(rows)) == []


def test_interference_matrix_skips_other_backends():
    rows = [dataclasses.replace(r, backend="mpi") for r in _race_rows()]
    assert report.interference_matrix(report.aggregate(rows)) == []


# --- the kernels' device counters, per card and stream -----------------


@pytest.fixture
def fake_streams(monkeypatch):
    """Counter keys from a settable current stream (the CPU has none)."""
    current = {"stream": 11}
    monkeypatch.setattr(tpr, "_stream_key",
                        lambda device: (device.index, current["stream"]))
    monkeypatch.setattr(tpr, "_ROW_COPY_COUNTERS",
                        {"p2p_shift": {}, "hbm_copy": {}, "all_gather": {},
                         "peer_copy": {}, "peer_reduce": {},
                         "peer_gather": {}})
    monkeypatch.setattr(tpr, "_PINGPONG_COUNTERS", {})
    return current


@pytest.mark.parametrize("get", [
    lambda: tpr.row_copy_counters("p2p_shift", CPU),
    lambda: tpr.row_copy_counters("all_gather", CPU),
    lambda: tpr.row_copy_counters("peer_copy", CPU),
    lambda: tpr.row_copy_counters("peer_reduce", CPU),
    lambda: tpr.row_copy_counters("peer_gather", CPU),
    lambda: tpr.pingpong_counters(CPU, 4),
])
def test_two_streams_get_two_counter_buffers(get, fake_streams):
    first = get()
    assert get() is first and not first.any()
    fake_streams["stream"] = 12
    second = get()
    assert second is not first and not second.any()
    assert get() is second
    fake_streams["stream"] = 11
    assert get() is first


def test_the_counter_key_is_the_card_and_its_current_stream(monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    assert tpr._stream_key(torch.device("cuda", 1)) == (1, 1001)
    assert tpr._stream_key(CPU) == ("cpu", None)
