"""The port's fused and auto fences against the JAX package's, on the CPU.

Where the JAX side runs a ``pl_*`` kernel it runs it as its own tests do,
under the Pallas interpreter on the 8 virtual CPU devices; the port runs
the kernels' plain versions.  Both sides take the same ``make_fill``
input, carried across with ``to_world``.

Tolerance: the movement ops (``pl_all_gather``, ``pl_pingpong``,
``pl_all_to_all``) are held exactly; ``pl_allreduce`` in float32 to rtol
1e-6, as ``test_torch_ported_ring.py`` holds it (both sides add in the
ring's order; the 1/n scale is exact, so they agree to the last bit, and
the tolerance only allows one rounding of difference)."""

import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

import tpu_perf.cli as jax_cli
import tpu_perf.config as jconfig
import tpu_perf.runner as jrunner
import tpu_perf.schema as jschema
import tpu_perf.timing as jtiming
from tpu_perf.ops import build_fused_step as jax_build_fused_step
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh

from tpu_perf_torch import cli, traceparse
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.ops.collectives import build_fused_step, build_op, to_tensor
from tpu_perf_torch.runner import build_fused_point, fused_plan_for, run_point
from tpu_perf_torch.timing import (
    FusedRunner, fused_chunk_plan, measure_overhead, resolve_fence,
    time_step, trace_fence_available,
)
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")


# --- the chunk plan ------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(num_runs=st.integers(1, 600), chunks=st.integers(-3, 700))
def test_fused_chunk_plan_matches_jax(num_runs, chunks):
    plan = fused_chunk_plan(num_runs, chunks)
    assert plan == jtiming.fused_chunk_plan(num_runs, chunks)
    assert sum(plan) == num_runs and max(plan) - min(plan) <= 1


@pytest.mark.parametrize("num_runs", [0, -1])
def test_fused_chunk_plan_refuses_an_empty_budget(num_runs):
    for plan in (fused_chunk_plan, jtiming.fused_chunk_plan):
        with pytest.raises(ValueError, match="num_runs must be positive"):
            plan(num_runs)


@settings(max_examples=200, deadline=None)
@given(runs=st.one_of(st.just(-1), st.integers(1, 400)),
       chunks=st.integers(0, 50),
       budget=st.one_of(st.none(), st.integers(1, 400)))
def test_fused_plan_for_matches_jax(runs, chunks, budget):
    # the daemon refuses chunks in both packages (see the error test)
    assume(not (runs == -1 and chunks))
    port = Options(num_runs=runs, fence="fused", fused_chunks=chunks)
    ref = jconfig.Options(num_runs=runs, fence="fused", fused_chunks=chunks)
    assert (fused_plan_for(port, budget=budget)
            == jrunner.fused_plan_for(ref, budget=budget))


@pytest.mark.parametrize("kw", [
    dict(fence="block", fused_chunks=2),
    dict(fence="fused", fused_chunks=-1),
    dict(fence="fused", fused_chunks=2, num_runs=-1),
])
def test_fused_chunks_errors_are_the_jax_packages(kw):
    with pytest.raises(ValueError) as ours:
        Options(**kw)
    with pytest.raises(ValueError) as ref:
        jconfig.Options(**kw)
    assert str(ours.value) == str(ref.value)


def test_fused_chunks_without_fused_fails_on_the_cli(capsys):
    argv = ["run", "--fused-chunks", "2", "--device", "cpu"]
    assert cli.main(argv) == 2
    assert "fused_chunks applies to --fence fused only" in \
        capsys.readouterr().err


def test_build_fused_step_chains_and_names():
    built = build_op("hbm_stream", SimWorld(2, CPU), 64, 2)
    with pytest.raises(ValueError, match="reps must be positive"):
        build_fused_step(built, 0)
    prog = build_fused_step(built, 3)
    assert prog.__name__ == "tpuperf_fused_hbm_stream"
    marks = []
    got = prog(built.example_input.clone(), on_run=marks.append)
    want = built.example_input.clone()
    for _ in range(3):
        want = built.step(want)
    assert marks == [0, 1, 2]
    assert torch.equal(got, want)
    point = build_fused_point(built, (3, 2, 2))
    assert point.plan == (3, 2, 2) and sorted(point.programs) == [2, 3]


# --- the fused chain against the JAX build_fused_step program ------------


FUSED_CASES = [
    ("pl_allreduce", 2), ("pl_allreduce", 5), ("pl_allreduce", 8),
    ("pl_all_gather", 2), ("pl_all_gather", 5), ("pl_all_gather", 8),
    ("pl_pingpong", 2), ("pl_pingpong", 8),
    ("pl_all_to_all", 2), ("pl_all_to_all", 5), ("pl_all_to_all", 8),
]


@pytest.mark.parametrize("op,n", FUSED_CASES)
def test_fused_chain_matches_the_jax_fused_program(op, n, eight_devices):
    # reps x iters = 3 x 1, odd: the all-to-all is an involution, so an
    # even count would hide a wrong transpose
    reps, iters, nbytes = 3, 1, n * 16 * 4
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, nbytes, iters)
    prog = jax_build_fused_step(jb, reps, donate=False)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    once = prog(jb.example_input)
    twice = np.asarray(jax.device_get(prog(once))).astype(np.float64)
    once = np.asarray(jax.device_get(once)).astype(np.float64)

    pb = build_op(op, SimWorld(n, CPU), nbytes, iters)
    assert torch.equal(to_tensor(to_world(x, n), "float32", CPU),
                       pb.example_input)
    point = build_fused_point(pb, (reps,))
    got = from_world(point.programs[reps](pb.example_input.clone()))
    # the runner: warm runs the first chunk once, a chunk once more
    runner = FusedRunner(point, pb)
    runner.warm()
    times = runner.chunk(reps)
    assert len(times) == reps and runner.dispatches == 1
    carried = from_world(runner.buffer)
    rtol = 1e-6 if op == "pl_allreduce" else 0
    np.testing.assert_allclose(got, once, rtol=rtol, atol=0)
    np.testing.assert_allclose(carried, twice, rtol=rtol, atol=0)
    # the example input stays intact: the runner carries a private copy
    assert torch.equal(pb.example_input,
                       to_tensor(to_world(x, n), "float32", CPU))


def test_cpu_chunks_are_chunk_means():
    built = build_op("allreduce", SimWorld(2, CPU), 64, 1)
    ticks = iter(range(100))
    runner = FusedRunner(build_fused_point(built, (4,)), built,
                         perf_clock=lambda: float(next(ticks)))
    runner.warm()
    assert runner.chunk(4) == [0.25] * 4  # a wall of one tick, four runs
    runner.close()
    assert runner.buffer is None


# --- rows under fused / auto / --measure-dispatch ------------------------


def _csv_rows(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert lines[0] == jschema.RESULT_HEADER
    return [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]


@pytest.mark.parametrize("flags", [["--fence", "fused"],
                                   ["--fence", "fused", "--fused-chunks", "2"],
                                   ["--fence", "auto"],
                                   ["--measure-dispatch"],
                                   ["--fence", "readback", "--measure-dispatch"],
                                   ["--fence", "slope", "--measure-dispatch"]])
def test_rows_parse_and_have_the_jax_rows_fields(flags, eight_devices,
                                                 capsys):
    argv = ["run", "--op", "allreduce", "-b", "256", "-i", "2", "-r", "3",
            "--csv", *flags]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    port = _csv_rows(capsys.readouterr().out)
    assert jax_cli.main(argv) == 0
    ref = _csv_rows(capsys.readouterr().out)

    def key(r):
        return (r.op, r.nbytes, r.iters, r.run_id, r.n_devices, r.dtype,
                r.mode, r.runs_requested, r.runs_taken, r.ci_rel, r.span_id,
                r.algo)

    assert [key(r) for r in port] == [key(r) for r in ref]
    measured = "--measure-dispatch" in flags and "slope" not in flags
    for rows in (port, ref):
        assert all((r.overhead_us > 0) == measured for r in rows)
        assert all(r.lat_us > 0 and r.busbw_gbps > 0 for r in rows)
    assert {r.backend for r in port} == {"torch-sim"}


def test_auto_is_slope_on_a_cpu_world_in_both_packages():
    assert jtiming.resolve_fence("auto") == "slope"
    assert resolve_fence("auto", CPU) == "slope"
    assert resolve_fence("auto", torch.device("cuda", 0)) == "trace"
    assert not trace_fence_available(CPU)
    for fence in ("block", "readback", "slope", "trace", "fused"):
        assert resolve_fence(fence, CPU) == jtiming.resolve_fence(fence)
    drv = Driver(Options(fence="auto", device="cpu"))
    assert drv.opts.fence == "slope"
    point = run_point(Options(op="allreduce", fence="auto", device="cpu",
                              buff_sz=64, num_runs=2), SimWorld(2, CPU), 64)
    assert len(point.times.samples) == 2


def test_measure_overhead_is_a_fenced_launch_floor():
    x = torch.ones(4, 8)
    for fence in ("block", "readback"):
        assert measure_overhead(x, fence_mode=fence) > 0
    times = time_step(lambda y: y + 1, x, 2, measure_dispatch=True)
    assert times.overhead_s > 0
    assert time_step(lambda y: y + 1, x, 2).overhead_s == 0.0


def test_driver_fused_finite_rows(tmp_path):
    opts = Options(op="pl_allreduce", sweep="64,128", iters=2, num_runs=3,
                   fence="fused", fused_chunks=2, device="cpu",
                   logfolder=str(tmp_path))
    rows = Driver(opts).run()
    assert [(r.nbytes, r.run_id) for r in rows] == [
        (n, i) for n in (64, 128) for i in (1, 2, 3)]
    assert {r.mode for r in rows} == {"oneshot"}
    assert all(r.time_ms > 0 for r in rows)


# --- --profile-dir and the trace reader ----------------------------------


def test_profile_dir_keeps_one_trace_per_point(tmp_path, capsys):
    pdir = tmp_path / "traces"
    argv = ["run", "--op", "allreduce", "--sweep", "64,128", "-i", "1",
            "-r", "2", "--device", "cpu", "--profile-dir", str(pdir)]
    for fence in ("block", "fused"):
        assert cli.main(argv + ["--fence", fence]) == 0
    capsys.readouterr()
    traces = sorted(p.name for p in pdir.iterdir())
    assert len(traces) == 4
    assert {t.split("-")[0] for t in traces} == {"allreduce"}
    events = traceparse.read_events(str(pdir / traces[0]))
    assert events  # host events; a CPU run has no device lane
    with pytest.raises(traceparse.TraceUnavailableError):
        traceparse.device_summary(str(pdir / traces[0]))


def test_device_summary_counts_overlaps_once(tmp_path):
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": 7}

    trace = {"traceEvents": [
        ev("cpu_op", "aten::empty", 0, 500),
        ev("kernel", "direct_reduce", 100, 10),
        ev("kernel", "gather", 105, 10),       # overlaps the first
        ev("gpu_memcpy", "Memcpy DtoD", 130, 5),
        ev("kernel", "direct_reduce", 150, 10),
        {"ph": "M", "name": "process_name", "pid": 0},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    s = traceparse.device_summary(str(path))
    assert s.kernels == {"direct_reduce": (2, pytest.approx(20e-6)),
                         "gather": (1, pytest.approx(10e-6))}
    assert s.kernel_s == pytest.approx(30e-6)
    assert s.busy_s == pytest.approx(30e-6)     # 100-115, 130-135, 150-160
    assert s.window_s == pytest.approx(60e-6)   # 100-160
    assert s.idle_share == pytest.approx(0.5)
    (tmp_path / "bad.json").write_text("{")
    with pytest.raises(traceparse.TraceParseError):
        traceparse.device_summary(str(tmp_path / "bad.json"))
