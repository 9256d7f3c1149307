"""The port's compile pipeline and phase timer (``tpu_perf_torch.compilepipe``)
against the JAX package's (``tpu_perf.compilepipe``), the phase sidecar and
heartbeat, and ``--precompile`` / ``--compile-cache`` through the driver.

The pipeline is compared event for event: both packages' pipelines drive
the same fake build callable over the same plans, and must build the same
keys once each, in plan order, never more than ``depth`` ahead of what was
consumed.  The sidecar the port's driver writes is read back by the JAX
package's report and must render the same phases table as the port's.
No card is needed: the worker's host half (``compilepipe.prepare``) is
held with the build stubbed.
"""

import io
import json
import os
import threading
import time

import pytest

import tpu_perf.compilepipe as jcp
import tpu_perf.report as jreport

from tpu_perf_torch import cli, kernels
from tpu_perf_torch import compilepipe as tcp
from tpu_perf_torch import report
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.kernels import _build


JAX_FIELDS = ("op", "nbytes", "iters", "dtype", "axis", "window", "fused",
              "algo", "imbalance", "stream", "load")


@pytest.mark.parametrize("kw", [
    dict(), dict(axis="ici"), dict(axis=("dcn", "ici")),
    dict(fused=(5, 4, 5)), dict(window=4, dtype="bfloat16"),
    dict(stream=2, load="hbm_stream"),
])
def test_compile_spec_keys_are_jaxs(kw):
    ours = tcp.CompileSpec.make("pl_allreduce", 4096, 5, **kw)
    theirs = jcp.CompileSpec.make("pl_allreduce", 4096, 5, **kw)
    assert ({f: getattr(ours, f) for f in JAX_FIELDS}
            == {f: getattr(theirs, f) for f in JAX_FIELDS})
    # the port's own field: the world the step is built in
    assert ours.world == ""
    assert tcp.CompileSpec.make("pl_allreduce", 4096, 5, **kw) == ours


def test_every_field_splits_the_key():
    base = tcp.CompileSpec.make("allreduce", 64, 2, world="sim/8/cuda")
    others = [
        tcp.CompileSpec.make("ring", 64, 2, world="sim/8/cuda"),
        tcp.CompileSpec.make("allreduce", 128, 2, world="sim/8/cuda"),
        tcp.CompileSpec.make("allreduce", 64, 3, world="sim/8/cuda"),
        tcp.CompileSpec.make("allreduce", 64, 2, dtype="bfloat16",
                             world="sim/8/cuda"),
        tcp.CompileSpec.make("allreduce", 64, 2, fused=(5,),
                             world="sim/8/cuda"),
        tcp.CompileSpec.make("allreduce", 64, 2, world="sim/4/cuda"),
        tcp.CompileSpec.make("allreduce", 64, 2, world="dist/8/cuda"),
        tcp.CompileSpec.make("allreduce", 64, 2, axis="x",
                             world="sim/8/cuda"),
    ]
    assert len({base, *others}) == len(others) + 1
    assert tcp.CompileSpec.make("allreduce", 64, 2, axis="x") == \
        tcp.CompileSpec.make("allreduce", 64, 2, axis=("x",))


@pytest.mark.parametrize("mod", [tcp, jcp])
def test_phase_timer_totals_across_threads(mod):
    clock = [0.0]
    lock = threading.Lock()

    def tick():
        with lock:
            return clock[0]

    timer = mod.PhaseTimer(perf_clock=tick)
    timer.start()

    def work(name):
        for _ in range(100):
            timer.add(name, 0.01)

    threads = [threading.Thread(target=work, args=(n,))
               for n in ("compile", "compile", "measure", "log")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with timer.phase("measure"):
        clock[0] += 2.5
    timer.stop()
    snap = timer.snapshot()
    assert snap == {"compile_s": 2.0, "measure_s": 3.5, "log_s": 1.0}
    assert timer.wall_s == 2.5


def test_the_phase_timers_agree():
    ours, theirs = tcp.PhaseTimer(), jcp.PhaseTimer()
    for t in (ours, theirs):
        t.add("compile", 0.1234567)
        t.add("log", 1e-7)
    assert ours.snapshot() == theirs.snapshot()
    assert tcp.PhaseTimer.PHASES == jcp.PhaseTimer.PHASES


def _drive(mod, plan, depth, *, slow=(), fail=None, consume_delay=0.0):
    """One pipeline over ``plan``; returns (builds in order, the largest
    look-ahead any build started at, what get() returned)."""
    built, ahead = [], []
    state = {"consumed": 0}
    lock = threading.Lock()

    def build(key):
        with lock:
            built.append(key)
            ahead.append(plan.index(key) - state["consumed"]
                         if key not in built[:-1] else 0)
        if key in slow:
            time.sleep(0.02)
        if key == fail:
            raise RuntimeError(f"build of {key} failed")
        return f"artifact-{key}"

    kw = {"tracer": None} if mod is jcp else {}
    got = []
    pipe = mod.CompilePipeline(build, plan, depth=depth, **kw)
    try:
        for key in plan:
            try:
                got.append(pipe.get(key))
            except RuntimeError as e:
                got.append(str(e))
            with lock:
                state["consumed"] += 1
            time.sleep(consume_delay)
    finally:
        pipe.close()
    return built, max(ahead), got, pipe.builds


@pytest.mark.parametrize("plan,depth", [
    (list("abcdef"), 1), (list("abcdef"), 2), (list("abcabcdd"), 2),
    (list("aaaa"), 3), (list("abcdefghij"), 4),
])
def test_the_pipeline_builds_each_spec_once_in_plan_order(plan, depth):
    ours = _drive(tcp, plan, depth, consume_delay=0.002)
    theirs = _drive(jcp, plan, depth, consume_delay=0.002)
    assert ours[0] == theirs[0] == list(dict.fromkeys(plan))
    assert ours[2] == theirs[2] == [f"artifact-{k}" for k in plan]
    assert ours[3] == theirs[3] == len(set(plan))
    assert ours[1] <= depth and theirs[1] <= depth


def test_a_failed_build_fails_at_its_own_get_as_jaxs_does():
    plan = list("abcd")
    ours = _drive(tcp, plan, 2, fail="b")
    theirs = _drive(jcp, plan, 2, fail="b")
    assert ours[2] == theirs[2] == ["artifact-a", "build of b failed",
                                   "artifact-c", "artifact-d"]


def test_set_depth_and_the_checks():
    pipe = tcp.CompilePipeline(lambda k: k, ["a", "b"], depth=1)
    pipe.set_depth(3)
    assert pipe.depth == 3
    with pytest.raises(ValueError, match="depth must be >= 1"):
        pipe.set_depth(0)
    assert pipe.get("a") == "a"
    with pytest.raises(KeyError):
        pipe.get("z")
    pipe.close()
    assert pipe.build_threads and threading.get_ident() not in \
        pipe.build_threads
    with pytest.raises(ValueError, match="empty build plan"):
        tcp.CompilePipeline(lambda k: k, [])


def test_prepare_builds_the_ops_sources_and_touches_no_card(monkeypatch):
    seen = []
    monkeypatch.setattr(_build, "compile_sources", seen.extend)
    import torch

    def no_cuda(*a, **k):
        raise AssertionError("the worker touched a CUDA API")

    for name in ("is_available", "synchronize", "current_stream",
                 "current_device", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    spec = tcp.CompileSpec.make
    tcp.prepare(spec("pl_allreduce", 4096, 5, world="sim/8/cuda"))
    tcp.prepare(spec("pl_allreduce", 4096, 5, world="dist/4/cuda"))
    tcp.prepare(spec("pl_hbm_copy", 4096, 5, world="dist/4/cuda"))
    tcp.prepare(spec("pl_ring", 4096, 5, world="sim/8/cpu"))
    tcp.prepare(spec("mxu_gemm", 1 << 20, 5, world="sim/1/cuda"))
    assert seen == ["reduce_scatter", "all_gather", "peer_collectives",
                    "hbm_copy"]


def test_enable_compile_cache_points_the_builds_at_the_folder(
        monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    folder = tmp_path / "kcache"
    assert tcp.enable_compile_cache(str(folder)) == str(folder)
    assert _build.BUILD_DIR == folder.resolve() and folder.is_dir()
    assert os.environ["TRITON_CACHE_DIR"] == str(folder.resolve() / "triton")
    # a fresh library in the folder is not built again
    assert _build._lib_path("hbm_copy").parent == folder.resolve()
    lib = _build._lib_path("hbm_copy")
    lib.write_bytes(b"")
    assert not _build._stale("hbm_copy")
    assert _build.compile_sources(["hbm_copy", "hbm_copy"]) == 0


# --- the driver: phases, the sidecar, the heartbeat, --precompile --------


def _run(tmp_path, name, **kw):
    folder = tmp_path / name
    opts = Options(**{**dict(op="pl_allreduce,allreduce", sweep="64,4K",
                             iters=2, num_runs=3, device="cpu",
                             logfolder=str(folder)), **kw})
    kernels.reset_counts()
    err = io.StringIO()
    d = Driver(opts, err=err)
    rows = d.run()
    return d, rows, folder, dict(kernels.PLAIN_CALLS), err.getvalue()


def test_the_sidecar_renders_the_same_phases_table_in_both_reports(
        tmp_path):
    d, _, folder, _, _ = _run(tmp_path, "logs", fence="fused", num_runs=4)
    [side] = folder.glob("phase-*.json")
    data = json.loads(side.read_text())
    assert set(data["phase"]) == {"compile_s", "measure_s", "log_s"}
    assert data["fused"]["points"] == 4
    assert data["fused"]["measure_dispatches"] == 4
    assert data["wall_s"] >= data["phase"]["measure_s"] > 0
    ours = report.phases_to_markdown(report.read_phases(str(folder)))
    theirs = jreport.phases_to_markdown(jreport.read_phases(str(folder)))
    assert ours == theirs and "dispatches" in ours
    # the report subcommand prints it after the curves
    out = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(out):
        assert cli.main(["report", str(folder)]) == 0
    assert "### Harness phases" in out.getvalue()


def test_a_failed_job_before_its_first_run_writes_no_sidecar(tmp_path):
    with pytest.raises(ValueError):
        _run(tmp_path, "bad", op="pl_allreduce", dtype="int32")
    assert not list((tmp_path / "bad").glob("phase-*.json"))


def test_the_json_heartbeat_carries_the_phases(tmp_path):
    err = io.StringIO()
    Driver(Options(op="allreduce", sweep="64,256", iters=1, num_runs=4,
                   stats_every=2, heartbeat_format="json", device="cpu"),
           err=err).run()
    beats = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")]
    assert len(beats) == 4
    phases = [b["phase"] for b in beats]
    assert all(set(p) == {"compile_s", "measure_s", "log_s"} for p in phases)
    assert all(a["measure_s"] <= b["measure_s"]
               for a, b in zip(phases, phases[1:]))
    assert phases[-1]["compile_s"] > 0 and phases[-1]["measure_s"] > 0


@pytest.mark.parametrize("depth", [2, "auto"])
@pytest.mark.parametrize("fence", ["block", "fused", "readback"])
def test_precompile_keeps_the_serial_runs_rows_and_calls(tmp_path, depth,
                                                         fence):
    serial = _run(tmp_path, "serial", fence=fence)
    piped = _run(tmp_path, "piped", fence=fence,
                 precompile=1 if depth == "auto" else depth,
                 precompile_auto=depth == "auto")

    def coords(rows):
        return [(r.op, r.nbytes, r.iters, r.run_id, r.n_devices)
                for r in rows]

    assert coords(piped[1]) == coords(serial[1])
    assert piped[3] == serial[3]
    data = json.loads(next(piped[2].glob("phase-*.json")).read_text())
    assert data["precompile"] == depth
    assert ("precompile_depth" in data) == (depth == "auto")


def test_the_cli_takes_precompile_and_compile_cache(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    logs, cache = tmp_path / "logs", tmp_path / "cache"
    assert cli.main(["run", "--op", "pl_allreduce", "--sweep", "64,4K", "-i",
                     "2", "-r", "6", "--ci-rel", "0.5", "--min-runs", "3",
                     "--max-runs", "6", "--precompile", "auto",
                     "--compile-cache", str(cache), "-l", str(logs),
                     "--device", "cpu"]) == 0
    data = json.loads(next(logs.glob("phase-*.json")).read_text())
    assert data["precompile"] == "auto" and data["kernel_builds"] == 0
    assert _build.BUILD_DIR == cache.resolve()
    with pytest.raises(SystemExit):
        cli.main(["run", "--precompile", "x", "--device", "cpu"])
    assert "depth N >= 0 or 'auto'" in capsys.readouterr().err
