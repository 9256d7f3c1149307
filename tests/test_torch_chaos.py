"""The port's chaos layer (``tpu_perf_torch.faults``, ``chaos``, ``chaos
verify``) against the JAX package's on the CPU.

The twin: JAX's ``chaos`` on 8 CPU devices and the port's ``chaos
--device cpu --sim-ranks 8`` with the JAX acceptance soak's schedule,
seed and flags write byte-identical ledgers, the same health events and
the same conformance report; a fault-free soak emits no event in either.
Beside it: ``report --compare-chaos``, ``health`` and ``contend
--synthetic`` against JAX's output, a ``corrupt`` fault caught through the
selftest, ``hook_fail`` surviving as an event of local rank 0 alone, a
real-timing ``skew`` fault caught across a gloo world of 2, and the
conformance judge on crafted ledgers.
"""

import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_perf import cli as jcli
from tpu_perf.faults import run_conformance as jrun
from tpu_perf.faults.conformance import report_to_json as jjson
from tpu_perf.faults.conformance import report_to_markdown as jmd
from tpu_perf.health.events import HealthEvent as JEvent

from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.faults import FaultSpec, run_conformance
from tpu_perf_torch.faults.conformance import report_to_json, report_to_markdown
from tpu_perf_torch.health.events import HealthEvent
from tpu_perf_torch.schema import LegacyRow

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240

SPEC = {"faults": [
    {"kind": "spike", "op": "ring", "nbytes": 32, "start": 60, "end": 80,
     "magnitude": 30.0},
    {"kind": "drop_run", "op": "ring", "nbytes": 8, "start": 81, "end": 120},
    {"kind": "hook_fail", "start": 130, "end": 135},
    {"kind": "delay", "op": "ring", "nbytes": 32, "start": 150, "end": 400,
     "magnitude": 3.0},
    {"kind": "flatline", "op": "ring", "nbytes": 8, "start": 200, "end": 400},
]}
FLAGS = ["--max-runs", "400", "--synthetic", "0.001", "--op", "ring",
         "--sweep", "8,32", "-i", "1", "--stats-every", "20",
         "--health-warmup", "20"]
TORCH = ["--device", "cpu", "--sim-ranks", "8"]


def _soak(main, folder, spec=SPEC, seed=7, extra=()):
    args = ["chaos", "--seed", str(seed), *FLAGS, "-l", str(folder), *extra]
    if spec is not None:
        path = folder.parent / f"{folder.name}.json"
        path.write_text(json.dumps(spec))
        args += ["--faults", str(path)]
    assert main(args) == 0
    return folder


def _ledger(folder) -> str:
    return "".join(p.read_text() for p in sorted(folder.glob("chaos-*.log")))


def _events(folder) -> list[tuple]:
    out = []
    for p in sorted(folder.glob("health-*.log")):
        for ln in p.read_text().splitlines():
            e = json.loads(ln)
            out.append((e["kind"], e["op"], e["nbytes"], e["run_id"],
                        e["severity"], e["observed"], e["baseline"],
                        e["window"], e["unit"]))
    return out


@pytest.fixture(scope="module")
def twin(eight_devices, tmp_path_factory):
    root = tmp_path_factory.mktemp("twin")
    return {"jax": _soak(jcli.main, root / "jax"),
            "torch": _soak(cli.main, root / "torch", extra=TORCH)}


def test_the_twins_ledgers_are_byte_identical(twin):
    got = _ledger(twin["torch"])
    assert got and got == _ledger(twin["jax"])


def test_the_twins_events_match(twin):
    got = _events(twin["torch"])
    assert got == _events(twin["jax"])
    assert {e[0] for e in got} == {"spike", "capture_loss", "hook_fail",
                                   "regression", "flatline"}


@pytest.mark.parametrize("fmt", ["markdown", "json"])
def test_the_twins_conformance_reports_are_identical(twin, capsys, fmt):
    assert jcli.main(["chaos", "verify", str(twin["jax"]), "--format",
                      fmt]) == 0
    want = capsys.readouterr().out
    assert cli.main(["chaos", "verify", str(twin["torch"]), "--format",
                     fmt]) == 0
    got = capsys.readouterr().out
    assert got == want
    if fmt == "markdown":
        assert "5/5 fault(s) caught, 0 critical miss(es), 0 false " \
               "alarm(s)" in got


def test_the_twins_rows_carry_chaos_mode(twin):
    from tpu_perf_torch.report import read_rows

    rows = read_rows(sorted(str(p) for p in twin["torch"].glob("tpu-*.log")))
    assert rows and {r.mode for r in rows} == {"chaos"}
    assert {r.backend for r in rows} == {"torch-sim"}


def test_health_replay_of_the_twin_is_jaxs(twin, capsys):
    for fmt in ("markdown", "json"):
        assert jcli.main(["health", str(twin["torch"]), "--format",
                          fmt]) == 0
        want = capsys.readouterr().out
        assert cli.main(["health", str(twin["torch"]), "--format",
                         fmt]) == 0
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("seed", [7, 8])
def test_a_seed_reproduces_its_ledger(tmp_path, seed):
    spec = {"faults": SPEC["faults"] + [
        {"kind": "jitter", "op": "ring", "shape": "lognormal",
         "magnitude": 0.1, "start": 1}]}
    a = _soak(cli.main, tmp_path / "a", spec=spec, seed=seed, extra=TORCH)
    b = _soak(cli.main, tmp_path / "b", spec=spec, seed=seed, extra=TORCH)
    c = _soak(cli.main, tmp_path / "c", spec=spec, seed=seed + 1,
              extra=TORCH)
    assert _ledger(a) == _ledger(b) != _ledger(c)


@pytest.mark.parametrize("main", ["jax", "torch"])
def test_a_fault_free_soak_raises_no_event(eight_devices, tmp_path, capsys,
                                           main):
    run = jcli.main if main == "jax" else cli.main
    extra = () if main == "jax" else TORCH
    folder = _soak(run, tmp_path / main, spec=None, extra=extra)
    assert not list(folder.glob("health-*.log"))
    assert _ledger(folder)  # the meta record: it injected nothing
    capsys.readouterr()
    assert run(["chaos", "verify", str(folder),
                "--fail-on-false-alarm"]) == 0
    assert "0 false alarm(s) over 0 event(s)" in capsys.readouterr().out


def test_compare_chaos_is_jaxs(eight_devices, tmp_path, capsys):
    """A delay soak and a clean control in one folder: --compare-chaos
    renders the same table from either package's soaks."""
    delay = {"faults": [{"kind": "delay", "op": "ring", "nbytes": 32,
                         "start": 1, "magnitude": 3.0}]}
    outs = {}
    for side, run, extra in (("jax", jcli.main, ()),
                             ("torch", cli.main, TORCH)):
        folder = tmp_path / side
        for spec in (delay, None):
            args = ["chaos", "--seed", "7", "--max-runs", "60",
                    "--synthetic", "0.001", "--op", "ring", "--sweep",
                    "8,32", "-i", "1", "--stats-every", "20",
                    "--health-warmup", "20", "-l", str(folder), *extra]
            if spec is not None:
                path = tmp_path / f"{side}.json"
                path.write_text(json.dumps(spec))
                args += ["--faults", str(path)]
            assert run(args) == 0
        capsys.readouterr()
        assert run(["report", str(folder), "--compare-chaos"]) == 0
        outs[side] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]
    ring32 = [ln for ln in outs["torch"].splitlines()
              if ln.startswith("| ring | 32 |")]
    assert ring32 and " | 4 |" in ring32[0]
    assert cli.main(["report", str(tmp_path / "torch"), "--compare-chaos",
                     "--format", "json"]) == 2
    clean = tmp_path / "clean"
    _soak(cli.main, clean, spec=None, extra=TORCH)
    capsys.readouterr()
    assert cli.main(["report", str(clean), "--compare-chaos"]) == 1
    assert "no chaos-mode rows" in capsys.readouterr().err


def _csv_rows(out: str) -> list[list[str]]:
    lines = [ln for ln in out.splitlines() if ln and not
             ln.startswith("timestamp,")]
    return [ln.split(",") for ln in lines]


@pytest.mark.parametrize("load", ["hbm_stream", "allreduce"])
def test_contend_synthetic_gives_jaxs_numbers(eight_devices, capsys, load):
    args = ["contend", "--synthetic", "0.001", "--seed", "3", "--mesh", "8",
            "--op", "allreduce", "--load", load, "--sweep", "4K,64K", "-i",
            "2", "-r", "4", "--csv"]
    assert jcli.main(args) == 0
    want = _csv_rows(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = _csv_rows(capsys.readouterr().out)
    # op, nbytes, iters, run_id, n_devices, lat_us, algbw, busbw, time_ms,
    # dtype, mode, and the trailing stream and load columns
    cols = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, -2, -1]
    assert [[r[i] for i in cols] for r in got] == \
        [[r[i] for i in cols] for r in want]
    assert len(got) == 16


def test_contend_synthetic_needs_a_mesh(capsys):
    assert cli.main(["contend", "--synthetic", "0.001", "--load",
                     "hbm_stream", "--device", "cpu"]) == 2
    assert "--mesh" in capsys.readouterr().err


def test_a_corrupt_fault_is_caught_by_the_selftest(tmp_path, capsys):
    """The selftest flips a bit of the host copy of pl_allreduce's output;
    the read-back validation fails and verify judges the fault caught."""
    folder = tmp_path / "logs"
    assert cli.main(["chaos", "--fault", "corrupt:pl_allreduce", "--seed",
                     "5", "--synthetic", "0.001", "--max-runs", "4",
                     "--op", "pl_allreduce", "-b", "4K", "-i", "1",
                     "-l", str(folder), *TORCH]) == 0
    err = capsys.readouterr().err
    assert "pl_allreduce  FAIL" in err
    recs = [json.loads(ln) for ln in _ledger(folder).splitlines()]
    (flip,) = [r for r in recs if r.get("record") == "fault"]
    (st,) = [r for r in recs if r.get("record") == "selftest"]
    assert flip["kind"] == "corrupt" and flip["bit"] == 62
    assert st["status"] == "fail" and st["op"] == "pl_allreduce"
    assert cli.main(["chaos", "verify", str(folder)]) == 0
    assert "1/1 fault(s) caught" in capsys.readouterr().out


def test_the_corrupt_bit_is_jaxs():
    """The flipped element and bit of one output, in either injector."""
    import numpy as np

    from tpu_perf.faults import FaultInjector as JInjector
    from tpu_perf.faults import FaultSpec as JSpec
    from tpu_perf_torch.faults import FaultInjector

    out = np.arange(8192, dtype=np.float32).reshape(8, -1)
    a = JInjector([JSpec(kind="corrupt", op="pl_allreduce")], seed=5)
    b = FaultInjector([FaultSpec(kind="corrupt", op="pl_allreduce")], seed=5)
    ga, gb = a.corrupt_payload("pl_allreduce", out), \
        b.corrupt_payload("pl_allreduce", out)
    assert np.array_equal(ga, gb) and not np.array_equal(gb, out.ravel())
    assert out[0, 1] == 1.0  # the caller's array is never touched


def test_a_hook_failure_survives_as_a_health_event(tmp_path):
    reached = []
    err = io.StringIO()
    opts = Options(op="ring", iters=1, num_runs=-1, buff_sz=32,
                   logfolder=str(tmp_path), stats_every=5, health=True,
                   health_warmup=30, max_runs=8,
                   faults=[FaultSpec(kind="hook_fail", start=3, end=4)],
                   synthetic_s=1e-3, device="cpu", sim_ranks=8)
    drv = Driver(opts, err=err, on_rotate=lambda: reached.append(1))
    drv.run()
    assert reached == []  # armed for the whole short soak's rotation
    assert drv.log.hook_failures == 1
    (health_log,) = tmp_path.glob("health-*.log")
    events = [json.loads(ln) for ln in health_log.read_text().splitlines()]
    assert [(e["kind"], e["run_id"]) for e in events] == [("hook_fail", 3)]
    assert "warning hook_fail: ingest_hook" in err.getvalue()


@pytest.mark.parametrize("kw,match", [
    (dict(faults=[FaultSpec(kind="skew", op="ring", magnitude=500.0)]),
     "no peer process exists"),
    (dict(faults=[FaultSpec(kind="skew", op="ring", magnitude=500.0)],
          fence="fused", num_runs=3, max_runs=None),
     "finite --fence fused"),
])
def test_real_timing_skew_the_world_cannot_show_is_refused(kw, match):
    base = dict(op="ring", iters=1, num_runs=-1, buff_sz=32, max_runs=4,
                device="cpu", sim_ranks=8)
    with pytest.raises(ValueError, match=match):
        Driver(Options(**{**base, **kw}), err=io.StringIO())


def test_synthetic_skew_models_the_victims_wait(tmp_path):
    """One process, --synthetic: the modeled arrival wait lands in the
    samples, a regression fires and verify catches the skew fault."""
    spec = {"faults": [{"kind": "skew", "op": "ring", "magnitude": 5000.0,
                        "start": 61, "end": 200}]}
    folder = _soak(cli.main, tmp_path / "skew", spec=spec, extra=TORCH)
    assert any(e[0] == "regression" for e in _events(folder))
    assert cli.main(["chaos", "verify", str(folder)]) == 0


def test_chaos_runs_serially_under_streams(tmp_path):
    err = io.StringIO()
    opts = Options(op="ring,exchange", iters=1, num_runs=-1, max_runs=6,
                   buff_sz=32, streams=2, synthetic_s=1e-3, faults=[],
                   device="cpu", sim_ranks=8)
    Driver(opts, err=err).run()
    assert "overlapped dispatch (--streams) bypassed" in err.getvalue()


@pytest.mark.parametrize("argv,rc,said", [
    (["chaos", "--backend", "mpi", "--max-runs", "1"], 2, "torch backend"),
    # the push plane is ported: what it still refuses is JAX's (the ids
    # are the cases' names from before the port)
    pytest.param(["run", "--push", "http://localhost:9", "--backend", "mpi",
                  "--device", "cpu"], 2,
                 "rides the torch driver's record plane",
                 id="argv1-2-item 3b"),
    pytest.param(["monitor", "--push-queue", "8", "--device", "cpu"], 2,
                 "push_queue sizes the push plane's tee queue",
                 id="argv2-2-item 3b"),
])
def test_chaos_and_push_refusals(argv, rc, said, capsys):
    assert cli.main(argv) == rc
    assert said in capsys.readouterr().err


def test_chaos_verify_finds_no_ledger(tmp_path, capsys):
    assert cli.main(["chaos", "verify", str(tmp_path)]) == 1
    assert "no chaos ledger" in capsys.readouterr().err


# --- the judge on crafted ledgers, both packages ------------------------


def _meta(faults, stats_every=20, seed=7):
    return {"record": "meta", "seed": seed, "stats_every": stats_every,
            "synthetic_s": None, "faults": faults}


def _fault(spec, kind, run_id, op="ring", nbytes=32):
    return {"record": "fault", "spec": spec, "kind": kind, "op": op,
            "nbytes": nbytes, "run_id": run_id, "window": (run_id - 1) // 20}


def _event(kind, run_id, op="ring", nbytes=32, severity="warning", rank=0):
    return dict(timestamp="ts", job_id="j", kind=kind, severity=severity,
                op=op, nbytes=nbytes, dtype="float32", run_id=run_id,
                window=(run_id - 1) // 20, observed=2.0, baseline=1.0,
                rank=rank)


def _span(kind, sid, t0, dur, **attrs):
    return {"record": "span", "job_id": "j", "span_id": sid,
            "parent_id": None, "rank": 0, "thread": "main",
            "t_start_ns": t0, "dur_ns": dur, "kind": kind, "attrs": attrs}


CASES = {
    "caught-missed-false-alarm": (
        [_meta([{"kind": "delay", "op": "ring", "nbytes": 32, "start": 10,
                 "end": 30},
                {"kind": "spike", "op": "ring", "nbytes": 32, "start": 40,
                 "end": 45}]),
         _fault(0, "delay", 10), _fault(0, "delay", 12),
         _fault(1, "spike", 40)],
        [_event("regression", 14), _event("recovered", 35, severity="info"),
         _event("flatline", 90, op="halo", nbytes=8)], {}),
    "grace": (
        [_meta([{"kind": "drop_run", "op": "ring", "start": 10,
                 "end": 20}]),
         _fault(0, "drop_run", 10, nbytes=0),
         _fault(0, "drop_run", 20, nbytes=0)],
        [_event("capture_loss", 40, nbytes=0)], {"grace_runs": 5}),
    "rank-filtered": (
        [_meta([{"kind": "delay", "op": "ring", "nbytes": 32, "start": 10,
                 "end": 30, "rank": 1}]), _fault(0, "delay", 10)],
        [_event("regression", 14), _event("regression", 16, rank=1)], {}),
    "skew-any-rank": (
        [_meta([{"kind": "skew", "op": "ring", "nbytes": 0, "start": 10,
                 "end": 30, "rank": 1, "magnitude": 500.0}]),
         _fault(0, "skew", 10, nbytes=8)],
        [_event("regression", 14, nbytes=8, rank=0)], {}),
    "never-fired": (
        [_meta([{"kind": "delay", "op": "ring", "start": 10**6}])],
        [_event("regression", 14)], {}),
    "jitter-n/a": (
        [_meta([{"kind": "jitter", "op": "ring", "magnitude": 0.2}]),
         _fault(0, "jitter", 5)], [], {}),
    "corrupt": (
        [_meta([{"kind": "corrupt", "op": "ring"}]),
         {"record": "selftest", "op": "ring", "status": "fail",
          "detail": "1/64 elements off"}], [], {}),
    "concurrent-activity": (
        [_meta([{"kind": "spike", "op": "ring", "nbytes": 32, "start": 40,
                 "end": 45}]), _fault(0, "spike", 40)], [],
        {"spans": [_span("run", "r40", 1000, 500, run_id=40, op="ring",
                         nbytes=32),
                   _span("ingest_hook", "m9", 900, 800),
                   _span("rotate", "m10", 5000, 100, run_id=41)]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_judge_is_jaxs(case):
    records, events, kw = CASES[case]
    got = run_conformance(records, [HealthEvent(**e) for e in events], **kw)
    want = jrun(records, [JEvent(**e) for e in events], **kw)
    assert report_to_markdown(got) == jmd(want)
    assert report_to_json(got) == jjson(want)


def test_the_conformance_textfile_is_jaxs(twin, tmp_path):
    outs = []
    for main, folder in ((jcli.main, twin["jax"]), (cli.main, twin["torch"])):
        prom = tmp_path / f"{len(outs)}.prom"
        assert main(["chaos", "verify", str(folder), "--textfile",
                     str(prom)]) == 0
        outs.append([ln for ln in prom.read_text().splitlines()
                     if "last_verify_timestamp_seconds " not in ln])
    assert outs[0] == outs[1]
    assert "tpu_perf_chaos_missed_critical 0" in outs[1]


def test_verify_exits_5_on_a_missed_critical_fault(tmp_path, capsys):
    records = [_meta([{"kind": "delay", "op": "ring", "start": 10,
                       "end": 30}]), _fault(0, "delay", 10)]
    ledger = tmp_path / "chaos-u-0-x.log"
    ledger.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert cli.main(["chaos", "verify", str(tmp_path)]) == 5
    assert "critical fault(s) MISSED" in capsys.readouterr().err
    (tmp_path / "health-u-0-x.log.open").write_text(
        json.dumps(_event("regression", 14)) + "\n")
    assert cli.main(["chaos", "verify", str(ledger)]) == 0
    assert "1/1 fault(s) caught" in capsys.readouterr().out


# --- a gloo world of 2: skew and hook_fail with real timing -------------

_WORKER = """
import json, sys
from tpu_perf_torch import cli
sys.exit(cli.main(["chaos", "--distributed", "--device", "cpu",
                   "--faults", sys.argv[1], "--op", "allreduce", "-b", "4K",
                   "-i", "2", "--max-runs", "200", "--stats-every", "20",
                   "--health-warmup", "60", "-l", sys.argv[2]]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_skew_fault_is_caught_across_a_gloo_world(tmp_path, capsys):
    """Rank 1 enters each allreduce of runs 61-200 late by up to 20 ms;
    rank 0 waits for it inside the collective, so its samples regress and
    chaos verify catches the fault.  The detectors warm up over runs 1-60,
    the runs before the skew: no episode can open before the window, so
    one the host's noise opened cannot stand through it and hide the
    skew's.  A hook_fail fault fails the ingest hook of local rank 0, the
    one process of the node that fires it."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"faults": [
        {"kind": "skew", "op": "allreduce", "rank": 1, "magnitude": 20000.0,
         "start": 61, "end": 200},
        {"kind": "hook_fail", "start": 40, "end": 41}]}))
    logs = tmp_path / "logs"
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(spec), str(logs)], cwd=REPO,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        f"rank {r} rc {p.returncode}:\n{err[-2000:]}"
        for r, (p, (_, err)) in enumerate(zip(procs, outs)))
    events = []
    for p in logs.glob("health-*.log"):
        events += [json.loads(ln) for ln in p.read_text().splitlines()]
    regressions = {e["rank"] for e in events if e["kind"] == "regression"
                   and 61 <= e["run_id"] <= 240}
    # the victim's own samples carry the wait
    told = [(e["rank"], e["kind"], e["severity"], e["run_id"],
             e["observed"], e["baseline"]) for e in events]
    assert 0 in regressions, told
    # and the wait is the skew's: each window run's time follows the
    # straggler's drawn stagger for it in the ledger (a loaded host's
    # noise can raise regressions in the window too, but not this)
    stagger = {}
    for p in logs.glob("chaos-*.log"):
        for ln in p.read_text().splitlines():
            r = json.loads(ln)
            if r.get("kind") == "skew" and r.get("stagger_us", 0) > 0:
                stagger[r["run_id"]] = r["stagger_us"]
    took = {}
    for p in logs.glob("tcp-*.log"):
        for ln in p.read_text().splitlines():
            row = LegacyRow.from_csv(ln)
            if row.rank == 0:
                took[row.run_id] = row.time_taken_ms
    runs = sorted(set(stagger) & set(took))
    assert len(runs) >= 100, (len(stagger), len(took))
    rank = lambda v: np.argsort(np.argsort(v))  # noqa: E731
    rho = np.corrcoef(rank([stagger[r] for r in runs]),
                      rank([took[r] for r in runs]))[0, 1]
    assert rho > 0.3, (rho, told)
    hooks = [(e["rank"], e["run_id"]) for e in events
             if e["kind"] == "hook_fail"]
    assert hooks == [(0, 40)]
    capsys.readouterr()
    assert cli.main(["chaos", "verify", str(logs)]) == 0
    assert "2/2 fault(s) caught" in capsys.readouterr().out


def test_adaptive_sampling_is_bypassed_under_chaos():
    err = io.StringIO()
    opts = Options(op="ring", iters=1, num_runs=20, buff_sz=32,
                   ci_rel=0.05, synthetic_s=1e-3, faults=[], device="cpu",
                   sim_ranks=8)
    rows = Driver(opts, err=err).run()
    assert "bypassed under --faults/--synthetic" in err.getvalue()
    assert len(rows) == 20 and {r.runs_requested for r in rows} == {0}
