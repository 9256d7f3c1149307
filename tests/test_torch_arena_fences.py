"""Point-to-point schedules across processes under the device fences.

An arena step (an algorithm, a v-op, a scenario) and the native
point-to-point ops run their permutations as ``batch_isend_irecv`` calls
across processes.  On a card ``--fence fused`` and ``--fence trace``
capture them into CUDA graphs; on the CPU (gloo) a fused chunk runs
eagerly and the trace fence refuses, as it does in a one-process sim
world.  Gloo worlds of 2 and 4 processes run every case through the CLI
under ``--fence fused``: each exits 0, its rows are the same on every
rank, ``tpu_perf.schema`` parses them, and their keys are the JAX
driver's for the same options on as many of its virtual CPU devices.
Each case's fused chunk ends on the JAX package's step chain from the
same seeded input: exactly for int32 and the byte-moving ops, within
``tests/test_arena.py``'s float32 ``_RTOL`` (5e-6) for the float sums.

Capture asks that a schedule's second call make no process group
(``new_group`` is a collective of the whole world) and copy no host
list to the device: the warm run makes both, once.  The recorder below
counts both on the second call of each case.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tpu_perf.scenarios.compose as jcompose
import tpu_perf.scenarios.spec as jspec
from tpu_perf.config import Options as JOptions
from tpu_perf.driver import Driver as JDriver
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh as jax_make_mesh
from tpu_perf.schema import ResultRow as JRow

from tpu_perf_torch.config import Options
from tpu_perf_torch.parallel import make_mesh
from tpu_perf_torch.runner import build_point_pair
from tpu_perf_torch.timing import FusedPoint
from tpu_perf_torch.world import DistWorld

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
NBYTES, ITERS, RUNS = 4096, 3, 3
#: tests/test_arena.py's tolerance for a float32 sum in another order
_RTOL = 5e-6
WORKER_TIMEOUT_S = 240


def _cli_runs(n: int) -> list[tuple[str, list[str], dict]]:
    """(name, the port's argv, the JAX driver's options) of each CLI run
    in a world of ``n``."""
    algos = "ring,binomial" + (",rhd" if n == 4 else "")
    common = ["-b", str(NBYTES), "-i", str(ITERS), "-r", str(RUNS),
              "--fence", "fused"]
    jcommon = dict(sweep=str(NBYTES), iters=ITERS, num_runs=RUNS,
                   fence="fused")
    return [
        ("algos", ["run", "--op", "allreduce", "--algo", algos, *common],
         dict(op="allreduce", algo=algos, **jcommon)),
        ("vop", ["run", "--op", "allgatherv", "--imbalance", "8", "--algo",
                 "all", *common],
         dict(op="allgatherv", imbalance=(8,), algo="all", **jcommon)),
        ("scenario", ["scenario", "tp-allreduce-burst", *common],
         dict(op="scenario", scenario=("tp-allreduce-burst",), **jcommon)),
        ("p2p", ["run", "--op", "ring,pingpong", *common],
         dict(op="ring,pingpong", **jcommon)),
    ]


def _chain_cases(n: int) -> list[tuple[str, str, int, str]]:
    """(op, algo, imbalance, dtype) of each fused chunk held against
    JAX's chain ("scenario" ops name the scenario in ``algo``)."""
    cases = [("allreduce", "ring", 1, "float32"),
             ("allreduce", "binomial", 1, "float32"),
             ("allgatherv", "native", 8, "float32"),
             ("allgatherv", "doubling", 8, "int32"),
             ("allgatherv", "sortring", 8, "float32"),
             ("scenario", "tp-allreduce-burst", 1, "float32"),
             ("ring", "native", 1, "float32"),
             ("pingpong", "native", 1, "float32")]
    if n == 4:
        cases.append(("allreduce", "rhd", 1, "float32"))
    return cases


_WORKER = textwrap.dedent("""
    import contextlib, io, json, sys
    import torch
    import torch.distributed as dist
    from tpu_perf_torch import cli
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.parallel import initialize_distributed, make_mesh
    from tpu_perf_torch.runner import build_fused_point
    from tpu_perf_torch.scenarios.compose import build_scenario_op
    from tpu_perf_torch.scenarios.spec import BUILTIN_SCENARIOS
    from tpu_perf_torch.timing import FusedRunner
    from tpu_perf_torch.world import dist_world

    runs, cases, out = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                        sys.argv[3])
    nbytes, iters, reps = (int(v) for v in sys.argv[4:7])
    initialize_distributed(device="cpu")
    world = dist_world(torch.device("cpu"))
    n = world.n
    got = {"rc": {}, "chains": {}, "calls": {}}
    for name, argv in runs:
        got["rc"][name] = cli.main(argv + ["--distributed", "--device",
                                           "cpu", "-l", f"{out}/{name}"])
    # the trace fence needs a card: refused here as in one process
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["run", "--op", "allreduce", "--algo", "ring", "-b",
                       str(nbytes), "--fence", "trace", "--distributed",
                       "--device", "cpu"])
    got["trace"] = [rc, err.getvalue()]

    def build(w, op, algo, imb, dtype):
        if op == "scenario":
            return build_scenario_op(BUILTIN_SCENARIOS[algo], w, nbytes,
                                     iters, dtype=dtype, imbalance=imb)
        return build_op(op, w, nbytes, iters, algo=algo, imbalance=imb,
                        dtype=dtype)

    for op, algo, imb, dtype in cases:
        b = build(world, op, algo, imb, dtype)
        # two chunk sizes, two graphs on a card: the warm-up runs the
        # first eagerly, the measured chunk is the second
        runner = FusedRunner(build_fused_point(b, (reps, reps - 1)), b)
        try:
            runner.warm()
            runner.chunk(reps - 1)
            y = runner.buffer.double().tolist()
        finally:
            runner.close()
        got["chains"][f"{op}/{algo}/{imb}/{dtype}"] = {
            "x": b.example_input.double().tolist(), "y": y,
            "nbytes": b.nbytes}

    # the recorder: what a schedule's second call makes
    made = {"new_group": 0, "tensor": 0}
    real = {"new_group": dist.new_group, "tensor": torch.tensor,
            "as_tensor": torch.as_tensor}

    def counted(name, key):
        def call(*a, **k):
            made[key] += 1
            return real[name](*a, **k)
        return call

    dist.new_group = counted("new_group", "new_group")
    torch.tensor = counted("tensor", "tensor")
    torch.as_tensor = counted("as_tensor", "tensor")
    try:
        recorded = [(world, op, algo, imb) for op, algo, imb, _ in cases]
        if n == 4:
            # a composition over a 2 x 2 mesh: its axis groups are made
            # by its first call
            mesh = make_mesh((2, 2), ("dcn", "ici"), n=4)
            recorded.append((dist_world(torch.device("cpu"), mesh),
                             "allreduce", "hier", 1))
        for w, op, algo, imb in recorded:
            b = build(w, op, algo, imb, "float32")
            calls = []
            for _ in range(2):
                made.update(new_group=0, tensor=0)
                b.step(b.example_input)
                calls.append(dict(made))
            got["calls"][f"{op}/{algo}/{imb}/{len(w.axis_names)}"] = calls
    finally:
        dist.new_group = real["new_group"]
        torch.tensor, torch.as_tensor = real["tensor"], real["as_tensor"]
    with open(f"{out}/rank{world.rank}.json", "w") as fh:
        json.dump(got, fh)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n, argv):
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def _rank_lines(folder: Path, rank: int) -> list[str]:
    (path,) = folder.glob(f"tpu-*-{rank}-*.log")
    return [ln for ln in path.read_text().splitlines() if ln.strip()]


def _jax_step(op, algo, imb, dtype, mesh):
    if op == "scenario":
        return jcompose.build_scenario_op(jspec.BUILTIN_SCENARIOS[algo],
                                          mesh, NBYTES, ITERS, dtype=dtype,
                                          imbalance=imb)
    return jax_build_op(op, mesh, NBYTES, ITERS, algo=algo, imbalance=imb,
                        dtype=dtype)


def _held(op, dtype, got, want):
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    sums = op in ("allreduce", "scenario")
    if dtype == "int32" or not sums:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_RTOL, atol=0)


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world_run(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"fences{n}")
    runs = [(name, argv) for name, argv, _ in _cli_runs(n)]
    _spawn(n, [sys.executable, "-c", _WORKER, json.dumps(runs),
               json.dumps(_chain_cases(n)), str(out), str(NBYTES),
               str(ITERS), str(RUNS)])
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n)]
    return n, out, ranks


def test_fused_runs_across_processes_write_jaxs_rows(world_run,
                                                     eight_devices):
    n, out, ranks = world_run
    mesh = jax_make_mesh(devices=eight_devices[:n])
    for name, _, jkw in _cli_runs(n):
        assert [r["rc"][name] for r in ranks] == [0] * n, name
        lines = [_rank_lines(out / name, r) for r in range(n)]
        # every rank's rows equal but their timestamps: each run's time
        # is its maximum over the ranks
        bodies = [[ln.split(",", 1)[1] for ln in rank] for rank in lines]
        assert all(b == bodies[0] for b in bodies), name
        rows = [JRow.from_csv(ln) for ln in lines[0]]
        assert all(r.time_ms > 0 and r.n_devices == n for r in rows), name
        theirs = JDriver(JOptions(**jkw), mesh).run()

        def keys(rs):
            return sorted((r.op, r.algo, r.nbytes, r.imbalance, r.run_id)
                          for r in rs)

        assert keys(rows) == keys(theirs), name


def test_fused_chunks_across_processes_end_on_jaxs_chain(world_run,
                                                         eight_devices):
    n, _, ranks = world_run
    mesh = jax_make_mesh(devices=eight_devices[:n])
    for op, algo, imb, dtype in _chain_cases(n):
        jb = _jax_step(op, algo, imb, dtype, mesh)
        x = jb.example_input
        want = x
        # the warm-up's eager chunk of RUNS runs, then the measured one of
        # RUNS - 1: 5 runs of 3 executions, so a ring's shifts do not
        # come back to the start at 2 or 4 ranks
        for _ in range(2 * RUNS - 1):
            want = jb.step(want)
        x = np.asarray(jax.device_get(x), dtype=np.float64).reshape(n, -1)
        want = np.asarray(jax.device_get(want),
                          dtype=np.float64).reshape(n, -1)
        if op != "pingpong":  # a round trip is the identity
            assert not np.array_equal(want, x), (op, algo)
        for r in range(n):
            got = ranks[r]["chains"][f"{op}/{algo}/{imb}/{dtype}"]
            assert got["nbytes"] == jb.nbytes
            np.testing.assert_array_equal(got["x"], x[r])
            _held(op, dtype, got["y"], want[r])


def _errors(err: str) -> list[str]:
    return [ln for ln in err.splitlines()
            if ln.startswith("tpu-perf-torch: error:")]


def test_the_trace_fence_across_processes_refuses_as_in_one_process(
        world_run, capsys):
    from tpu_perf_torch import cli

    _, _, ranks = world_run
    assert cli.main(["run", "--op", "allreduce", "--algo", "ring", "-b",
                     str(NBYTES), "--fence", "trace", "--sim-ranks", "2",
                     "--device", "cpu"]) == 2
    said = _errors(capsys.readouterr().err)
    assert len(said) == 1 and "needs a CUDA device" in said[0], said
    for r in ranks:
        assert r["trace"][0] == 2 and _errors(r["trace"][1]) == said


def test_a_schedules_second_call_makes_no_group_and_no_host_tensor(
        world_run):
    n, _, ranks = world_run
    for r in ranks:
        calls = r["calls"]
        assert len(calls) == len(_chain_cases(n)) + (n == 4)
        for key, (first, second) in calls.items():
            assert second == {"new_group": 0, "tensor": 0}, key
        # the recorder sees what the first call makes: the axis groups
        # of the 2 x 2 composition, the axis places of a schedule
        if n == 4:
            assert calls["allreduce/hier/1/2"][0]["new_group"] > 0
        assert calls["allreduce/ring/1/1"][0]["tensor"] > 0


def _dist_world(n: int = 4) -> DistWorld:
    # a rank's view, built only: building a step calls no collective
    return DistWorld(rank=0, n=n, local_rank=0, device=CPU,
                     mesh=make_mesh(n=n))


@pytest.mark.parametrize("op,algo,imb", [
    ("allreduce", "ring", 1), ("allgatherv", "doubling", 8),
    ("scenario", "moe-dispatch-combine", 8), ("ring", "native", 1)])
def test_build_point_pair_across_processes_builds_every_fence(op, algo,
                                                              imb):
    scenario = (algo,) if op == "scenario" else ()
    world = _dist_world()
    fused = Options(op=op, scenario=scenario, fence="fused", iters=ITERS,
                    num_runs=RUNS)
    built, fp = build_point_pair(fused, world, op, NBYTES, algo=algo,
                                 imbalance=imb)
    assert isinstance(fp, FusedPoint) and fp.plan == (RUNS,)
    assert built.n_devices == 4 and built.imbalance == imb
    trace = Options(op=op, scenario=scenario, fence="trace", iters=ITERS,
                    num_runs=RUNS)
    lo, hi = build_point_pair(trace, world, op, NBYTES, algo=algo,
                              imbalance=imb)
    assert hi.iters == 4 * lo.iters and hi.example_input is lo.example_input


def test_the_trace_legs_meet_the_ranks_only_across_processes():
    from tpu_perf_torch.runner import trace_align
    from tpu_perf_torch.world import SimWorld

    assert trace_align(SimWorld(4, CPU)) is None
    assert trace_align(_dist_world(1)) is None
    assert callable(trace_align(_dist_world(4)))
