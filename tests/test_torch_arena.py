"""The collective-algorithm arena (``tpu_perf_torch.arena``) against the JAX
package's on its eight virtual CPU devices.

Every (collective, algorithm) pair of the registry runs at n = 8 and, where
it allows it, n = 6 (rhd needs a power of two: JAX's refusal and ours read
alike), at 150, 4100 and 262148 B a rank.  The port's schedules are the
JAX package's in the stacked per-device view (a row permutation a
``ppermute``), so the outputs are held against JAX's: exactly for int32
and the byte-moving collectives, and within ``tests/test_arena.py``'s
``_RTOL`` (float32 5e-6, bfloat16 5e-2) for the float sums, though they
add in JAX's order and come out equal here.  On an integer-valued float
fill every sum is exact, so there the arena's algorithms equal the native
op exactly too.  The hierarchical ``hier*`` compositions run on a 2 x 4
sim mesh; gloo worlds of 2 and 4 processes run the ring and binomial
allreduce and an allgatherv at ratio 8 across processes, one
``batch_isend_irecv`` a permutation.
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

import tpu_perf.arena as jarena
import tpu_perf.arena.hierarchy as jhier
import tpu_perf.runner as jrunner
from tpu_perf.config import Options as JOptions
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh as jax_make_mesh

import tpu_perf_torch.arena as tarena
import tpu_perf_torch.arena.hierarchy as thier
from tpu_perf_torch import runner as trunner
from tpu_perf_torch.config import Options
from tpu_perf_torch.ops.collectives import build_op
from tpu_perf_torch.parallel import make_mesh
from tpu_perf_torch.world import SimWorld

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ITERS = 2
#: tests/test_arena.py's tolerances for a float sum in another order
_RTOL = {"float32": 5e-6, "bfloat16": 5e-2}
#: every (size, dtype) a pair runs at: float32 at the three sizes, the
#: other two words at the middle one
CASES = [(150, "float32"), (4100, "float32"), (262148, "float32"),
         (4100, "bfloat16"), (4100, "int32")]
WORKER_TIMEOUT_S = 240


def _pairs():
    out = []
    for coll, algo in sorted(jarena.ARENA_ALGORITHMS):
        for n in (8, 6):
            for nbytes, dtype in CASES:
                out.append((coll, algo, n, nbytes, dtype))
    return out


def _jax_mesh(n, devices):
    return jax_make_mesh(devices=devices[:n])


def _held(got, want, dtype):
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_RTOL[dtype], atol=0)


def _run_ours(built):
    return built.step(built.example_input).float().numpy()


@pytest.mark.parametrize("coll,algo,n,nbytes,dtype", _pairs())
def test_every_pair_of_the_registry_is_jaxs(coll, algo, n, nbytes, dtype,
                                            eight_devices):
    world = SimWorld(n, CPU)
    try:
        jb = jax_build_op(coll, _jax_mesh(n, eight_devices), nbytes, ITERS,
                          dtype=dtype, algo=algo)
    except ValueError as theirs:
        # rhd at 6 ranks, a sum in int32: refused alike
        with pytest.raises(ValueError) as ours:
            build_op(coll, world, nbytes, ITERS, dtype=dtype, algo=algo)
        assert str(ours.value) == str(theirs)
        return
    pb = build_op(coll, world, nbytes, ITERS, dtype=dtype, algo=algo)
    assert (pb.nbytes, pb.n_devices, pb.iters, pb.algo) == \
        (jb.nbytes, jb.n_devices, jb.iters, jb.algo)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    np.testing.assert_array_equal(
        pb.example_input.double().numpy().reshape(-1), x.reshape(-1))
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    _held(_run_ours(pb), want, dtype)


def _int_fill(shape):
    return (np.arange(int(np.prod(shape))) % 7).astype(np.float32).reshape(
        shape)


@pytest.mark.parametrize("coll,algo", sorted(
    (c, a) for c, a in jarena.ARENA_ALGORITHMS
    if c in ("allreduce", "reduce_scatter")))
def test_on_an_integer_valued_fill_every_sum_equals_native_and_jax(
        coll, algo, eight_devices):
    # every partial sum of small integers is exact in float32, so the
    # order of addition cannot show: the algorithm is the native op
    world = SimWorld(8, CPU)
    pb = build_op(coll, world, 4096, ITERS, algo=algo)
    native = build_op(coll, world, 4096, ITERS)
    x = _int_fill(tuple(pb.example_input.shape))
    got = pb.step(torch.from_numpy(x.copy())).numpy()
    want_native = native.step(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, want_native)
    jb = jax_build_op(coll, _jax_mesh(8, eight_devices), 4096, ITERS,
                      algo=algo)
    jx = jax.device_put(x.reshape(-1), jb.example_input.sharding)
    np.testing.assert_array_equal(
        got.reshape(-1), np.asarray(jax.device_get(jb.step(jx))))


def test_the_registries_are_jaxs():
    assert tarena.ALGORITHM_NAMES == jarena.ALGORITHM_NAMES
    assert tarena.ARENA_COLLECTIVES == jarena.ARENA_COLLECTIVES
    assert set(tarena.ARENA_ALGORITHMS) == set(jarena.ARENA_ALGORITHMS)
    assert set(tarena.V_ALGORITHMS) == set(jarena.V_ALGORITHMS)
    assert set(thier.HIER_ALGORITHMS) == set(jhier.HIER_ALGORITHMS)
    from tpu_perf.arena.algorithms import POW2_ONLY as jpow2

    from tpu_perf_torch.arena.algorithms import POW2_ONLY

    assert POW2_ONLY == jpow2
    for coll in tarena.ARENA_COLLECTIVES:
        assert tarena.algorithms_for(coll) == jarena.algorithms_for(coll)
        assert thier.hier_bases_for(coll) == jhier.hier_bases_for(coll)
        for n in (2, 3, 6, 8):
            for algo in tarena.ALGORITHM_NAMES:
                assert (tarena.is_compatible(coll, algo, n)
                        == jarena.is_compatible(coll, algo, n))
            assert tarena.algos_for_op(coll, n) == jarena.algos_for_op(coll,
                                                                       n)


@pytest.mark.parametrize("coll,base", sorted(jhier.HIER_ALGORITHMS))
@pytest.mark.parametrize("nbytes", [150, 4100])
def test_hier_on_a_2x4_mesh_is_jaxs(coll, base, nbytes, eight_devices):
    mesh = jax_make_mesh((2, 4), ("dcn", "ici"), devices=eight_devices)
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    jb = jax_build_op(coll, mesh, nbytes, ITERS, algo=base)
    pb = build_op(coll, world, nbytes, ITERS, algo=base)
    assert (pb.nbytes, pb.algo) == (jb.nbytes, jb.algo)
    assert pb.algo == f"{base}:dcn=2+ici=4"
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    _held(_run_ours(pb), want, "float32")


@pytest.mark.parametrize("coll,base", [
    ("allreduce", "hier-ring/native/bruck"),
    ("allreduce", "hier-binomial/rhd/ring"),
    ("reduce_scatter", "hier-native/ring")])
def test_a_mixed_per_phase_spelling_is_jaxs(coll, base, eight_devices):
    mesh = jax_make_mesh((2, 4), ("dcn", "ici"), devices=eight_devices)
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    jb = jax_build_op(coll, mesh, 4100, ITERS, algo=base)
    pb = build_op(coll, world, 4100, ITERS, algo=base)
    assert pb.algo == jb.algo
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    _held(_run_ours(pb), want, "float32")


@pytest.mark.parametrize("coll", ["allreduce", "all_gather",
                                  "reduce_scatter"])
@pytest.mark.parametrize("nbytes", [4096, 262144])
def test_the_bytes_per_axis_model_is_jaxs(coll, nbytes):
    pairs = (("dcn", 2), ("ici", 4))
    assert thier.phase_traffic(coll, nbytes, pairs) == [
        thier.PhaseTraffic(**vars(p))
        for p in jhier.phase_traffic(coll, nbytes, pairs)]
    assert thier.axis_bytes(coll, nbytes, pairs) == \
        jhier.axis_bytes(coll, nbytes, pairs)
    assert thier.dcn_bound_bytes(coll, nbytes, pairs) == \
        jhier.dcn_bound_bytes(coll, nbytes, pairs)
    assert thier.flat_dcn_bytes(coll, nbytes, 8) == \
        jhier.flat_dcn_bytes(coll, nbytes, 8)
    assert thier.mesh_shape_label(pairs) == jhier.mesh_shape_label(pairs)


@pytest.mark.parametrize("op,algo,mesh_axes", [
    ("allreduce", "native", None), ("allreduce", "all", None),
    ("all_gather", "ring,bruck", None), ("all_to_all", "all", None),
    ("broadcast", "all", None), ("allreduce", "hier", None),
    ("allreduce", "all", (("dcn", 2), ("ici", 4))),
    ("allgatherv", "all", None), ("seg_allreduce", "all", None),
    ("allgatherv", "all", (("dcn", 2), ("ici", 4))),
    ("reduce_scatter_v", "all", (("dcn", 2), ("ici", 4))),
    ("allreduce", "hier-ring,native", (("dcn", 2), ("ici", 4))),
])
def test_algos_for_options_expands_as_jax_does(op, algo, mesh_axes):
    n = 8
    got = trunner.algos_for_options(Options(op=op, algo=algo), op, n,
                                    mesh_axes=mesh_axes)
    want = jrunner.algos_for_options(JOptions(op=op, algo=algo), op, n,
                                     mesh_axes=mesh_axes)
    assert got == want


@pytest.mark.parametrize("op,algo,n,mesh_axes", [
    ("allreduce", "rhd", 6, None), ("allreduce", "nope", 8, None),
    ("broadcast", "ring", 8, None),
    ("allreduce", "ring", 8, (("dcn", 2), ("ici", 4))),
    ("all_to_all", "hier", 8, (("dcn", 2), ("ici", 4))),
])
def test_algos_for_options_refuses_as_jax_does(op, algo, n, mesh_axes):
    with pytest.raises(ValueError) as ours:
        trunner.algos_for_options(Options(op=op, algo=algo), op, n,
                                  mesh_axes=mesh_axes)
    with pytest.raises(ValueError) as theirs:
        jrunner.algos_for_options(JOptions(op=op, algo=algo), op, n,
                                  mesh_axes=mesh_axes)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("op,kw", [
    ("exchange", dict(algo="ring", window=2)),
    ("allreduce", dict(imbalance=2)),
    ("allgatherv", dict(imbalance=0)),
    ("allreduce", dict(algo="rhd")),
    ("reduce_scatter_v", dict(dtype="int32")),
])
def test_build_op_refuses_as_jax_does(op, kw, eight_devices):
    n = 6 if kw.get("algo") == "rhd" else 8
    with pytest.raises(ValueError) as ours:
        build_op(op, SimWorld(n, CPU), 4096, 2, **kw)
    with pytest.raises(ValueError) as theirs:
        jax_build_op(op, _jax_mesh(n, eight_devices), 4096, 2, **kw)
    # the one spelling difference: the port's command name
    assert str(ours.value).replace("tpu-perf-torch", "tpu-perf") == \
        str(theirs.value)


def test_an_algorithm_on_a_hand_written_kernel_is_refused():
    # JAX names its kernels pallas ones; the rule is the same
    with pytest.raises(ValueError, match="not the pl_\\* kernels"):
        build_op("pl_allreduce", SimWorld(8, CPU), 4096, 2, algo="ring")


def test_the_auto_tuner_flags_are_refused_naming_the_roadmap(capsys):
    # the tuner is ported: what its flags still refuse is what JAX's
    # refuse (a misused flag), and nothing names the roadmap any more
    from tpu_perf import cli as jcli
    from tpu_perf_torch import cli

    for argv, said in ((["--algo", "auto"], "--algo-artifact PATH"),
                       (["--algo-artifact", "a.json"],
                        "only with --algo auto"),
                       (["--tune-margin", "0.5"], "tune_margin"),
                       (["--tune-max-age", "-60"], "tune_max_age")):
        for main in (cli.main, jcli.main):
            assert main(["run", "--op", "allreduce", "--device", "cpu",
                         *argv] if main is cli.main else
                        ["run", "--op", "allreduce", *argv]) == 2
            err = capsys.readouterr().err
            assert said in err and "ROADMAP" not in err, argv
    assert cli.main(["contend", "--split", "1", "--op", "ppermute",
                     "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "K >= 2" in err and "ROADMAP" not in err


def test_an_arena_run_writes_jaxs_rows_and_the_crossover(tmp_path, capsys,
                                                         eight_devices):
    from tpu_perf.schema import ResultRow as JRow

    from tpu_perf_torch import cli

    assert cli.main(["arena", "--sim-ranks", "8", "--sweep", "4K,16K",
                     "-i", "2", "-r", "2", "--device", "cpu", "-l",
                     str(tmp_path)]) == 0
    (log,) = tmp_path.glob("tpu-*.log")
    rows = [JRow.from_csv(ln) for ln in log.read_text().splitlines()]
    seen = {(r.op, r.algo or "native") for r in rows}
    want = {(c, a) for c in jarena.ARENA_COLLECTIVES
            for a in ["native", *jarena.algos_for_op(c, 8)]}
    assert seen == want
    capsys.readouterr()
    assert cli.main(["report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "### Arena crossover" in out


# --- gloo worlds of 2 and 4 processes ------------------------------------

_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.parallel import initialize_distributed
    from tpu_perf_torch.world import dist_world

    cases, out = json.loads(sys.argv[1]), sys.argv[2]
    initialize_distributed(device="cpu")
    world = dist_world(torch.device("cpu"))
    got = {}
    for op, algo, imb, nbytes, dtype in cases:
        b = build_op(op, world, nbytes, 2, algo=algo, imbalance=imb,
                     dtype=dtype)
        got[f"{op}/{algo}/{imb}/{dtype}"] = {
            "x": b.example_input.double().tolist(),
            "y": b.step(b.example_input).double().tolist(),
            "nbytes": b.nbytes}
    with open(f"{out}/rank{world.rank}.json", "w") as fh:
        json.dump(got, fh)
    dist.destroy_process_group()
""")

GLOO_CASES = [("allreduce", "ring", 1, 4100, "float32"),
              ("allreduce", "binomial", 1, 4100, "float32"),
              ("all_gather", "bruck", 1, 4100, "int32"),
              ("allgatherv", "native", 8, 4100, "float32"),
              ("all_to_all_v", "ring", 2, 4100, "int32")]


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


@pytest.mark.parametrize("n", [2, 4])
def test_the_arena_across_processes_is_jaxs(n, tmp_path, eight_devices):
    _spawn(n, [sys.executable, "-c", _WORKER, json.dumps(GLOO_CASES),
               str(tmp_path)])
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(n)]
    mesh = _jax_mesh(n, eight_devices)
    for op, algo, imb, nbytes, dtype in GLOO_CASES:
        jb = jax_build_op(op, mesh, nbytes, 2, algo=algo, imbalance=imb,
                          dtype=dtype)
        x = np.asarray(jax.device_get(jb.example_input),
                       dtype=np.float64).reshape(n, -1)
        want = np.asarray(jax.device_get(jb.step(jb.example_input)),
                          dtype=np.float64).reshape(n, -1)
        for r in range(n):
            got = ranks[r][f"{op}/{algo}/{imb}/{dtype}"]
            assert got["nbytes"] == jb.nbytes
            np.testing.assert_array_equal(got["x"], x[r])
            _held(got["y"], want[r], dtype)


# --- the report's views and bench's instruments --------------------------

VIEWS = (("compare_arena", "arena_to_markdown"),
         ("hier_traffic", "hier_traffic_to_markdown"),
         ("straggler_cost", "straggler_to_markdown"),
         ("scenario_steps", "scenario_to_markdown"),
         ("imbalance_cost", "imbalance_to_markdown"))


@pytest.fixture(scope="module")
def arena_rows(tmp_path_factory):
    from tpu_perf_torch import cli

    folder = tmp_path_factory.mktemp("views")
    common = ["-i", "1", "-r", "3", "--device", "cpu", "-l", str(folder)]
    for argv in (
            ["arena", "--sim-ranks", "8", "--sweep", "4K,16K"],
            ["run", "--mesh", "2x4", "--axes", "dcn,ici", "--op",
             "allreduce,all_gather,reduce_scatter", "--algo", "all",
             "--sweep", "4K"],
            ["run", "--op", "allreduce", "--sim-ranks", "8", "-b", "4K",
             "--skew-spread", "0,200"],
            ["scenario", "moe-dispatch-combine,tp-allreduce-burst",
             "--imbalance", "1,8", "--sim-ranks", "8", "-b", "4K",
             "--algo", "ring"],
            ["run", "--op", "allgatherv,all_to_all_v", "--algo", "all",
             "--imbalance", "1,2,8", "--sim-ranks", "8", "-b", "4K"]):
        assert cli.main(argv + common) == 0
    return [ln for p in sorted(folder.glob("tpu-*.log"))
            for ln in p.read_text().splitlines()]


@pytest.mark.parametrize("table,render", VIEWS)
def test_each_new_report_view_is_jaxs_on_the_same_rows(table, render,
                                                       arena_rows):
    import tpu_perf.report as jreport
    from tpu_perf.schema import ResultRow as JRow

    import tpu_perf_torch.report as treport
    from tpu_perf_torch.schema import ResultRow

    ours = treport.aggregate([ResultRow.from_csv(ln) for ln in arena_rows])
    # the same rows under the JAX package's backend name
    theirs = jreport.aggregate([
        JRow.from_csv(ln.replace(",torch-sim,", ",jax,"))
        for ln in arena_rows])
    got = getattr(treport, table)(ours)
    want = getattr(jreport, table)(theirs)
    assert got, table
    assert getattr(treport, render)(got) == getattr(jreport, render)(want)


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__ in ("int", "float", "str")


def test_bench_names_the_new_instruments_with_jaxs_keys(eight_devices):
    import tpu_perf.bench as jbench

    from tpu_perf_torch import bench

    pairs = (
        (bench.hier_vs_flat(CPU, sizes=(4096,), runs=2, iters=1),
         jbench._hier_vs_flat(sizes=(4096,), runs=2, iters=1)),
        (bench.scenario_step(CPU, sizes=(4096,), runs=2, iters=1),
         jbench._scenario_step(sizes=(4096,), runs=2, iters=1)),
        (bench.vopt_vs_ring(CPU, sizes=(4096,), runs=2, iters=1),
         jbench._vopt_vs_ring(sizes=(4096,), runs=2, iters=1)),
        (bench.push_overhead(200), jbench._push_overhead(200)))
    for ours, theirs in pairs:
        assert _keys(ours) == _keys(theirs)
    hier, _ = pairs[0]
    assert hier["algo"] == "hier:dcn=2+ici=4" and hier["mesh"] == "2x(4)"
    assert pairs[3][0]["concurrent_dropped"] == 0
