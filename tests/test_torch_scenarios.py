"""The v-ops and the model-step scenarios (``tpu_perf_torch.scenarios``)
against the JAX package's on its eight virtual CPU devices.

The four v-ops run at imbalance 1, 2 and 8 with every v-schedule of the
registry, in the sim world of 8 and 6 ranks and (native) across the
whole 2 x 4 mesh; ``vhier`` on the 2 x 4 mesh.  The three built-in
scenarios and one JSON spec holding every phase op run with each inner
the catalog allows.  Counts, rows, labels and ``phase_plan`` equal JAX's;
outputs are exact for int32 and the byte-moving ops, float sums within
``tests/test_arena.py``'s ``_RTOL`` (float32 5e-6, bfloat16 5e-2: the
native psum adds in another order).  A gloo world of 2 runs the four
v-ops at 1, 2 and 8 and two scenarios across processes.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tpu_perf.arena as jarena
import tpu_perf.scenarios.compose as jcompose
import tpu_perf.scenarios.spec as jspec
import tpu_perf.scenarios.vops as jvops
from tpu_perf import config as jconfig
from tpu_perf import metrics as jmetrics
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh as jax_make_mesh
from tpu_perf.schema import ResultRow as JRow

import tpu_perf_torch.arena as tarena
import tpu_perf_torch.scenarios.compose as tcompose
import tpu_perf_torch.scenarios.spec as tspec
import tpu_perf_torch.scenarios.vops as tvops
from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import imbalance_volume_scale
from tpu_perf_torch.ops.collectives import build_op
from tpu_perf_torch.parallel import make_mesh
from tpu_perf_torch.world import SimWorld

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ITERS = 2
_RTOL = {"float32": 5e-6, "bfloat16": 5e-2}
RATIOS = (1, 2, 8)
CUSTOM = {"name": "every-phase", "summary": "one of each phase op",
          "phases": [
              {"op": "allreduce", "repeat": 2, "size_frac": 0.5},
              {"op": "all_gather"}, {"op": "reduce_scatter"},
              {"op": "all_to_all", "size_frac": 0.25},
              {"op": "allgatherv"},
              {"op": "reduce_scatter_v", "size_frac": 0.75},
              {"op": "all_to_all_v"},
              {"op": "all_to_all_v", "inverse": True},
              {"op": "ppermute"}]}


def _held(got, want, dtype):
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    want = np.asarray(want, dtype=np.float64).reshape(-1)
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_RTOL[dtype], atol=0)


def _meta(b):
    return (b.name, b.nbytes, b.n_devices, b.iters, b.algo, b.imbalance)


def _vop_cases():
    out = []
    for op in jvops.V_OPS:
        algos = ["native"] + sorted(a for o, a in jarena.V_ALGORITHMS
                                    if o == op)
        for algo in algos:
            for ratio in RATIOS:
                out.append((op, algo, ratio))
    return out


@pytest.mark.parametrize("op,algo,ratio", _vop_cases())
@pytest.mark.parametrize("n", [8, 6])
def test_a_v_op_is_jaxs(op, algo, ratio, n, eight_devices):
    mesh = jax_make_mesh(devices=eight_devices[:n])
    world = SimWorld(n, CPU)
    for nbytes, dtype in ((4100, "float32"), (150, "int32")):
        try:
            jb = jax_build_op(op, mesh, nbytes, ITERS, algo=algo,
                              imbalance=ratio, dtype=dtype)
        except ValueError as theirs:
            with pytest.raises(ValueError) as ours:
                build_op(op, world, nbytes, ITERS, algo=algo,
                         imbalance=ratio, dtype=dtype)
            assert str(ours.value) == str(theirs)
            continue
        pb = build_op(op, world, nbytes, ITERS, algo=algo, imbalance=ratio,
                      dtype=dtype)
        assert _meta(pb) == _meta(jb)
        want = np.asarray(jax.device_get(jb.step(jb.example_input)))
        _held(pb.step(pb.example_input).float().numpy(), want, dtype)


@pytest.mark.parametrize("op", jvops.V_OPS)
@pytest.mark.parametrize("ratio", [1, 8])
def test_a_native_v_op_runs_over_the_whole_2x4_mesh_as_jax(op, ratio,
                                                           eight_devices):
    mesh = jax_make_mesh((2, 4), ("dcn", "ici"), devices=eight_devices)
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    jb = jax_build_op(op, mesh, 4100, ITERS, imbalance=ratio)
    pb = build_op(op, world, 4100, ITERS, imbalance=ratio)
    assert _meta(pb) == _meta(jb)
    _held(pb.step(pb.example_input).numpy(),
          np.asarray(jax.device_get(jb.step(jb.example_input))), "float32")


@pytest.mark.parametrize("ratio", [1, 4, 8])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_vhier_allgatherv_is_jaxs(ratio, shape, eight_devices):
    mesh = jax_make_mesh(shape, ("dcn", "ici"), devices=eight_devices)
    world = SimWorld(8, CPU, make_mesh(shape, ("dcn", "ici"), n=8))
    jb = jax_build_op("allgatherv", mesh, 4100, ITERS, algo="vhier",
                      imbalance=ratio, dtype="int32")
    pb = build_op("allgatherv", world, 4100, ITERS, algo="vhier",
                  imbalance=ratio, dtype="int32")
    assert _meta(pb) == _meta(jb)
    _held(pb.step(pb.example_input).numpy(),
          np.asarray(jax.device_get(jb.step(jb.example_input))), "int32")


@pytest.mark.parametrize("op", jvops.V_OPS)
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("n", [2, 6, 8])
def test_the_counts_and_their_models_are_jaxs(op, ratio, n):
    for nbytes in (8, 150, 4100, 262148):
        assert tvops.v_counts(op, nbytes, n, 4, ratio) == \
            jvops.v_counts(op, nbytes, n, 4, ratio)
    assert tvops.imbalance_weights(n, ratio) == \
        jvops.imbalance_weights(n, ratio)
    assert tvops._count_groups(tvops.v_counts(op, 4100, n, 4, ratio)[0]) \
        == jvops._count_groups(jvops.v_counts(op, 4100, n, 4, ratio)[0])
    if n * ratio <= 1024:
        assert tvops.a2av_layout(1024, n, ratio) == \
            jvops.a2av_layout(1024, n, ratio)
    assert imbalance_volume_scale(op, ratio, n) == \
        jmetrics.imbalance_volume_scale(op, ratio, n)
    counts = tvops.v_counts("allgatherv", 4100, n, 4, ratio)[0]
    blocks = tvops.v_counts("all_to_all_v", 4100, n, 4, ratio)[0]
    for algo in ("native", "ring", "sortring", "doubling"):
        assert tarena.allgatherv_wire_elems(algo, counts) == \
            jarena.allgatherv_wire_elems(algo, counts)
    for algo in ("native", "ring", "doubling"):
        assert tarena.a2av_wire_elems(algo, blocks) == \
            jarena.a2av_wire_elems(algo, blocks)
    for algo in ("native", "ring", "rhd", "bruck", "binomial"):
        assert tarena.seg_wire_elems(algo, 1000, n) == \
            jarena.seg_wire_elems(algo, 1000, n)
    if n == 8:
        for sizes in ((2, 4), (4, 2)):
            assert tarena.vhier_wire_elems(counts, sizes) == \
                jarena.vhier_wire_elems(counts, sizes)


def _scenario_cases():
    specs = sorted(jspec.BUILTIN_SCENARIOS) + ["every-phase"]
    return [(name, inner) for name in specs
            for inner in ("native", "ring", "binomial", "bruck", "rhd")]


def _specs(name):
    if name == "every-phase":
        return (jspec.scenario_from_json(CUSTOM),
                tspec.scenario_from_json(CUSTOM))
    return jspec.BUILTIN_SCENARIOS[name], tspec.BUILTIN_SCENARIOS[name]


@pytest.mark.parametrize("name,inner", _scenario_cases())
def test_a_scenario_step_is_jaxs(name, inner, eight_devices):
    js, ts = _specs(name)
    for n in (8, 6):
        mesh = jax_make_mesh(devices=eight_devices[:n])
        world = SimWorld(n, CPU)
        for ratio in (1, 8):
            for nbytes, dtype in ((4100, "float32"), (150, "bfloat16"),
                                  (4100, "int32")):
                try:
                    jb = jcompose.build_scenario_op(
                        js, mesh, nbytes, ITERS, dtype=dtype,
                        imbalance=ratio, inner=inner)
                except ValueError as theirs:
                    with pytest.raises(ValueError) as ours:
                        tcompose.build_scenario_op(
                            ts, world, nbytes, ITERS, dtype=dtype,
                            imbalance=ratio, inner=inner)
                    assert str(ours.value) == str(theirs)
                    continue
                pb = tcompose.build_scenario_op(
                    ts, world, nbytes, ITERS, dtype=dtype, imbalance=ratio,
                    inner=inner)
                assert _meta(pb) == _meta(jb)
                want = np.asarray(jax.device_get(jb.step(jb.example_input)))
                _held(pb.step(pb.example_input).float().numpy(), want,
                      dtype)


@pytest.mark.parametrize("name", sorted(jspec.BUILTIN_SCENARIOS)
                         + ["every-phase"])
@pytest.mark.parametrize("ratio", [1, 2, 8])
def test_the_phase_plan_is_jaxs(name, ratio):
    js, ts = _specs(name)
    for n in (6, 8):
        for nbytes in (4096, 4 * 1024**2):
            assert tcompose.phase_plan(ts, nbytes, n, imbalance=ratio) == \
                jcompose.phase_plan(js, nbytes, n, imbalance=ratio)
            assert tcompose.scenario_elems(nbytes, n, 4, ratio) == \
                jcompose.scenario_elems(nbytes, n, 4, ratio)


def test_the_catalog_and_the_spec_grammar_are_jaxs(tmp_path):
    assert sorted(tspec.BUILTIN_SCENARIOS) == sorted(jspec.BUILTIN_SCENARIOS)
    for name, s in tspec.BUILTIN_SCENARIOS.items():
        j = jspec.BUILTIN_SCENARIOS[name]
        assert [(p.op, p.repeat, p.size_frac, p.inverse, p.label)
                for p in s.phases] == [
            (p.op, p.repeat, p.size_frac, p.inverse, p.label)
            for p in j.phases]
        assert (s.summary, s.uses_imbalance) == (j.summary, j.uses_imbalance)
    path = tmp_path / "every-phase.json"
    path.write_text(json.dumps(CUSTOM))
    (ours,), (theirs,) = (tspec.resolve_scenarios([str(path)]),
                          jspec.resolve_scenarios([str(path)]))
    assert ours.name == theirs.name == "every-phase"
    for bad in ({"name": "a[b]", "phases": [{"op": "allreduce"}]},
                {"name": "x", "phases": [{"op": "nope"}]},
                {"name": "x", "phases": [{"op": "allreduce",
                                          "inverse": True}]},
                {"name": "x", "phases": []}):
        with pytest.raises(ValueError) as e1:
            tspec.scenario_from_json(bad)
        with pytest.raises(ValueError) as e2:
            jspec.scenario_from_json(bad)
        assert str(e1.value) == str(e2.value)


def test_the_label_grammar_is_jaxs():
    from tpu_perf.schema import decorate_op as jdecorate, parse_op_label

    from tpu_perf_torch.schema import decorate_op, parse_op_label as tparse

    s = tspec.BUILTIN_SCENARIOS["moe-dispatch-combine"]
    label = tcompose.scenario_algo_label(s)
    assert decorate_op("scenario", label, 0, 8) == \
        jdecorate("scenario", label, 0, 8) == \
        "scenario[moe-dispatch-combine]%8"
    assert tcompose.scenario_algo_label(s, "ring") == \
        jcompose.scenario_algo_label(jspec.BUILTIN_SCENARIOS[s.name],
                                     "ring") == "moe-dispatch-combine+ring"
    assert tcompose.split_scenario_label("a+ring") == \
        jcompose.split_scenario_label("a+ring")
    full = decorate_op("scenario", "moe-dispatch-combine+ring", 250, 8)
    assert tparse(full) == parse_op_label(full)


@pytest.mark.parametrize("algo", ["native", "ring", "all", "rhd",
                                  "hier", "ring,bruck"])
@pytest.mark.parametrize("names", [("tp-allreduce-burst",),
                                   ("moe-dispatch-combine",
                                    "pipeline-chain")])
def test_scenario_algos_for_is_jaxs(algo, names):
    kw = dict(op="scenario", scenario=names, algo=algo)
    for n in (6, 8):
        try:
            want = jcompose.scenario_algos_for(jconfig.Options(**kw), n)
        except ValueError as theirs:
            with pytest.raises(ValueError) as ours:
                tcompose.scenario_algos_for(Options(**kw), n)
            assert str(ours.value) == str(theirs)
            continue
        assert tcompose.scenario_algos_for(Options(**kw), n) == want


def test_the_scenario_cli_writes_jaxs_rows(tmp_path, capsys):
    assert cli.main(["scenario", "--list"]) == 0
    listed = capsys.readouterr().out
    for name in jspec.BUILTIN_SCENARIOS:
        assert name in listed
    assert cli.main(["scenario", "moe-dispatch-combine,tp-allreduce-burst",
                     "--imbalance", "1,8", "--sim-ranks", "8", "-b", "4K",
                     "-i", "2", "-r", "2", "--device", "cpu", "-l",
                     str(tmp_path)]) == 0
    (log,) = tmp_path.glob("tpu-*.log")
    rows = [JRow.from_csv(ln) for ln in log.read_text().splitlines()]
    # the burst has no v-phase: its balanced point only, with a note
    assert sorted({(r.op, r.algo, r.imbalance) for r in rows}) == [
        ("scenario", "moe-dispatch-combine", 1),
        ("scenario", "moe-dispatch-combine", 8),
        ("scenario", "tp-allreduce-burst", 1)]
    assert "has no v-variant phase" in capsys.readouterr().err
    assert cli.main(["report", str(tmp_path)]) == 0
    assert "### Scenario steps" in capsys.readouterr().out


def test_the_scenario_options_refuse_as_jaxs():
    for kw in (dict(op="allreduce", scenario=("pipeline-chain",)),
               dict(op="scenario"),
               dict(op="scenario", scenario=("nope",)),
               dict(op="allreduce", imbalance=(2,)),
               dict(op="scenario", scenario=("tp-allreduce-burst",),
                    imbalance=(1, 2))):
        with pytest.raises(ValueError) as ours:
            Options(**kw)
        with pytest.raises(ValueError) as theirs:
            jconfig.Options(**kw)
        assert str(ours.value).replace("tpu-perf-torch", "tpu-perf") == \
            str(theirs.value)


_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from tpu_perf_torch.ops.collectives import build_op
from tpu_perf_torch.parallel import initialize_distributed
from tpu_perf_torch.scenarios.compose import build_scenario_op
from tpu_perf_torch.scenarios.spec import BUILTIN_SCENARIOS
from tpu_perf_torch.world import dist_world

cases, out = json.loads(sys.argv[1]), sys.argv[2]
initialize_distributed(device="cpu")
world = dist_world(torch.device("cpu"))
got = {}
for op, ratio in cases:
    if op in BUILTIN_SCENARIOS:
        b = build_scenario_op(BUILTIN_SCENARIOS[op], world, 4100, 2,
                              imbalance=ratio)
    else:
        b = build_op(op, world, 4100, 2, imbalance=ratio)
    got[f"{op}/{ratio}"] = {"x": b.example_input.double().tolist(),
                            "y": b.step(b.example_input).double().tolist(),
                            "nbytes": b.nbytes}
with open(f"{out}/rank{world.rank}.json", "w") as fh:
    json.dump(got, fh)
dist.destroy_process_group()
"""

GLOO_CASES = [(op, ratio) for op in jvops.V_OPS for ratio in RATIOS] + [
    ("moe-dispatch-combine", 8), ("tp-allreduce-burst", 1)]


def _spawn(n, argv):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
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
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def test_the_v_ops_and_a_scenario_across_two_processes_are_jaxs(
        tmp_path, eight_devices):
    _spawn(2, [sys.executable, "-c", _WORKER, json.dumps(GLOO_CASES),
               str(tmp_path)])
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    mesh = jax_make_mesh(devices=eight_devices[:2])
    for op, ratio in GLOO_CASES:
        if op in jspec.BUILTIN_SCENARIOS:
            jb = jcompose.build_scenario_op(jspec.BUILTIN_SCENARIOS[op],
                                            mesh, 4100, 2, imbalance=ratio)
        else:
            jb = jax_build_op(op, mesh, 4100, 2, imbalance=ratio)
        x = np.asarray(jax.device_get(jb.example_input),
                       dtype=np.float64).reshape(2, -1)
        want = np.asarray(jax.device_get(jb.step(jb.example_input)),
                          dtype=np.float64).reshape(2, -1)
        for r in range(2):
            got = ranks[r][f"{op}/{ratio}"]
            assert got["nbytes"] == jb.nbytes
            np.testing.assert_array_equal(got["x"], x[r])
            _held(got["y"], want[r], "float32")
