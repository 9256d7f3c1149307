"""``build_op(..., axis=)`` and ``contend`` along mesh axes, against the JAX
package on its eight virtual CPU devices.

Along one axis of a ``(dcn, ici)`` mesh a library op runs in k-rank groups
(k the axis' size), each group holding the global input's k shards, as
``P(axis)`` shards it over the JAX mesh (replicated over the other axis).
The sim world holds its rows group by group (``mesh.groups(axes)``); a
gloo world's rank runs the op on its axis group.  Byte-moving ops are held
exactly; the float sums within rtol 1e-6 (float32; they add in another
order than XLA's), as ``tests/test_torch_collectives.py`` holds them.
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

import tpu_perf.streams.contend as jcontend
from tpu_perf.config import Options as JOptions
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh as jax_make_mesh

from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.ops.collectives import build_op, known_ops
from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS
from tpu_perf_torch.parallel import make_mesh
from tpu_perf_torch.streams import contend
from tpu_perf_torch.world import SimWorld

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
NBYTES, ITERS = 4 * 40, 2
#: the float sums and products (another order of addition than XLA's)
ARITH = ("allreduce", "reduce_scatter", "broadcast_psum", "barrier",
         "hbm_stream", "hbm_read", "hbm_triad", "hbm_write", "mxu_gemm",
         "overlap_ring")
GEMM_OPS = ("mxu_gemm", "overlap_ring")
LIBRARY_OPS = sorted(set(known_ops()) - set(PALLAS_OPS) - {"hier_allreduce"})
WORKER_TIMEOUT_S = 240


def _jax_along(op, shape, axis, devices):
    mesh = jax_make_mesh(shape, ("dcn", "ici"), devices=devices)
    jb = jax_build_op(op, mesh, NBYTES, ITERS, axis=axis)
    x = np.asarray(jax.device_get(jb.example_input))
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    return jb, x, want


def _check(op, got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if op in GEMM_OPS:
        # a product's elements near zero: tests/test_torch_compute.py's
        # bound, relative to 1 + |want|
        err = np.abs(got - want)
        assert (err <= 1e-5 * (1 + np.abs(want))).all(), op
    elif op in ARITH:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=op)
    else:
        np.testing.assert_array_equal(got, want, err_msg=op)


@pytest.mark.parametrize("axis", ["dcn", "ici"])
@pytest.mark.parametrize("op", LIBRARY_OPS)
def test_a_library_op_along_an_axis_of_the_sim_mesh_is_jaxs(op, axis,
                                                           eight_devices):
    jb, x, want = _jax_along(op, (2, 4), axis, eight_devices)
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    pb = build_op(op, world, NBYTES, ITERS, axis=axis)
    k = jb.n_devices
    assert (pb.nbytes, pb.n_devices, pb.iters) == (jb.nbytes, k, jb.iters)
    assert k == world.mesh.axis_size(axis)
    # the rows group by group, each group the global input's k shards
    groups = pb.example_input.view(8 // k, k, -1)
    for g in range(8 // k):
        np.testing.assert_array_equal(groups[g].reshape(-1).numpy(),
                                      x.reshape(-1))
    out = pb.step(pb.example_input).view(8 // k, k, -1)
    for g in range(8 // k):
        _check(op, out[g].reshape(-1).numpy(), want.reshape(-1))


@pytest.mark.parametrize("op", ["allreduce", "ring", "pl_allreduce"])
def test_the_mesh_order_of_every_axis_is_the_whole_world(op):
    # axis None and every axis in the mesh's order are the whole world
    world = SimWorld(8, CPU, make_mesh((8,), ("x",), n=8))
    a = build_op(op, world, 4096, 2)
    b = build_op(op, world, 4096, 2, axis="x")
    assert (a.nbytes, a.n_devices) == (b.nbytes, b.n_devices)
    assert torch.equal(a.step(a.example_input), b.step(b.example_input))


@pytest.mark.parametrize("op,axis", [
    ("hier_allreduce", "ici"), ("ring", ("dcn", "ici")),
    ("pl_allreduce", "ici"), ("pl_ring", ("dcn", "ici")),
    ("allreduce", "nope"),
])
def test_the_refusals_along_an_axis_are_jaxs(op, axis, eight_devices):
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    with pytest.raises(ValueError) as ours:
        build_op(op, world, NBYTES, ITERS, axis=axis)
    if axis == "nope":
        assert "names no axis" in str(ours.value)
        return
    mesh = jax_make_mesh((2, 4), ("dcn", "ici"), devices=eight_devices)
    with pytest.raises(ValueError) as theirs:
        jax_build_op(op, mesh, NBYTES, ITERS, axis=axis)
    assert str(ours.value) == str(theirs.value)


def test_both_axes_in_another_order_is_the_whole_world_reordered(
        eight_devices):
    jb, x, want = _jax_along("all_gather", (2, 4), ("ici", "dcn"),
                             eight_devices)
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    pb = build_op("all_gather", world, NBYTES, ITERS, axis=("ici", "dcn"))
    assert pb.n_devices == jb.n_devices == 8
    np.testing.assert_array_equal(
        pb.step(pb.example_input).reshape(-1).numpy(), want.reshape(-1))


# --- gloo worlds of 4 processes on a 2 x 2 mesh -------------------------


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.parallel import initialize_distributed, make_mesh
    from tpu_perf_torch.world import dist_world

    ops, nbytes, iters, out = json.loads(sys.argv[1]), int(sys.argv[2]), \\
        int(sys.argv[3]), sys.argv[4]
    initialize_distributed(device="cpu")
    world = dist_world(torch.device("cpu"),
                       make_mesh((2, 2), ("dcn", "ici"), n=4))
    got = {}
    for axis in ("dcn", "ici"):
        for op in ops:
            b = build_op(op, world, nbytes, iters, axis=axis)
            x = b.example_input.clone()
            y = b.step(b.example_input)
            got[f"{op}/{axis}"] = {
                "x": x.double().reshape(-1).tolist(),
                "y": y.double().reshape(-1).tolist(),
                "n": b.n_devices, "nbytes": b.nbytes}
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
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def test_library_ops_along_each_axis_of_a_gloo_2x2_world_are_jaxs(
        tmp_path, eight_devices):
    _spawn(4, [sys.executable, "-c", _WORKER, json.dumps(LIBRARY_OPS),
               str(NBYTES), str(ITERS), str(tmp_path)])
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    mesh = make_mesh((2, 2), ("dcn", "ici"), n=4)
    for axis in ("dcn", "ici"):
        groups = mesh.groups((axis,))
        for op in LIBRARY_OPS:
            jb, x, want = _jax_along(op, (2, 2), axis, eight_devices[:4])
            k = jb.n_devices
            xs, ws = x.reshape(k, -1), want.reshape(k, -1)
            for r in range(4):
                got = ranks[r][f"{op}/{axis}"]
                a = next(g.index(r) for g in groups if r in g)
                assert (got["n"], got["nbytes"]) == (k, jb.nbytes), op
                np.testing.assert_array_equal(got["x"], xs[a], err_msg=op)
                _check(op, got["y"], ws[a])


# --- contend along the axes --------------------------------------------------


@pytest.mark.parametrize("victim_axis,load_axis", [
    ("ici", "dcn"), ("dcn", "ici"), ("ici", "ici"), (None, None)])
@pytest.mark.parametrize("load", ["allreduce", "hbm_stream"])
def test_contend_along_axes_carries_jaxs_row_columns(
        victim_axis, load_axis, load, eight_devices):
    kw = dict(op="allreduce", buff_sz=256, iters=2, num_runs=3, load=load)
    ours = contend.run_contend(
        Options(**kw, device="cpu"),
        world=SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8)),
        axis=victim_axis, load_axis=load_axis)
    theirs = jcontend.run_contend(
        JOptions(**kw), mesh=jax_make_mesh((2, 4), ("dcn", "ici"),
                                           devices=eight_devices),
        axis=victim_axis, load_axis=load_axis)

    def cols(rows):
        return [(r.op, r.nbytes, r.iters, r.run_id, r.n_devices, r.stream,
                 r.load) for r in rows]

    assert cols(ours) == cols(theirs)
    assert all(r.lat_us > 0 for r in ours)


def test_contend_cli_on_a_mesh_along_each_axis(tmp_path, capsys):
    for victim, other in (("ici", "dcn"), ("dcn", "ici")):
        folder = tmp_path / victim
        assert cli.main(["contend", "--mesh", "2x4", "--axes", "dcn,ici",
                         "--op", "allreduce", "--load", "allreduce",
                         "--victim-axis", victim, "--load-axis", other,
                         "-b", "4K", "-i", "2", "-r", "3", "-l", str(folder),
                         "--device", "cpu"]) == 0
        err = capsys.readouterr().err
        assert "allreduce @ 4096 B under allreduce: slowdown" in err
        assert len(list(folder.glob("tpu-*.log"))) == 1


def test_contend_in_a_gloo_world_of_four_on_2x2(tmp_path):
    argv = [sys.executable, "-m", "tpu_perf_torch", "contend",
            "--distributed", "--mesh", "2x2", "--axes", "dcn,ici", "--op",
            "allreduce", "--load", "all_gather", "--victim-axis", "ici",
            "--load-axis", "dcn", "-b", "4K", "-i", "2", "-r", "3", "--csv",
            "--device", "cpu", "-l", str(tmp_path)]
    outs = _spawn(4, argv)
    rows = [ln for ln in outs[0][0].splitlines()
            if ln and not ln.startswith("timestamp")]
    assert len(rows) == 6
    # every rank logged the same rows: each run's time its maximum over
    # the ranks
    from tpu_perf_torch.schema import ResultRow

    logged = {}
    for path in tmp_path.glob("tpu-*.log"):
        rank = int(path.name.split("-")[-3])
        logged[rank] = [ResultRow.from_csv(ln) for ln in
                        path.read_text().splitlines() if ln]
    assert sorted(logged) == [0, 1, 2, 3]
    times = {r: [(x.load, x.time_ms) for x in rs] for r, rs in logged.items()}
    assert len({json.dumps(t) for t in times.values()}) == 1
    assert {x.load for x in logged[0]} == {"", "all_gather"}
    assert all(x.n_devices == 4 for x in logged[0])
