"""``--mesh`` / ``--axes`` where the run path had them and the rest did
not: ``selftest`` and ``grid`` over a meshed sim world, and ``--backend
mpi --mesh``, each against the JAX package on the CPU (the selftest's
verdicts per op and the grid's on the same mesh; the C baseline's
command lines exactly, its binary's path aside)."""

import math

import jax
import pytest
import torch

import tpu_perf.config as jconfig
import tpu_perf.grid as jgrid
import tpu_perf.mpi_launch as jmpi
import tpu_perf.selftest as jselftest
from tpu_perf.parallel import make_mesh as jax_make_mesh

from tpu_perf_torch import cli, mpi_launch
from tpu_perf_torch import grid as tgrid
from tpu_perf_torch import selftest as tselftest
from tpu_perf_torch.config import Options
from tpu_perf_torch.parallel import make_mesh
from tpu_perf_torch.world import SimWorld

CPU = torch.device("cpu")
MESHES = [((2, 4), ("dcn", "ici")), ((4, 2), ("ax0", "ax1")),
          ((8,), ("x",)), ((2, -1), ("a", "b"))]


def _jax_mesh(shape, axes):
    return jax_make_mesh(shape, axes, devices=jax.devices()[:8])


@pytest.mark.parametrize("shape,axes", MESHES)
def test_selftest_on_a_mesh_gives_what_jax_gives(shape, axes, eight_devices):
    ours = tselftest.run_selftest(SimWorld(8, CPU, make_mesh(shape, axes,
                                                             n=8)))
    ref = jselftest.run_selftest(_jax_mesh(shape, axes))
    theirs = {r.op: r.status for r in ref}
    got = {r.op: r.status for r in ours}
    assert "fail" not in got.values()
    # every op both packages check gets the same verdict on the same mesh
    # (the mesh decides which ops run: hier_allreduce needs two axes, the
    # ring ops one)
    assert {op: got[op] for op in got if op in theirs} == {
        op: theirs[op] for op in got if op in theirs}
    assert (got["hier_allreduce"] == "ok") == (len(shape) == 2)


def test_the_selftest_cli_takes_a_mesh(capsys):
    argv = ["selftest", "--device", "cpu", "--ops", "hier_allreduce,ring"]
    assert cli.main(argv + ["--mesh", "2x4", "--axes", "dcn,ici"]) == 0
    out = capsys.readouterr().out
    assert "hier_allreduce  OK" in out and "needs a single-axis mesh" in out
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "ring            OK" in out and "hier_allreduce  SKIP" in out
    assert cli.main(argv + ["--mesh", "2x2"]) == 2
    assert "does not cover 8 devices" in capsys.readouterr().err


@pytest.mark.parametrize("shape,axes", [MESHES[0], MESHES[2]])
def test_grid_on_a_mesh_judges_what_jax_judges(shape, axes, eight_devices):
    # a mesh-only op fails its cells off its mesh and runs on it, in both
    # packages; ring runs on one axis only
    kw = dict(fence="slope", runs=2, spec_gbps=1e6)
    ops, sizes, iters = ["hier_allreduce", "ring"], [4096], [1]
    ours = tgrid.run_grid(SimWorld(8, CPU, make_mesh(shape, axes, n=8)),
                          ops, sizes, iters, **kw)
    ref = jgrid.run_grid(_jax_mesh(shape, axes), ops, sizes, iters, **kw)
    failed = {(c.op, c.verdict == "failed") for c in ours}
    assert failed == {(c.op, c.verdict == "failed") for c in ref}
    assert ("hier_allreduce", len(shape) != 2) in failed


def test_the_grid_cli_takes_a_mesh(capsys):
    assert cli.main(["grid", "--op", "hier_allreduce", "--sizes", "4K",
                     "--iters", "1", "-r", "2", "--device", "cpu",
                     "--spec-gbps", "1000", "--mesh", "2x4", "--axes",
                     "dcn,ici"]) == 0
    table = capsys.readouterr().out
    assert "| hier_allreduce | 4K |" in table and "failed" not in table


#: collectives and pairwise ops on meshes, and the local instrument on one
#: uncontended rank
MPI_MESHES = [
    dict(op="allreduce", buff_sz=4096, mesh_shape=(4,), mesh_axes=("x",)),
    dict(op="allreduce", buff_sz=4096, mesh_shape=(2, 4),
         mesh_axes=("dcn", "ici"), ppn=3),
    dict(op="hbm_stream", buff_sz=65536, mesh_shape=(1,), mesh_axes=("x",)),
    dict(op="all_to_all", buff_sz=4096, mesh_shape=(1,), mesh_axes=("x",)),
    dict(op="exchange", nonblocking=True, buff_sz=64, mesh_shape=(8,),
         mesh_axes=("x",)),
]


def _both(kw, tmp_path):
    kw = dict(kw)
    if kw["op"] in ("pingpong", "exchange"):
        path = tmp_path / "group1"
        path.write_text("host1\n")
        kw["group1_file"] = str(path)
    return Options(**kw), jconfig.Options(**kw)


@pytest.mark.parametrize("hosts", [None, "h0,h1,h2,h3"])
@pytest.mark.parametrize("kw", MPI_MESHES)
def test_mpi_backend_on_a_mesh_plans_what_jax_plans(kw, hosts, tmp_path):
    ours, ref = _both(kw, tmp_path)
    nbytes = mpi_launch.mpi_sizes_for(ours)[0]

    def plan(mod, opts):
        try:
            return mod.plan_command(opts, nbytes, hosts=hosts)
        except ValueError as e:
            return f"ValueError: {e}"

    got, want = plan(mpi_launch, ours), plan(jmpi, ref)
    if isinstance(want, str):
        assert got == want
        return
    name = "mpi_perf" if hosts else "mpi_perf_shim"
    i = want.index(str(jmpi.backend_dir() / name))
    assert got[i] == str(mpi_launch.BUILD_DIR / name)
    assert got[:i] + got[i + 1:] == want[:i] + want[i + 1:]
    if not hosts and kw["op"] != "exchange":
        np = int(got[got.index("-np") + 1])
        assert np == max(math.prod(kw["mesh_shape"]), 2) or (
            kw["op"] == "hbm_stream" and np == 1)


def test_the_mpi_backend_takes_a_mesh_at_the_cli(capsys):
    assert cli.main(["run", "--backend", "mpi", "--op", "allreduce", "-b",
                     "4K", "--mesh", "4", "--hosts", "h0,h1", "-p", "2",
                     "--dry-run"]) == 0
    out = capsys.readouterr()
    assert "mpirun -np 4 --host h0,h1" in out.out + out.err
