"""The port's meshes, its hier_allreduce in the sim world, the peer
kernels' plain versions and the multi-rank flags, against the JAX package
on its eight virtual CPU devices.

Tolerances: the mesh functions are held to the JAX package's shapes, axis
names, rank order and error messages exactly.  ``hier_allreduce`` sums in
another order than XLA's: float32 rtol 1e-6, bfloat16 rtol 8e-3, as
``tests/test_torch_collectives.py`` holds the sums.  The peer kernels'
plain reduce-scatter is held bit for bit to the sim world's
(``direct_reduce_scatter_plain``), unscaled, scaled and tiled: both sum
in the ring's order; the byte movers are held exactly.
"""

import argparse
import sys

import jax
import numpy as np
import pytest
import torch

import tpu_perf.cli as jcli
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh as jax_make_mesh
from tpu_perf.parallel import mesh_devices_flat

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import cli, kernels
from tpu_perf_torch.config import Options
from tpu_perf_torch.ops.collectives import build_op, to_tensor
from tpu_perf_torch.parallel import make_hybrid_mesh, make_mesh
from tpu_perf_torch.parallel.mesh import mesh_ranks_flat
from tpu_perf_torch.runner import world_for
from tpu_perf_torch.selftest import run_selftest
from tpu_perf_torch.world import (
    NoDeviceError, SimWorld, from_world, to_rank, to_world,
)

CPU = torch.device("cpu")
RTOL = {"float32": 1e-6, "bfloat16": 8e-3}
MESHES = [((), ()), ((8,), ("x",)), ((2, 4), ("dcn", "ici")),
          ((4, 2), ("dcn", "ici")), ((-1, 2), ("a", "b")),
          ((2, -1), ("dcn", "ici")), ((2, 2, 2), ("p", "q", "r"))]
BAD_MESHES = [((3, 4), ("dcn", "ici")), ((2, 4), ("x",)),
              ((-1, -1), ("a", "b")), ((3, -1), ("a", "b")),
              ((0, -1), ("a", "b"))]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_make_mesh_matches_jax(shape, axes, eight_devices):
    theirs = jax_make_mesh(shape, axes, devices=eight_devices)
    ours = make_mesh(shape, axes, n=8)
    assert ours.shape == theirs.devices.shape
    assert ours.axis_names == theirs.axis_names
    # rank r sits where device r sits in the JAX mesh of the same shape
    ids = [d.id for d in mesh_devices_flat(theirs)]
    assert mesh_ranks_flat(ours) == ids
    for r in range(8):
        assert theirs.devices[ours.coords(r)].id == r


@pytest.mark.parametrize("shape,axes", BAD_MESHES)
def test_make_mesh_errors_match_jax(shape, axes, eight_devices):
    with pytest.raises(ValueError) as theirs:
        jax_make_mesh(shape, axes, devices=eight_devices)
    with pytest.raises(ValueError) as ours:
        make_mesh(shape, axes, n=8)
    assert str(ours.value) == str(theirs.value)


def test_axis_groups_are_the_ranks_along_an_axis():
    mesh = make_mesh((2, 4), ("dcn", "ici"), n=8)
    assert mesh.axis_groups("ici") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.axis_groups("dcn") == [[0, 4], [1, 5], [2, 6], [3, 7]]


@pytest.mark.parametrize("mesh,axes", [(None, None), ("8", None),
                                       ("2x4", None), ("2x4", "dcn,ici"),
                                       ("2,2,2", "a,b,c"), (None, "dcn,ici"),
                                       ("-1x2", "dcn,ici")])
def test_parse_mesh_matches_jax(mesh, axes):
    args = argparse.Namespace(mesh=mesh, axes=axes)
    assert cli._parse_mesh(args) == jcli._parse_mesh(args)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_permutations_match_jax(n):
    import tpu_perf.topology as jtopo

    from tpu_perf_torch import topology

    for shift in (1, -1, 3):
        assert (topology.ring_permutation(n, shift=shift)
                == jtopo.ring_permutation(n, shift=shift))
    if n % 2 == 0:
        for reverse in (False, True):
            assert (topology.one_way_permutation(n, reverse=reverse)
                    == jtopo.one_way_permutation(n, reverse=reverse))


def test_hybrid_mesh_is_nodes_by_local_ranks():
    mesh = make_hybrid_mesh(n=8, per_node=4)
    assert (mesh.shape, mesh.axis_names) == ((2, 4), ("dcn", "ici"))
    # a single process is one node of one rank
    assert make_hybrid_mesh().shape == (1, 1)
    with pytest.raises(ValueError, match="degraded pod"):
        make_hybrid_mesh(n=6, per_node=4)


# --- hier_allreduce in the sim world ---------------------------------------


def _compare_hier(shape, nbytes, iters, dtype):
    jmesh = jax_make_mesh(shape, ("dcn", "ici"),
                          devices=jax.devices()[:int(np.prod(shape))])
    jb = jax_build_op("hier_allreduce", jmesh, nbytes, iters, dtype=dtype)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    n = jb.n_devices
    world = SimWorld(n, CPU, make_mesh(shape, ("dcn", "ici"), n=n))
    pb = build_op("hier_allreduce", world, nbytes, iters, dtype=dtype)
    xt = to_tensor(to_world(x, n), dtype, CPU)
    assert torch.equal(xt, pb.example_input)
    assert (pb.nbytes, pb.n_devices) == (jb.nbytes, jb.n_devices)
    got = from_world(pb.step(xt)).astype(np.float64)
    np.testing.assert_allclose(got, want.astype(np.float64),
                               rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8), (2, 2)])
def test_hier_allreduce_in_the_sim_world_matches_jax(shape, iters, dtype,
                                                     eight_devices):
    _compare_hier(shape, 4 * 37, iters, dtype)


def test_hier_allreduce_needs_two_axes_with_the_jax_message(eight_devices):
    with pytest.raises(ValueError) as theirs:
        jax_build_op("hier_allreduce", jax_make_mesh(devices=eight_devices),
                     64, 1)
    with pytest.raises(ValueError) as ours:
        build_op("hier_allreduce", SimWorld(8, CPU), 64, 1)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("op", ["ring", "pingpong", "pl_ring",
                                "pl_allreduce"])
def test_one_axis_ops_refuse_a_two_axis_mesh_as_jax_does(op, eight_devices):
    jmesh = jax_make_mesh((2, 4), ("dcn", "ici"), devices=eight_devices)
    with pytest.raises(ValueError) as theirs:
        jax_build_op(op, jmesh, 64, 1)
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    with pytest.raises(ValueError) as ours:
        build_op(op, world, 64, 1)
    assert str(ours.value) == str(theirs.value)


def test_selftest_on_a_two_axis_sim_world():
    world = SimWorld(8, CPU, make_mesh((2, 4), ("dcn", "ici"), n=8))
    by_op = {r.op: r for r in run_selftest(world, iters=2)}
    assert by_op["hier_allreduce"].status == "ok"
    assert by_op["allreduce"].status == "ok"
    assert by_op["ring"].detail == "needs a single-axis mesh"
    flat = {r.op: r for r in run_selftest(SimWorld(8, CPU),
                                          ops=["hier_allreduce"])}
    assert flat["hier_allreduce"].detail == "needs a 2-axis (dcn, ici) mesh"


def test_cli_runs_hier_allreduce_on_a_sim_mesh(capsys):
    rc = cli.main(["run", "--op", "hier_allreduce", "--mesh", "2x4",
                   "--axes", "dcn,ici", "-b", "4K", "-i", "2", "-r", "2",
                   "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()[1:]
    assert len(lines) == 2
    assert all(",torch-sim,hier_allreduce,4096,2," in ln for ln in lines)


# --- the carry-across helper and the peer kernels' plain versions --------


@pytest.mark.parametrize("window", [1, 3])
def test_to_rank_is_the_ranks_shard_of_the_global_layout(window):
    n, elems = 4, 5
    g = np.arange(window * n * elems, dtype=np.float32)
    g = g.reshape(window, -1) if window > 1 else g
    for r in range(n):
        got = to_rank(g, n, r)
        if window == 1:
            np.testing.assert_array_equal(got, g[r * elems:(r + 1) * elems])
        else:
            np.testing.assert_array_equal(got,
                                          g[:, r * elems:(r + 1) * elems])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_peer_plain_reduce_scatter_is_the_sim_plain_bit_for_bit(n, dtype):
    chunk = 7
    rng = np.random.default_rng(n)
    # values that round differently in another order of addition
    x = torch.from_numpy(rng.standard_normal((n, n * chunk)) * 1e4
                         ).to(dtype)
    scale = tpr.mean_scale(n, dtype)
    xs = [x[r].clone() for r in range(n)]  # separate buffers, one a rank
    got = torch.stack([tpr.peer_reduce_scatter(
        [b.view(n, chunk)[r] for b in xs], r, scale=scale)
        for r in range(n)])
    if n > 1:
        want = tpr.direct_reduce_scatter_plain(x, scale)
    else:
        want = x * scale
    assert torch.equal(got, want)
    gathered = [tpr.peer_all_gather(list(got)) for _ in range(n)]
    assert all(torch.equal(g, got.reshape(-1)) for g in gathered)


def test_peer_barrier_plain_signals_every_pad():
    n = 3
    pads = [torch.zeros(n, dtype=torch.int32) for _ in range(n)]
    gens = [torch.zeros(1, dtype=torch.int32) for _ in range(n)]
    for _ in range(2):
        for r in range(n):
            tpr.peer_barrier(pads, gens[r], r)
    assert all(p.tolist() == [2] * n for p in pads)
    assert [int(g) for g in gens] == [2] * n
    with pytest.raises(ValueError, match="int32"):
        tpr.peer_barrier([p.float() for p in pads], gens[0], 0)


def test_peer_wrappers_count_plain_calls_on_the_cpu():
    kernels.reset_counts()
    parts = [torch.ones(4), torch.ones(4)]
    tpr.peer_reduce_scatter(parts, 0)
    tpr.peer_all_gather(parts)
    assert kernels.PLAIN_CALLS["peer_reduce_scatter"] == 1
    assert kernels.PLAIN_CALLS["peer_all_gather"] == 1
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="rank 2 outside"):
        tpr.peer_reduce_scatter(parts, 2)


def test_peer_parts_carry_a_table_on_the_card_only():
    parts = [torch.ones(4), torch.zeros(4)]
    held = tpr.PeerParts(parts)
    assert held.table is None
    assert len(held) == 2 and held[1] is parts[1]
    assert torch.equal(tpr.peer_reduce_scatter(held, 0), torch.ones(4))
    assert torch.equal(tpr.peer_all_gather(held), torch.cat(parts))
    # a launch on the card reads its parts through a PeerParts' table only
    for given in (parts, held):
        with pytest.raises(TypeError, match="PeerParts"):
            tpr._table_ptr("peer_all_gather", given)


@pytest.mark.parametrize("name", tpr.PEER_COPIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_peer_copy_plain_copies_and_counts_its_op(name, dtype):
    kernels.reset_counts()
    src = torch.arange(11).to(dtype)
    got = tpr.peer_copy(name, src)
    assert torch.equal(got, src) and got.data_ptr() != src.data_ptr()
    out = torch.empty_like(src)
    assert tpr.peer_copy(name, src, out=out) is out
    assert torch.equal(out, src)
    assert kernels.PLAIN_CALLS[name] == 2
    assert tpr.peer_copy_plain(name, src).tolist() == src.tolist()
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="peer_copy counts one of"):
        tpr.peer_copy("peer_gather", src)


@pytest.mark.parametrize("peers,n", [("all", 1), ("all", 5), ("ring", 1),
                                     ("ring", 2), ("ring", 5), ("pair", 2),
                                     ("pair", 6)])
def test_peer_barrier_signals_only_its_set(peers, n):
    # one round: slot r of pad s is set exactly when s is in r's set, and
    # each set is symmetric, so every rank's waited-on slots are all set
    pads = [torch.zeros(n, dtype=torch.int32) for _ in range(n)]
    gens = [torch.zeros(1, dtype=torch.int32) for _ in range(n)]
    for r in range(n):
        tpr.peer_barrier(pads, gens[r], r, peers=peers)
    for r in range(n):
        members = set(tpr.barrier_set(peers, n, r))
        for s in range(n):
            assert int(pads[s][r]) == (1 if s in members else 0)
            assert (r in set(tpr.barrier_set(peers, n, s))) == (s in members)
        assert all(int(pads[r][s]) == 1 for s in members)
    if n > 2:
        assert tpr.barrier_set(peers, n, 2) == {
            "all": list(range(n)), "ring": [1, 3 % n],
            "pair": [(2 + n // 2) % n]}[peers]


def test_peer_barrier_refuses_a_pair_of_odd_ranks_and_unknown_sets():
    pads = [torch.zeros(3, dtype=torch.int32) for _ in range(3)]
    gen = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="even rank count"):
        tpr.peer_barrier(pads, gen, 0, peers="pair")
    with pytest.raises(ValueError, match="known"):
        tpr.peer_barrier(pads, gen, 0, peers="star")
    assert int(gen) == 0


def test_peer_barrier_tail_copy_is_counted_apart():
    kernels.reset_counts()
    pads = [torch.zeros(2, dtype=torch.int32) for _ in range(2)]
    gen = torch.zeros(1, dtype=torch.int32)
    src, dst = torch.tensor([7.5]), torch.zeros(1)
    tpr.peer_barrier(pads, gen, 1, copy=(src, dst))
    assert float(dst) == 7.5 and int(gen) == 1
    assert [int(p[1]) for p in pads] == [1, 1]
    assert kernels.PLAIN_CALLS["peer_barrier_copy"] == 1
    assert kernels.PLAIN_CALLS["peer_barrier"] == 0
    with pytest.raises(ValueError, match="src and dst differ"):
        tpr.peer_barrier(pads, gen, 1, copy=(src, torch.zeros(2)))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_bidir_order_takes_each_half_once_in_both_directions(n):
    for rank in range(n):
        order = tpr.bidir_order(n, rank)
        assert sorted((h, s) for _, h, s in order) == [
            (h, s) for h in (0, 1) for s in range(n)]
        assert [s for _, h, s in order if h == 0] == [
            (rank - k) % n for k in range(n)]
        assert [s for _, h, s in order if h == 1] == [
            (rank + k) % n for k in range(n)]
        parts = [torch.arange(6, dtype=torch.int32) + 10 * s
                 for s in range(n)]
        got = tpr.peer_all_gather_bidir(parts, rank)
        assert torch.equal(got, torch.cat(parts))
    with pytest.raises(ValueError, match="in half"):
        tpr.peer_all_gather_bidir([torch.ones(3)] * n, 0)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_push_order_rotates_and_takes_each_half_once(n):
    for rank in range(n):
        whole = tpr.push_order(n, rank)
        assert [s for _, _, s in whole] == [(rank + k) % n for k in range(n)]
        assert {h for _, h, _ in whole} == {0}
        both = tpr.push_order(n, rank, bidir=True)
        assert sorted((h, s) for _, h, s in both) == [
            (h, s) for h in (0, 1) for s in range(n)]
        assert [s for _, h, s in both if h == 1] == [
            (rank - k) % n for k in range(n)]


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_push_plain_writes_only_its_slot_and_gathers_like_cat(n, dtype,
                                                              bidir):
    chunk = 6
    owns = [(torch.arange(chunk) * 3 + 11 * s).to(dtype) for s in range(n)]
    sentinel = torch.tensor(97).to(dtype)
    outs = [torch.full((n * chunk,), int(sentinel)).to(dtype)
            for _ in range(n)]
    kernels.reset_counts()
    for r in range(n):
        before = [o.clone() for o in outs]
        tpr.peer_all_gather_push(owns[r], outs, r, bidir=bidir)
        for o, b in zip(outs, before):
            mine = slice(r * chunk, (r + 1) * chunk)
            assert torch.equal(o[mine], owns[r])
            o_rest, b_rest = o.clone(), b.clone()
            o_rest[mine], b_rest[mine] = 0, 0
            assert torch.equal(o_rest, b_rest), "a store outside its slot"
    assert all(torch.equal(o, torch.cat(owns)) for o in outs)
    name = "peer_all_gather_bidir" if bidir else "peer_all_gather"
    assert kernels.PLAIN_CALLS[name] == n
    assert not any(kernels.LAUNCHES.values())


def test_push_refuses_what_it_cannot_store():
    outs = [torch.zeros(8) for _ in range(2)]
    with pytest.raises(ValueError, match="into 2 outputs"):
        tpr.peer_all_gather_push(torch.ones(3), outs, 0)
    with pytest.raises(ValueError, match="into 2 outputs"):
        tpr.peer_all_gather_push(torch.ones(4, dtype=torch.int32), outs, 0)
    with pytest.raises(ValueError, match="rank 2 outside"):
        tpr.peer_all_gather_push(torch.ones(4), outs, 2)
    with pytest.raises(ValueError, match="in half"):
        tpr.peer_all_gather_push(torch.ones(3), [torch.zeros(6)] * 2, 1,
                                 bidir=True)


def _jax_gather_kernel(host: np.ndarray, n: int, chunk: int,
                       bidir: bool) -> np.ndarray:
    """The raw Pallas gather kernel (``_all_gather_kernel``, or
    ``_all_gather_bidir_kernel``; no take-own-shard carry) under the TPU
    interpreter: every device's whole gathered buffer, ``(n, n*chunk)``,
    from ``host`` ``(n, chunk)``."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import tpu_perf.ops.pallas_ring as jpr
    from tpu_perf.compat import shard_map

    mesh = jax_make_mesh(devices=jax.devices()[:n])
    axis = mesh.axis_names[0]
    if bidir:
        kern = jpr._all_gather_bidir_kernel(axis, n, chunk)
        sems = pltpu.SemaphoreType.DMA((n - 1,))
        scratch = [pltpu.SemaphoreType.DMA, sems, sems, sems, sems]
        op = "pl_all_gather_bidir"
    else:
        kern = jpr._all_gather_kernel(axis, n, chunk, src_full=False)
        sems = pltpu.SemaphoreType.DMA((max(n - 1, 1),))
        scratch = [pltpu.SemaphoreType.DMA, sems, sems]
        op = "pl_all_gather"

    def call(x):
        return pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((chunk * n,), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=scratch,
            compiler_params=pltpu.CompilerParams(
                collective_id=jpr._COLLECTIVE_IDS[op]),
            interpret=pltpu.InterpretParams(),
        )(x)

    step = jax.jit(shard_map(call, mesh=mesh, in_specs=P(axis),
                             out_specs=P(axis), check_vma=False))
    x = jax.device_put(jnp.asarray(host.reshape(-1)),
                       NamedSharding(mesh, P(axis)))
    return np.asarray(jax.device_get(step(x))).reshape(n, n * chunk)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n,chunk", [(2, 2), (5, 6), (8, 4)])
@pytest.mark.parametrize("bidir", [False, True])
def test_push_plain_is_the_jax_gather_kernels_whole_buffer(bidir, n, chunk,
                                                           dtype,
                                                           eight_devices):
    # every rank pushes its own chunk into every rank's buffer: the whole
    # gathered buffers are the JAX kernel's, whose ring sends (pushes)
    # each chunk on to its neighbour
    host = ((np.arange(n * chunk) * 7 + 3) % 251).astype(dtype).reshape(
        n, chunk)
    want = _jax_gather_kernel(host, n, chunk, bidir)
    own = torch.from_numpy(host.copy())
    outs = [torch.zeros(n * chunk, dtype=own.dtype) for _ in range(n)]
    for r in range(n):
        tpr.peer_all_gather_push(own[r], outs, r, bidir=bidir)
    np.testing.assert_array_equal(torch.stack(outs).numpy(), want)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_peer_reduce_scatter_tiles_is_the_sim_tiled_plain(n, dtype):
    chunk = 5
    rng = np.random.default_rng(n + 10)
    x = torch.from_numpy(rng.standard_normal((n, n * chunk)) * 1e4).to(dtype)
    scale = tpr.mean_scale(n, dtype)
    got = torch.stack([tpr.peer_reduce_scatter(
        [x[s].view(n, chunk)[r] for s in range(n)], r, scale=scale, tiles=n)
        for r in range(n)])
    assert torch.equal(got, tpr.direct_reduce_scatter_plain(x, scale, n))
    assert torch.equal(got.view(n, n, chunk)[:, 0],
                       tpr.direct_reduce_scatter_plain(x, scale))
    with pytest.raises(ValueError, match="tiles 0"):
        tpr.peer_reduce_scatter([x[0]], 0, tiles=0)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_peer_all_to_all_plain_is_the_sim_all_to_all(n):
    chunk = 3
    x = torch.arange(n * n * chunk, dtype=torch.int32).view(n, n * chunk)
    xs = [x[s].clone() for s in range(n)]  # separate buffers, one a rank
    kernels.reset_counts()
    got = torch.stack([tpr.peer_all_to_all(
        [b.view(n, chunk)[r] for b in xs]) for r in range(n)])
    assert torch.equal(got, tpr.all_to_all_plain(x))
    assert kernels.PLAIN_CALLS["peer_all_to_all"] == n


# --- the flags ---------------------------------------------------------------


def test_hybrid_mesh_and_mesh_are_exclusive(capsys):
    rc = cli.main(["run", "--op", "allreduce", "--hybrid-mesh", "--mesh",
                   "2x4", "--device", "cpu"])
    assert rc == 2
    assert "--hybrid-mesh and --mesh are exclusive" in capsys.readouterr().err


def test_sim_ranks_with_distributed_is_an_error(capsys):
    rc = cli.main(["run", "--distributed", "--sim-ranks", "8", "--device",
                   "cpu"])
    assert rc == 2
    assert "holds one rank" in capsys.readouterr().err
    with pytest.raises(ValueError, match="holds one rank"):
        Options(distributed=True)


def test_dry_run_keeps_its_message(capsys):
    assert cli.main(["run", "--dry-run", "--device", "cpu"]) == 2
    assert "uses --distributed" in capsys.readouterr().err


def test_mesh_with_the_mpi_backend_is_not_yet_ported(capsys):
    # ported now: the C baseline's world is the ranks the mesh names, as
    # the JAX package plans it (tests/test_torch_mesh_flags.py holds every
    # plan against JAX's)
    assert cli.main(["run", "--backend", "mpi", "--mesh", "2", "-x",
                     "--dry-run"]) == 0
    out = capsys.readouterr()
    assert "not yet ported" not in out.err
    assert "mpi_perf_shim -np 2 -- -x 1" in out.out + out.err


def test_mesh_shape_and_axes_must_match():
    with pytest.raises(ValueError, match="matching length"):
        Options(mesh_shape=(2, 4), mesh_axes=("x",))


def test_distributed_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError, match="--device cpu"):
        cli.main(["run", "--distributed", "--op", "allreduce"])


def test_distributed_with_no_cluster_stays_single_process(monkeypatch,
                                                          capsys):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    world = world_for(Options(distributed=True, sim_ranks=1, device="cpu"))
    assert isinstance(world, SimWorld) and world.n == 1
    assert "not joining a multi-host cluster" in capsys.readouterr().err
    assert cli.main(["run", "--distributed", "--op", "allreduce", "-b", "64",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert ",torch,allreduce,64,10,1,1," in out[1]


# --- the card-side peer steps, their protocol run in threads ----------------


class _CpuPeerBuffers:
    """PeerBuffers on shared CPU regions: the k-th buffers each rank makes
    are views of the k-th set of n regions (``world.peer_memory``)."""

    def __init__(self, world, layout):
        n, rank = world.n, world.rank
        shapes = [*layout.values(), (n, torch.int32)]
        offsets, total = [], 0
        for numel, dtype in shapes:
            offsets.append(total)
            total += -(-numel * dtype.itemsize // 256) * 256
        regions = world.peer_memory(rank, total)

        def parts(k):
            lo, (numel, dtype) = offsets[k], shapes[k]
            return [region[lo:lo + numel * dtype.itemsize].view(dtype)
                    for region in regions]

        self._parts = {name: parts(k) for k, name in enumerate(layout)}
        self.pads = tpr.PeerParts(parts(len(layout)))
        self.generation = torch.zeros(1, dtype=torch.int32)

    def __getitem__(self, name):
        return self._parts[name]


class _CpuRegions:
    def __init__(self, n):
        self.n, self.sets, self.asked = n, [], [0] * n

    def __call__(self, rank, nbytes):
        k = self.asked[rank]
        self.asked[rank] += 1
        if k == len(self.sets):
            self.sets.append([torch.zeros(nbytes, dtype=torch.uint8)
                              for _ in range(self.n)])
        return self.sets[k]


def _threaded_barrier(cond):
    """peer_barrier's protocol on CPU pads: signal the set's pads, then wait
    (under ``cond``) until each member has signalled this rank's."""
    def barrier(pads, generation, rank, *, peers="all", copy=None):
        members = tpr.barrier_set(peers, len(pads), rank)
        with cond:
            generation += 1
            gen = int(generation)
            for s in members:
                pads[s][rank] = gen
            cond.notify_all()
            assert cond.wait_for(lambda: all(
                int(pads[rank][s]) >= gen for s in members), timeout=30), \
                f"rank {rank} waits at {peers} barrier {gen}"
        if copy is not None:
            copy[1].copy_(copy[0])

    return barrier


#: the steps whose gathers (or all-to-all) push on the card
PUSH_OPS = ("pl_allreduce", "pl_all_gather", "pl_all_gather_bidir",
            "pl_all_to_all")


def _steps_in_threads(op, n, monkeypatch, steps=3, fresh=False):
    """``op``'s card-side steps on CPU tensors, one thread a rank, each
    running ``steps`` chained steps (with ``fresh``, each step on an input
    of its own) with random pauses before every data launch: the barriers
    alone order the ranks.  Returns each step's outputs as the ranks
    returned them (held to the end), the sim world's outputs of the same
    steps, and the ranks that pushed."""
    import random
    import threading
    import time

    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import DistWorld

    random.seed(n)
    monkeypatch.setattr(tpr, "_gloo_path", lambda world: False)
    monkeypatch.setattr(tpr, "PeerBuffers", _CpuPeerBuffers)
    monkeypatch.setattr(tpr, "peer_barrier",
                        _threaded_barrier(threading.Condition()))
    pushed = []
    for name in ("peer_copy", "peer_all_to_all", "peer_all_gather",
                 "peer_all_gather_bidir", "peer_reduce_scatter",
                 "peer_all_gather_push", "peer_all_to_all_push"):
        def paused(*a, _fn=getattr(tpr, name), _name=name, **k):
            time.sleep(random.random() * 2e-3)
            if _name in ("peer_all_gather_push", "peer_all_to_all_push"):
                pushed.append(a[2])
            return _fn(*a, **k)

        monkeypatch.setattr(tpr, name, paused)
    regions = _CpuRegions(n)
    worlds = [DistWorld(rank=r, n=n, local_rank=0, device=CPU,
                        mesh=make_mesh(n=n), peer_memory=regions)
              for r in range(n)]
    built = [tpr.build_pallas_step(op, w, 4108, 3)[0] for w in worlds]
    sim_step, elems, _ = tpr.build_pallas_step(op, SimWorld(n, CPU), 4108, 3)
    rows = example_input(SimWorld(n, CPU), elems, "float32")
    inputs = [rows + 17 * k for k in range(steps)]
    outs, errors = [[None] * n for _ in range(steps)], []

    def rank(r):
        try:
            y = rows[r].clone()
            for k in range(steps):
                y = inputs[k][r].clone() if fresh else y
                y = outs[k][r] = built[r](y)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a rank never ended"
    assert not errors, errors
    wants, want = [], rows
    for k in range(steps):
        want = sim_step(inputs[k] if fresh else want)
        wants.append(want)
    return [torch.stack(o) for o in outs], wants, set(pushed)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["pl_allreduce", "pl_reduce_scatter",
                                "pl_ring", "pl_exchange", "pl_pingpong",
                                "pl_barrier", "pl_all_to_all",
                                "pl_all_gather", "pl_all_gather_bidir"])
def test_card_steps_match_the_sim_chain_with_ranks_in_threads(op, n,
                                                              monkeypatch):
    # the card-side steps on CPU tensors, one thread a rank, each running
    # three chained steps with random pauses around every data launch:
    # the barriers alone order the ranks, so a missing one shows as a
    # mismatch with the sim world's chain (exactly, float32); the gathers
    # of pl_allreduce and the two all-gathers, and the all-to-all, push
    # through the push's plain version, which writes into the other
    # ranks' buffers (as the pingpong's legs do through peer_copy)
    got, wants, pushed = _steps_in_threads(op, n, monkeypatch)
    assert torch.equal(got[-1], wants[-1])
    assert pushed == (set(range(n)) if op in PUSH_OPS else set())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", PUSH_OPS)
def test_a_steps_result_outlives_the_later_steps(op, n, monkeypatch):
    # with the push a rank's symmetric buffers take the peers' stores at
    # every later step: each step returns a tensor no later step writes
    # (each step on an input of its own: the ops' outputs are fixed
    # points of their steps)
    got, wants, pushed = _steps_in_threads(op, n, monkeypatch, steps=4,
                                           fresh=True)
    for k, (g, want) in enumerate(zip(got, wants)):
        assert torch.equal(g, want), f"step {k}'s result changed"
    assert pushed == set(range(n))


@pytest.mark.parametrize("op", ["pl_allreduce", "pl_all_gather"])
def test_the_designs_tools_step_edits_match_the_sim_chain(op, tmp_path,
                                                          monkeypatch):
    # the other way of a step's last execution, which the designs tool
    # times as an edit of pallas_ring.py, is the same chain, and its
    # results outlive the later steps too
    from tpu_perf_torch.tools import peer_designs

    edited = peer_designs.load_steps(peer_designs.step_designs(tmp_path)[op])
    monkeypatch.setattr(sys.modules[__name__], "tpr", edited)
    got, wants, pushed = _steps_in_threads(op, 2, monkeypatch, steps=4,
                                           fresh=True)
    for k, (g, want) in enumerate(zip(got, wants)):
        assert torch.equal(g, want), f"step {k}'s result changed"
    assert pushed == {0, 1}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["pl_all_to_all", "pl_pingpong"])
def test_the_designs_tools_new_step_edits_match_the_sim_chain(op, n,
                                                              monkeypatch):
    # the all-to-all's and the pingpong's last execution pushed, with the
    # step returning a copy (the designs tool's edits of pallas_ring.py),
    # is the same chain, and each step's result outlives the later steps
    import tempfile
    from pathlib import Path

    from tpu_perf_torch.tools import peer_designs

    with tempfile.TemporaryDirectory() as tmp:
        edited = peer_designs.load_steps(
            peer_designs.step_designs(Path(tmp))[op])
    monkeypatch.setattr(sys.modules[__name__], "tpr", edited)
    got, wants, pushed = _steps_in_threads(op, n, monkeypatch, steps=4,
                                           fresh=True)
    for k, (g, want) in enumerate(zip(got, wants)):
        assert torch.equal(g, want), f"step {k}'s result changed"
    assert pushed == (set(range(n)) if op == "pl_all_to_all" else set())


@pytest.mark.parametrize("n", [2, 4, 6])
def test_the_pingpong_step_pushes_both_legs(n, monkeypatch):
    # on the card each leg stores into the partner's memory: group 0
    # copies its input into group 1's stage, group 1 its stage into group
    # 0's input buffer and its own input into its output; only group 0's
    # last leg 2 pulls, into a new tensor.  Each copy is named by the
    # rank that launched it (the rank of the thread's last barrier) and
    # the ranks whose memory holds its source and destination
    import threading

    module = sys.modules[__name__]
    local, regions, copies = threading.local(), [], []
    make_barrier, copy = module._threaded_barrier, tpr.peer_copy

    def recording_barrier(cond):
        inner = make_barrier(cond)

        def barrier(pads, generation, rank, **kw):
            local.rank = rank
            return inner(pads, generation, rank, **kw)
        return barrier

    class Recorded(module._CpuRegions):
        def __init__(self, n):
            super().__init__(n)
            regions.append(self)

    def owner(ptr):
        # the rank whose memory holds ptr; -1 for a new tensor
        for reg in regions:
            for per_rank in reg.sets:
                for s, region in enumerate(per_rank):
                    if 0 <= ptr - region.data_ptr() < region.numel():
                        return s
        return -1

    def logged(name, src, *, out=None):
        copies.append((local.rank, owner(src.data_ptr()),
                       owner(out.data_ptr())))
        return copy(name, src, out=out)

    monkeypatch.setattr(module, "_threaded_barrier", recording_barrier)
    monkeypatch.setattr(module, "_CpuRegions", Recorded)
    monkeypatch.setattr(tpr, "peer_copy", logged)
    steps, half = 2, n // 2
    got, wants, _ = _steps_in_threads("pl_pingpong", n, monkeypatch,
                                      steps=steps)
    assert torch.equal(got[-1], wants[-1])
    partner = {r: (r + half) % n for r in range(n)}
    pushes = [c for c in copies if c[1] == c[0] and c[2] == partner[c[0]]]
    pulls = [c for c in copies if c[1] != c[0]]
    local_copies = [c for c in copies if c[1] == c[0] and c[2] in (c[0], -1)]
    # -i 3 a step: group 0 pushes 3 legs and pulls the last leg 2; group 1
    # pushes 2 legs and copies its own input 3 times
    assert sorted(pushes) == sorted(
        (r, r, partner[r]) for r in range(n)
        for _ in range(steps * (3 if r < half else 2)))
    assert sorted(pulls) == sorted((r, partner[r], -1)
                                   for r in range(half) for _ in range(steps))
    assert sorted(local_copies) == sorted(
        (r, r, -1 if k == 2 else r) for r in range(half, n)
        for k in range(3) for _ in range(steps))
    assert len(copies) == len(pushes) + len(pulls) + len(local_copies)
