"""The port's collectives against the JAX package, on the CPU: the library
ops ``all_gather``, ``reduce_scatter``, ``all_to_all``, ``broadcast`` and
``broadcast_psum`` (against their XLA bodies) and the kernels
``pl_all_to_all`` and ``pl_all_gather_bidir`` (plain versions of the CUDA
kernels against the Pallas kernels under the TPU interpreter), on the same
``make_fill`` input carried across with ``to_world``.

Tolerances: exact (rtol 0) for every op that moves bytes, every dtype.
``reduce_scatter`` is a mean over the ranks: float32 rtol 1e-6 (sums in
another order than XLA's over at most 8 ranks), bfloat16 rtol 8e-3, one
bfloat16 unit in the last place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import tpu_perf.ops.pallas_ring as jpr
import tpu_perf.schema as jschema
from tpu_perf.compat import shard_map
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.ops import payload_elems as jax_payload_elems
from tpu_perf.ops.collectives import FLOAT_ONLY_OPS as JAX_FLOAT_ONLY_OPS
from tpu_perf.parallel import make_mesh

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import cli, kernels
from tpu_perf_torch.metrics import _BUS_FACTORS
from tpu_perf_torch.ops.collectives import (
    DTYPES, FLOAT_ONLY_OPS, build_op, payload_elems, to_tensor,
)
from tpu_perf_torch.selftest import run_selftest
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")
RTOL = {"float32": 1e-6, "bfloat16": 8e-3}
DTYPE_NAMES = ["float32", "bfloat16", "int32", "uint8"]
#: a size that is a whole number of elements in no dtype but uint8; its
#: chunks are odd or even by dtype and rank count
NBYTES = 150
MOVEMENT_OPS = ["all_gather", "all_to_all", "broadcast", "broadcast_psum"]
LIBRARY_OPS = MOVEMENT_OPS + ["reduce_scatter"]
PL_OPS = ["pl_all_to_all", "pl_all_gather_bidir"]
NEW_OPS = LIBRARY_OPS + PL_OPS


def _compare(op, n, nbytes, iters, dtype):
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, nbytes, iters, dtype=dtype)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    pb = build_op(op, SimWorld(n, CPU), nbytes, iters, dtype=dtype)
    xt = to_tensor(to_world(x, n), dtype, CPU)
    # the state both sides compute on is the same, element for element
    assert torch.equal(xt, pb.example_input)
    got = from_world(pb.step(xt)).astype(np.float64)
    assert (pb.nbytes, pb.n_devices) == (jb.nbytes, jb.n_devices)
    rtol = RTOL[dtype] if op == "reduce_scatter" else 0
    np.testing.assert_allclose(got, want.astype(np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 8])
@pytest.mark.parametrize("op", MOVEMENT_OPS)
def test_library_op_matches_jax(op, n, iters, dtype, eight_devices):
    _compare(op, n, NBYTES, iters, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_reduce_scatter_matches_jax(n, iters, dtype, eight_devices):
    _compare("reduce_scatter", n, NBYTES, iters, dtype)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("op,n", [("pl_all_to_all", 1), ("pl_all_to_all", 5),
                                  ("pl_all_to_all", 8),
                                  ("pl_all_gather_bidir", 1),
                                  ("pl_all_gather_bidir", 2),
                                  ("pl_all_gather_bidir", 5),
                                  ("pl_all_gather_bidir", 8)])
def test_pl_op_matches_jax(op, n, iters, dtype, eight_devices):
    _compare(op, n, NBYTES, iters, dtype)


def test_reduce_scatter_is_float_only_with_the_jax_message(eight_devices):
    assert "reduce_scatter" in FLOAT_ONLY_OPS
    assert set(FLOAT_ONLY_OPS) <= set(JAX_FLOAT_ONLY_OPS)
    for dtype in ("int32", "uint8"):
        with pytest.raises(ValueError) as theirs:
            jax_build_op("reduce_scatter", make_mesh(), 64, 1, dtype=dtype)
        with pytest.raises(ValueError) as ours:
            build_op("reduce_scatter", SimWorld(8, CPU), 64, 1, dtype=dtype)
        assert str(ours.value) == str(theirs.value)


# --- the whole gathered buffer of the bidirectional kernel ---------------


def _jax_bidir_gather(host: np.ndarray, n: int, chunk: int) -> np.ndarray:
    """The raw Pallas kernel (no take-own-shard carry) under the TPU
    interpreter: every device's whole gathered buffer, ``(n, n*chunk)``."""
    mesh = make_mesh(devices=jax.devices()[:n])
    axis = mesh.axis_names[0]
    kern = jpr._all_gather_bidir_kernel(axis, n, chunk)
    sems = pltpu.SemaphoreType.DMA((n - 1,))

    def call(x):
        return pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((chunk * n,), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[pltpu.SemaphoreType.DMA, sems, sems, sems, sems],
            compiler_params=pltpu.CompilerParams(
                collective_id=jpr._COLLECTIVE_IDS["pl_all_gather_bidir"]),
            interpret=pltpu.InterpretParams(),
        )(x)

    step = jax.jit(shard_map(call, mesh=mesh, in_specs=P(axis),
                             out_specs=P(axis), check_vma=False))
    x = jax.device_put(jnp.asarray(host.reshape(-1)),
                       NamedSharding(mesh, P(axis)))
    return np.asarray(jax.device_get(step(x))).reshape(n, n * chunk)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n,chunk", [(2, 2), (5, 6), (8, 6), (8, 4)])
def test_bidir_plain_gathers_the_jax_kernels_whole_buffer(n, chunk, dtype,
                                                          eight_devices):
    # the carry takes the own shard back, so only the whole buffer shows a
    # swapped half or a counter-clockwise index off by one
    host = (np.arange(n * chunk) % 251).astype(dtype).reshape(n, chunk)
    want = _jax_bidir_gather(host, n, chunk)
    out = tpr.direct_all_gather_bidir_plain(torch.from_numpy(host.copy()))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(want, np.broadcast_to(host.reshape(-1),
                                                        want.shape))


# --- ownership with exact small integers ----------------------------------


def _owned(n, elems):
    # element e of rank r holds 1000 * r + e: every value names its owner
    # and its place, so a chunk in the wrong slot cannot pass on a ramp
    return (1000 * torch.arange(n)[:, None] + torch.arange(elems)).float()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_all_to_all_ownership(n):
    chunk = 3
    x = _owned(n, n * chunk)
    out = tpr.all_to_all(x).view(n, n, chunk)
    xc = x.view(n, n, chunk)
    for d in range(n):
        for s in range(n):
            # slot s of rank d holds what rank s held for rank d
            assert torch.equal(out[d, s], xc[s, d]), (d, s)
    assert torch.equal(tpr.all_to_all(tpr.all_to_all(x)), x)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_ring_all_gather_bidir_ownership(n):
    chunk = 6  # halves of 3: the odd half-chunk of the TPU kernel's split
    x = _owned(n, chunk)
    out = tpr.direct_all_gather_bidir(x)
    for d in range(n):
        assert torch.equal(out[d], x.reshape(-1)), d


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("op", ["all_to_all", "pl_all_to_all"])
def test_all_to_all_at_odd_iters_is_no_identity(op, iters):
    # the transpose is an involution: a step that did nothing would pass at
    # even iters, so odd ones must move every off-diagonal chunk
    built = build_op(op, SimWorld(4, CPU), 4 * 4 * 2, iters)
    x = built.example_input.clone()
    y = built.step(built.example_input)
    assert torch.equal(y.view(4, 4, 2), x.view(4, 4, 2).transpose(0, 1))
    assert not torch.equal(y, x)


# --- the library bodies' carries ------------------------------------------


def test_reduce_scatter_updates_only_the_own_chunk_in_place():
    n, chunk = 4, 3
    built = build_op("reduce_scatter", SimWorld(n, CPU), 4 * n * chunk, 1)
    x = _owned(n, n * chunk)
    before = x.clone().view(n, n, chunk)
    y = built.step(x)
    assert y.data_ptr() == x.data_ptr()
    yc = y.view(n, n, chunk)
    mean = before.sum(0) / n
    for d in range(n):
        for c in range(n):
            assert torch.equal(yc[d, c], mean[d] if c == d else before[d, c])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9])
def test_broadcast_is_the_binomial_tree_in_place(n, monkeypatch):
    x = _owned(n, 5)
    body = build_op("broadcast", SimWorld(n, CPU), 20, 1).step
    copies = []
    real_setitem = torch.Tensor.__setitem__

    def spy(self, key, value):
        copies.append((key.start, key.stop, value.shape[0]))
        return real_setitem(self, key, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", spy)
    y = body(x)
    monkeypatch.undo()
    assert y.data_ptr() == x.data_ptr()
    assert torch.equal(y, _owned(1, 5).expand(n, 5))
    # ceil(log2 n) rounds, round k copying rows [0, hi - lo) to [lo, hi)
    want, lo = [], 1
    while lo < n:
        hi = min(2 * lo, n)
        want.append((lo, hi, hi - lo))
        lo = hi
    assert copies == want
    assert sum(c for _, _, c in copies) == n - 1


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_broadcast_psum_sends_rank_zeros_row_in_any_dtype(dtype):
    built = build_op("broadcast_psum", SimWorld(5, CPU), 64, 1, dtype=dtype)
    x = built.example_input
    y = built.step(x)
    assert y.dtype == x.dtype and y.data_ptr() != x.data_ptr()
    assert torch.equal(y, x[:1].expand_as(x))


def test_all_gather_gathers_before_it_takes_the_own_shard(monkeypatch):
    # the result is the identity; the gathered copy must still be made
    made = []
    real = torch.Tensor.contiguous

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        made.append(tuple(out.shape))
        return out

    built = build_op("all_gather", SimWorld(4, CPU), 4 * 4 * 3, 1)
    x = built.example_input
    monkeypatch.setattr(torch.Tensor, "contiguous", spy)
    y = built.step(x)
    monkeypatch.undo()
    assert made == [(4, 12)]
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


# --- the kernels' wrappers ------------------------------------------------


def test_cpu_tensors_take_the_collective_plain_versions(eight_devices):
    kernels.reset_counts()
    world = SimWorld(8, CPU)
    for op, name in (("pl_all_to_all", "all_to_all"),
                     ("pl_all_gather_bidir", "direct_all_gather_bidir")):
        built = build_op(op, world, 4096, 3)
        built.step(built.example_input)
        assert kernels.PLAIN_CALLS[name] == 3, op
    assert kernels.PLAIN_CALLS == {**dict.fromkeys(kernels.KERNELS, 0),
                                   "all_to_all": 3, "direct_all_gather_bidir": 3}
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("wrapper", [
    lambda x: tpr.all_to_all(x),
    lambda x: tpr.direct_all_gather_bidir(x),
])
def test_collective_wrappers_refuse_other_devices(wrapper):
    # only a CPU tensor takes the plain version; any other non-CUDA device
    # is an error, never a quiet fallback
    with pytest.raises(ValueError, match="kernel needs cuda"):
        wrapper(torch.empty((4, 8), device="meta"))


def test_collective_wrappers_refuse_shapes_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="whole chunks"):
        tpr.all_to_all(torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="in half"):
        tpr.direct_all_gather_bidir(torch.zeros((4, 3)))


# --- sizes: the JAX package's ---------------------------------------------

_SIZES = [1, 13, 150, 4096, 456131, 3 * 2**20 + 7]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("op", PL_OPS)
def test_build_pallas_step_sizes_match_jax(op, dtype, eight_devices):
    for n in (1, 2, 5, 8):
        mesh = make_mesh(devices=jax.devices()[:n])
        for nbytes in _SIZES:
            _, jx, actual, jn = jpr.build_pallas_step(op, mesh, nbytes, 1,
                                                      dtype=dtype)
            _, elems, got = tpr.build_pallas_step(op, SimWorld(n, CPU),
                                                  nbytes, 1, dtype=dtype)
            assert (elems * n, got, n) == (jx.shape[0], actual, jn), nbytes


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("op", ["all_to_all", "broadcast", "broadcast_psum"])
def test_payload_elems_match_jax(op, itemsize):
    for n in (1, 2, 5, 8):
        for nbytes in _SIZES + [4 * 1024**2, 1024**3]:
            assert (payload_elems(op, nbytes, n, itemsize)
                    == jax_payload_elems(op, nbytes, n, itemsize))


def test_bidir_rounds_its_chunk_to_even():
    # gathered-total semantics; an odd shard rounds up to split in halves
    assert build_op("pl_all_gather_bidir", SimWorld(8, CPU), 8 * 3 * 4,
                    1).nbytes == 8 * 4 * 4


@pytest.mark.parametrize("op", NEW_OPS)
def test_bus_factors_match_jax(op):
    from tpu_perf.metrics import _BUS_FACTORS as JAX_BUS_FACTORS

    for n in (1, 2, 5, 8):
        assert _BUS_FACTORS[op](n) == JAX_BUS_FACTORS[op](n)


# --- the run path and the selftest models ---------------------------------


@pytest.mark.parametrize("op", NEW_OPS)
def test_run_rows_parse_with_the_jax_schema(op, capsys):
    assert cli.main(["run", "--op", op, "--sim-ranks", "8", "--device", "cpu",
                     "-b", "4K", "-i", "2", "-r", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert lines[0] == jschema.RESULT_HEADER
    rows = [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]
    assert len(rows) == 2
    want = build_op(op, SimWorld(8, CPU), 4096, 2).nbytes
    assert {(r.op, r.backend, r.n_devices, r.iters, r.nbytes) for r in rows} \
        == {(op, "torch-sim", 8, 2, want)}
    assert all(r.busbw_gbps > 0 and r.lat_us > 0 for r in rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_selftest_models_pass_for_the_collectives(n, dtype):
    results = run_selftest(SimWorld(n, CPU), ops=NEW_OPS, nbytes=4 * 9 + 2,
                           dtype=dtype, iters=3)
    skips = {r.op: r.detail for r in results if r.status == "skip"}
    want = {} if DTYPES[dtype].is_floating_point else {
        "reduce_scatter": "float dtypes only"}
    assert skips == want
    assert all(r.status == "ok" for r in results if r.op not in want), results


@pytest.mark.parametrize("op", ["all_to_all", "pl_all_to_all", "broadcast",
                                "broadcast_psum", "reduce_scatter"])
def test_selftest_catches_a_body_that_does_nothing(op, monkeypatch):
    # the models are not vacuous: a copy in place of the op fails them
    import tpu_perf_torch.ops.collectives as coll

    if op == "pl_all_to_all":
        monkeypatch.setattr(tpr, "all_to_all", lambda x: x.clone())
    else:
        monkeypatch.setitem(coll.OP_BUILDERS, op,
                            lambda world, dtype: (lambda x: x.clone()))
    (result,) = run_selftest(SimWorld(4, CPU), ops=[op], nbytes=64, iters=1)
    assert result.status == "fail"


def test_selftest_cannot_see_a_bidir_that_swaps_the_peers_halves(monkeypatch):
    # why the whole-buffer and ownership tests exist: the carry takes the
    # own chunk back, so a gather that swaps every peer's halves passes
    def swapped(x):
        n, chunk = x.shape
        h = chunk // 2
        out = torch.cat([x[:, h:], x[:, :h]], 1).reshape(1, -1).expand(
            n, -1).contiguous()
        d = torch.arange(n)
        out.view(n, n, chunk)[d, d] = x
        return out

    x = _owned(4, 4)
    assert not torch.equal(swapped(x), tpr.direct_all_gather_bidir(x))
    monkeypatch.setattr(tpr, "direct_all_gather_bidir", swapped)
    (result,) = run_selftest(SimWorld(4, CPU), ops=["pl_all_gather_bidir"],
                             nbytes=64, iters=1)
    assert result.status == "ok"
