"""The port's point-to-point ops against the JAX package, on the CPU:
``pl_ring``, ``pl_exchange``, ``pl_pingpong`` and ``pl_barrier`` (plain
versions of the CUDA kernels against the Pallas kernels under the TPU
interpreter) and the library ops ``pingpong``, ``pingpong_unidir``,
``exchange``, ``ppermute``, ``ring``, ``halo`` and ``barrier`` (against
their XLA bodies), on the same ``make_fill`` input carried across with
``to_world``.

Tolerances: exact (rtol 0) for every op that moves bytes, every dtype.
``barrier`` is a 1-element mean: float32 rtol 1e-6 (sums in another order
over at most 8 ranks), bfloat16 rtol 8e-3, one bfloat16 unit in the last
place.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_perf.ops.pallas_ring as jpr
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import kernels
from tpu_perf_torch.ops.collectives import (
    DTYPES, FLOAT_ONLY_OPS, build_op, payload_elems, shift_rows, to_tensor,
)
from tpu_perf_torch.selftest import run_selftest
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")
RTOL = {"float32": 1e-6, "bfloat16": 8e-3}
DTYPE_NAMES = ["float32", "bfloat16", "int32", "uint8"]
#: a size that is a whole number of elements in no dtype but uint8
NBYTES = 150
LIBRARY_OPS = ["pingpong", "pingpong_unidir", "exchange", "ppermute", "ring",
               "halo"]


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
    rtol = RTOL[dtype] if op == "barrier" else 0
    np.testing.assert_allclose(got, want.astype(np.float64), rtol=rtol, atol=0)


def tile_edge_nbytes(edge: str, itemsize: int) -> int:
    """Per-rank bytes at the row shift's tile edge: one tile, one tile plus
    an element (the last tile holds one), or a size that is no multiple of
    16 bytes."""
    tile = tpr.ROW_COPY_TILE_BYTES
    return {"tile": tile, "tile+item": tile + itemsize,
            "unaligned": 2 * tile + 4}[edge]


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize(
    "op,n,edge",
    [pytest.param(op, n, None, id=f"{op}-{n}")
     for op, n in [("pl_ring", 5), ("pl_ring", 8), ("pl_exchange", 2),
                   ("pl_exchange", 8), ("pl_pingpong", 2), ("pl_pingpong", 8),
                   ("pl_barrier", 2), ("pl_barrier", 8)]]
    + [pytest.param(op, n, edge, id=f"{op}-{n}-{edge}")
       for op, n in [("pl_ring", 5), ("pl_ring", 8), ("pl_exchange", 8)]
       for edge in ["tile", "tile+item", "unaligned"]])
def test_pl_op_matches_jax(op, n, edge, iters, dtype, eight_devices):
    # NBYTES, or the row shift at its kernel's tile edges
    nbytes = (NBYTES if edge is None
              else tile_edge_nbytes(edge, DTYPES[dtype].itemsize))
    _compare(op, n, nbytes, iters, dtype)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("op,n", [(op, 8) for op in LIBRARY_OPS]
                         + [("ring", 5), ("halo", 5), ("exchange", 2)])
def test_library_op_matches_jax(op, n, iters, dtype, eight_devices):
    _compare(op, n, NBYTES, iters, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_barrier_matches_jax(n, iters, dtype, eight_devices):
    _compare("barrier", n, NBYTES, iters, dtype)


@pytest.mark.parametrize("op", ["barrier", "pl_barrier"])
def test_barrier_payload_is_one_element_whatever_the_size(op, eight_devices):
    for nbytes in (1, 4096, 456131):
        assert build_op(op, SimWorld(8, CPU), nbytes, 1).nbytes == 4
    assert "barrier" in FLOAT_ONLY_OPS
    with pytest.raises(ValueError, match="float dtype"):
        build_op("barrier", SimWorld(8, CPU), 64, 1, dtype="int32")
    _compare("pl_barrier", 8, 456131, 2, "uint8")


# --- the traps of the library bodies --------------------------------------


def _small_ints(n, elems, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, 100, (n, elems)).astype(np.float32))


@pytest.mark.parametrize("iters", [1, 3])
def test_pingpong_zero_fills_group_one(iters):
    # ppermute writes zeros on the ranks it does not target: after one
    # iteration group 1 is all zeros and stays so; group 0 keeps its rows
    built = build_op("pingpong", SimWorld(8, CPU), 4 * 7, iters)
    x = built.example_input.clone()
    y = built.step(built.example_input)
    assert torch.equal(y[:4], x[:4])
    assert not y[4:].any()


@pytest.mark.parametrize("iters", [1, 3])
def test_pingpong_unidir_zeroes_only_group_ones_slot_zero(iters):
    # group 0 gets its own first element back as the ack; group 1's slot 0
    # is zeroed (no inbound ack); every other element is untouched
    built = build_op("pingpong_unidir", SimWorld(8, CPU), 4 * 7, iters)
    x = built.example_input.clone()
    y = built.step(built.example_input)
    assert torch.equal(y[:4], x[:4])
    assert not y[4:, 0].any()
    assert torch.equal(y[4:, 1:], x[4:, 1:])


def test_pingpong_unidir_updates_the_carry_in_place():
    # XLA updates slot 0 of the loop carry in place; a clone per execution
    # would add a full copy to what the op times
    built = build_op("pingpong_unidir", SimWorld(4, CPU), 64, 2)
    x = built.example_input
    assert built.step(x).data_ptr() == x.data_ptr()


@pytest.mark.parametrize("n", [1, 3, 8])
def test_halo_takes_the_neighbours_edges(n):
    # an odd request rounds up to an even element count; each rank ends
    # with its left neighbour's right edge, then its right neighbour's
    # left edge
    elems, _ = payload_elems("halo", 4 * 7, n, 4)
    assert elems == 8
    x = _small_ints(n, elems, seed=n)
    y = build_op("halo", SimWorld(n, CPU), 4 * 7, 1).step(x)
    for d in range(n):
        assert torch.equal(y[d, :4], x[(d - 1) % n, 4:])
        assert torch.equal(y[d, 4:], x[(d + 1) % n, :4])


@pytest.mark.parametrize("k", [0, 1, 3, -1, 8, 11])
def test_shift_rows_is_the_ring_permutation(k):
    x = _small_ints(8, 3, seed=k + 20)
    assert torch.equal(shift_rows(x, k), torch.roll(x, k, 0))


# --- the kernels' plain versions on their own ------------------------------


def test_pingpong_goes_through_its_stage():
    # a plain version that skipped the stage would still return the
    # identity: the stage rows of group 1 must hold group 0's payload
    x = _small_ints(6, 5, seed=1)
    out, stage = tpr.pingpong(x)
    assert torch.equal(out, x)
    assert torch.equal(stage[3:], x[:3])


def test_pingpong_plain_writes_only_the_partners_stage_rows():
    # group 0's stage is no target on the TPU either: its rows keep
    # whatever they held
    x = _small_ints(4, 3, seed=2)
    out, stage = torch.empty_like(x), torch.full_like(x, -1.0)
    tpr.pingpong_plain(x, out, stage)
    assert torch.equal(out, x)
    assert torch.equal(stage[:2], torch.full_like(x[:2], -1.0))
    assert torch.equal(stage[2:], x[:2])


def _sentinel_stage(x):
    # NaN for floats, 0xFF for uint8: a stage row the round trip must not
    # touch keeps it
    if x.dtype.is_floating_point:
        return torch.full_like(x, float("nan"))
    return torch.full_like(x, 255)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_pingpong_writes_the_partners_stage_rows_only(n, dtype):
    # the wrapper's (out, stage): out is x, stage rows >= n/2 hold group 0's
    # payload, stage rows < n/2 keep the sentinel a given stage holds
    x = _small_ints(n, 7, seed=n).to(dtype)
    stage = _sentinel_stage(x)
    kept = stage[: n // 2].clone()
    out, got_stage = tpr.pingpong(x, stage)
    assert got_stage is stage
    assert torch.equal(out, x)
    assert torch.equal(stage[n // 2:], x[: n // 2])
    torch.testing.assert_close(stage[: n // 2], kept, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("n", [2, 8])
def test_pingpong_alternating_inputs_through_one_stage(n):
    # two different payloads in turn through one stage, re-filled with the
    # sentinel before each call: each round trip returns its own input, so
    # a return leg that read the stage before its payload landed would
    # show the sentinel or the other payload
    a = _small_ints(n, 9, seed=7)
    b = a.flip(1) + 100
    stage = _sentinel_stage(a)
    for x in (a, b, a, b):
        stage.fill_(float("nan"))
        out, _ = tpr.pingpong(x, stage)
        assert torch.equal(out, x)
        assert torch.equal(stage[n // 2:], x[: n // 2])
        assert stage[: n // 2].isnan().all()


def test_pingpong_refuses_a_stage_of_another_shape_or_dtype():
    x = _small_ints(4, 3, seed=8)
    for stage in (torch.empty(4, 4), torch.empty(4, 3, dtype=torch.float16)):
        with pytest.raises(ValueError, match="pingpong: stage"):
            tpr.pingpong(x, stage)


def test_pingpong_counters_are_zero_and_grow_per_card(monkeypatch):
    # one buffer per card, three words a pair, zero when made, grown (zeroed
    # anew) for more pairs
    monkeypatch.setattr(tpr, "_PINGPONG_COUNTERS", {})
    counters = tpr.pingpong_counters(CPU, 4)
    assert counters.dtype == torch.int32 and counters.numel() == 12
    assert not counters.any()
    assert tpr.pingpong_counters(CPU, 2) is counters
    bigger = tpr.pingpong_counters(CPU, 128)
    assert bigger.numel() == 384 and not bigger.any()
    assert tpr.pingpong_counters(CPU, 4) is bigger


@pytest.mark.parametrize("source", ["p2p_shift", "hbm_copy", "all_gather"])
def test_row_copy_counters_are_zero_and_one_buffer_per_source_and_card(
        source, monkeypatch):
    # one buffer per source and card, two words (next tile, CTAs done),
    # zero when made, the same buffer on every later call
    monkeypatch.setattr(tpr, "_ROW_COPY_COUNTERS",
                        {"p2p_shift": {}, "hbm_copy": {}, "all_gather": {}})
    counters = tpr.row_copy_counters(source, CPU)
    assert counters.dtype == torch.int32 and counters.numel() == 2
    assert not counters.any()
    assert tpr.row_copy_counters(source, CPU) is counters
    for other in {"p2p_shift", "hbm_copy", "all_gather"} - {source}:
        assert tpr.row_copy_counters(other, CPU) is not counters
    with pytest.raises(KeyError):
        tpr.row_copy_counters("pingpong", CPU)


@pytest.mark.parametrize("n", [2, 5, 8])
def test_ring_and_exchange_plain_versions_shift_rows(n):
    x = _small_ints(n, 4, seed=n)
    assert torch.equal(tpr.ring_shift(x), torch.roll(x, 1, 0))
    assert torch.equal(tpr.barrier(x), x) and tpr.barrier(x) is not x
    if n % 2:
        with pytest.raises(ValueError, match="even rank count"):
            tpr.pair_exchange(x)
        with pytest.raises(ValueError, match="even rank count"):
            tpr.pingpong(x)
    else:
        assert torch.equal(tpr.pair_exchange(x), torch.roll(x, n // 2, 0))


def test_cpu_tensors_take_the_p2p_plain_versions():
    kernels.reset_counts()
    x = _small_ints(4, 6, seed=3)
    tpr.ring_shift(x)
    tpr.pair_exchange(x)
    tpr.pingpong(x)
    tpr.barrier(tpr.barrier(x))
    assert kernels.PLAIN_CALLS == {**dict.fromkeys(kernels.KERNELS, 0),
                                   "ring": 1, "exchange": 1, "pingpong": 1,
                                   "barrier": 2}
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("wrapper", [
    lambda x: tpr.ring_shift(x),
    lambda x: tpr.pair_exchange(x),
    lambda x: tpr.pingpong(x),
    lambda x: tpr.barrier(x),
])
def test_p2p_wrappers_refuse_other_devices(wrapper):
    # only a CPU tensor takes the plain version; any other non-CUDA device
    # is an error, never a quiet fallback
    with pytest.raises(ValueError, match="kernel needs cuda"):
        wrapper(torch.empty((4, 8), device="meta"))


@pytest.mark.parametrize("n,layout", [(2, (2, 1)), (8, (8, 1)), (9, (8, 2)),
                                      (256, (8, 32)), (257, None)])
def test_barrier_layout(n, layout):
    # min(n, 8) CTAs of one portable cluster, ceil(n / ctas) warps each
    if layout is None:
        with pytest.raises(ValueError, match="at most 256"):
            tpr.barrier_layout(n)
        return
    ctas, warps = tpr.barrier_layout(n)
    assert (ctas, warps) == layout
    # rank r is warp r % warps of CTA r // warps: every rank has a warp of
    # its own inside the cluster (at n = 9 CTAs 5-7 hold none and only
    # join the barrier), and fewer warps would not do
    assert (n - 1) // warps < ctas <= 8 and warps <= 32
    assert ctas * (warps - 1) < n


def test_barrier_refuses_more_ranks_than_one_cluster_holds():
    # the plain version takes what the kernel takes, no more
    assert torch.equal(tpr.barrier(_small_ints(256, 1, seed=4)),
                       _small_ints(256, 1, seed=4))
    with pytest.raises(ValueError, match="at most 256"):
        tpr.barrier(_small_ints(257, 1, seed=5))


def test_the_steps_chain_the_kernels(eight_devices):
    kernels.reset_counts()
    world = SimWorld(4, CPU)
    for op, name in (("pl_ring", "ring"), ("pl_exchange", "exchange"),
                     ("pl_pingpong", "pingpong"), ("pl_barrier", "barrier")):
        built = build_op(op, world, 64, 3)
        built.step(built.example_input)
        assert kernels.PLAIN_CALLS[name] == 3, op


# --- sizes and errors: the JAX package's -----------------------------------

_SIZES = [1, 13, 150, 4096, 456131, 3 * 2**20 + 7]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("op", ["pl_ring", "pl_exchange", "pl_pingpong",
                                "pl_barrier"])
def test_build_pallas_step_sizes_match_jax(op, dtype, eight_devices):
    for n in (2, 4, 8):
        mesh = make_mesh(devices=jax.devices()[:n])
        for nbytes in _SIZES:
            _, jx, actual, jn = jpr.build_pallas_step(op, mesh, nbytes, 1,
                                                      dtype=dtype)
            _, elems, got = tpr.build_pallas_step(op, SimWorld(n, CPU),
                                                  nbytes, 1, dtype=dtype)
            assert (elems * n, got, n) == (jx.shape[0], actual, jn), nbytes


@pytest.mark.parametrize("op,n", [("pl_exchange", 5), ("pl_pingpong", 3),
                                  ("pl_barrier", 1), ("pingpong", 5),
                                  ("pingpong_unidir", 3), ("exchange", 7),
                                  ("ppermute", 5)])
def test_rank_count_errors_match_jax(op, n, eight_devices):
    mesh = make_mesh(devices=jax.devices()[:n])
    with pytest.raises(ValueError) as theirs:
        jax_build_op(op, mesh, 64, 1)
    with pytest.raises(ValueError) as ours:
        build_op(op, SimWorld(n, CPU), 64, 1)
    assert str(ours.value) == str(theirs.value)


def test_ported_ops_leave_only_the_collectives():
    # the collectives slice ported the last two: every pl_* op of the JAX
    # package builds here
    assert tpr.PALLAS_OPS == jpr.PALLAS_OPS
    for op in ("pl_all_gather_bidir", "pl_all_to_all"):
        tpr.build_pallas_step(op, SimWorld(8, CPU), 64, 1)


# --- selftest models ------------------------------------------------------

P2P_OPS = LIBRARY_OPS + ["barrier", "pl_ring", "pl_exchange", "pl_pingpong",
                         "pl_barrier"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_selftest_models_pass_for_the_p2p_ops(n, dtype):
    results = run_selftest(SimWorld(n, CPU), ops=P2P_OPS, nbytes=4 * 9 + 2,
                           dtype=dtype, iters=3)
    skips = {r.op: r.detail for r in results if r.status == "skip"}
    want = {}
    if n % 2:
        want.update(dict.fromkeys(
            ["pingpong", "pingpong_unidir", "exchange", "ppermute",
             "pl_exchange", "pl_pingpong"], "needs an even device count"))
    if n < 2:
        want["pl_barrier"] = "needs at least 2 devices"
    if not DTYPES[dtype].is_floating_point:
        want.setdefault("barrier", "float dtypes only")
    assert skips == want
    assert all(r.status == "ok" for r in results if r.op not in want), results


def test_selftest_catches_a_pingpong_that_keeps_group_one(monkeypatch):
    # the pingpong model is not vacuous: an identity body fails it
    import tpu_perf_torch.ops.collectives as coll

    monkeypatch.setitem(coll.OP_BUILDERS, "pingpong",
                        lambda world, dtype: (lambda x: x.clone()))
    (result,) = run_selftest(SimWorld(4, CPU), ops=["pingpong"], nbytes=64)
    assert result.status == "fail"
