"""The port's ring kernels (plain PyTorch versions, on the CPU) against the
JAX package's Pallas kernels under the TPU interpreter, on the same
``make_fill`` input carried across with ``to_world``.

Tolerance: rtol 1e-6 for float32 — both sides sum each chunk in ring
order (the interpreter's tiled adds and the plain version's per-step
adds visit the ranks in the same order), so they agree to the last bit
or nearly.  bfloat16 is held to one bfloat16 unit in the last place
(rtol 8e-3): the adds round identically, but XLA may keep the 1/n scale's
product in float32 before its final rounding.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_perf.ops.pallas_ring as jpr
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.ops import payload_elems as jax_payload_elems
from tpu_perf.parallel import make_mesh

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import kernels
from tpu_perf_torch.ops.collectives import build_op, payload_elems, to_tensor
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")
RTOL = {"float32": 1e-6, "bfloat16": 8e-3, "int32": 0, "uint8": 0}


def _jax(op, n, nbytes, iters, dtype="float32"):
    mesh = make_mesh(devices=jax.devices()[:n])
    built = jax_build_op(op, mesh, nbytes, iters, dtype=dtype)
    x = np.asarray(jax.device_get(built.example_input)).astype(np.float64)
    y = np.asarray(jax.device_get(built.step(built.example_input)))
    return built, x, y.astype(np.float64)


def _port(op, n, x_global, nbytes, iters, dtype="float32"):
    built = build_op(op, SimWorld(n, CPU), nbytes, iters, dtype=dtype)
    x = to_tensor(to_world(x_global, n), dtype, CPU)
    # the state both sides compute on is the same, element for element
    assert torch.equal(x, built.example_input)
    return built, from_world(built.step(x)).astype(np.float64)


def _compare(op, n, nbytes, iters, dtype="float32"):
    jb, x, want = _jax(op, n, nbytes, iters, dtype)
    pb, got = _port(op, n, x, nbytes, iters, dtype)
    assert (pb.nbytes, pb.n_devices) == (jb.nbytes, jb.n_devices)
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("op", ["pl_allreduce", "pl_reduce_scatter",
                                "pl_all_gather"])
def test_ring_op_matches_jax(op, n, iters, eight_devices):
    _compare(op, n, n * 4 * 4, iters)


def test_pl_allreduce_bf16_matches_jax(eight_devices):
    _compare("pl_allreduce", 8, 8 * 8 * 2, 2, "bfloat16")


@pytest.mark.parametrize("op", ["pl_allreduce", "pl_reduce_scatter"])
def test_multi_tile_accumulation_matches_jax(op, eight_devices, monkeypatch):
    # raw chunk 10 rounds up to 12 = three tiles of 4 on both sides
    monkeypatch.setattr(jpr, "_ACC_TILE_ELEMS", 4)
    monkeypatch.setattr(tpr, "_ACC_TILE_ELEMS", 4)
    _compare(op, 8, 8 * 10 * 4, 1)
    assert build_op(op, SimWorld(8, CPU), 8 * 10 * 4, 1).nbytes == 8 * 12 * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_pl_hbm_stream_matches_jax(dtype, eight_devices):
    _compare("pl_hbm_stream", 8, 4 * 37, 3, dtype)


# --- the ring schedules on their own: ownership, wire rows, n = 1 ---


def _ranks_input(n, row, seed):
    rng = np.random.default_rng(seed)
    # small integers in float32: every sum is exact, so any misrouted
    # chunk shows as an exact mismatch, not a rounding difference
    return torch.from_numpy(rng.integers(-50, 50, (n, row)).astype(np.float32))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_ring_reduce_scatter_ownership(n):
    chunk = 3
    x = _ranks_input(n, n * chunk, seed=n)
    out = tpr.ring_reduce_scatter(x)
    total = x.view(n, n, chunk).sum(0)  # chunk c summed over ranks
    for d in range(n):
        # rank d owns chunk d (psum_scatter(tiled=True)) ...
        assert torch.equal(out.view(n, n, chunk)[d, d], total[d])
        # ... and its own forwarded chunk d-1 stays its unreduced input
        assert torch.equal(out.view(n, n, chunk)[d, (d - 1) % n],
                           x.view(n, n, chunk)[d, (d - 1) % n])


@pytest.mark.parametrize("n", [3, 5])
def test_ring_reduce_scatter_stage_rows_hold_the_wire(n):
    # staging row k of rank d holds the left neighbour's running partial
    # of chunk (d-2-k) mod n: the sum of that chunk over ranks d-1-k..d-1
    chunk = 2
    x = _ranks_input(n, n * chunk, seed=10 + n)
    out = torch.empty_like(x)
    stage = x.new_empty((n, n - 1, chunk))
    tpr.ring_reduce_scatter_plain(x, out, stage)
    xc = x.view(n, n, chunk)
    for d in range(n):
        for k in range(n - 1):
            r = (d - 2 - k) % n
            want = sum(xc[(d - 1 - j) % n, r] for j in range(k + 1))
            assert torch.equal(stage[d, k], want)


@pytest.mark.parametrize("src_full", [False, True])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_ring_all_gather_every_row_gathers_every_chunk(n, src_full):
    chunk = 3
    x = _ranks_input(n, n * chunk if src_full else chunk, seed=20 + n)
    own = x.view(n, n, chunk)[range(n), range(n)] if src_full else x
    out = tpr.ring_all_gather(x, src_full=src_full)
    assert torch.equal(out, own.reshape(1, -1).expand(n, -1))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kernels.reset_counts()
    x = _ranks_input(4, 8, seed=0)
    tpr.ring_all_gather(tpr.ring_reduce_scatter(x), src_full=True)
    tpr.stream(x)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)
    assert kernels.PLAIN_CALLS == dict.fromkeys(kernels.KERNELS, 1)


@pytest.mark.parametrize("wrapper", [
    lambda x: tpr.ring_reduce_scatter(x),
    lambda x: tpr.ring_all_gather(x),
    lambda x: tpr.stream(x),
])
def test_wrappers_refuse_other_devices(wrapper):
    # only a CPU tensor takes the plain version; a non-CUDA device is an
    # error, never a quiet fallback
    with pytest.raises(ValueError):
        wrapper(torch.empty((4, 8), device="meta"))


def test_ring_reduce_scatter_rejects_ints_and_one_rank():
    with pytest.raises(ValueError, match="floats"):
        tpr.ring_reduce_scatter(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match=">= 2 ranks"):
        tpr.ring_reduce_scatter(torch.zeros((1, 4)))


# --- sizes: the same rounding as the JAX package ---

_SIZES = [1, 13, 100, 4096, 456131, 8 * 65536 * 4 + 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 5, 8])
@pytest.mark.parametrize("op", ["pl_all_gather", "pl_reduce_scatter",
                                "pl_allreduce", "pl_hbm_stream"])
def test_build_pallas_step_sizes_match_jax(op, n, dtype, eight_devices):
    mesh = make_mesh(devices=jax.devices()[:n])
    for nbytes in _SIZES:
        _, jx, actual, jn = jpr.build_pallas_step(op, mesh, nbytes, 1,
                                                  dtype=dtype)
        _, elems, got_actual = tpr.build_pallas_step(
            op, SimWorld(n, CPU), nbytes, 1, dtype=dtype)
        assert (elems * n, got_actual, n) == (jx.shape[0], actual, jn), nbytes


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("op", ["allreduce", "hbm_stream", "all_gather",
                                "reduce_scatter", "barrier", "halo"])
def test_payload_elems_match_jax(op, itemsize):
    for n in (1, 2, 5, 8):
        for nbytes in _SIZES + [4 * 1024**2, 1024**3]:
            assert (payload_elems(op, nbytes, n, itemsize)
                    == jax_payload_elems(op, nbytes, n, itemsize))


def test_hbm_dma_block_elems_matches_jax():
    for itemsize in (1, 2, 4):
        for elems in (1, 1000, 2**18, 2**19, 2**20, 2**24):
            assert (tpr.hbm_dma_block_elems(itemsize, elems)
                    == jpr.hbm_dma_block_elems(itemsize, elems))


@pytest.mark.parametrize("op", sorted(set(tpr.PALLAS_OPS) - set(tpr.PORTED_OPS)))
def test_unported_kernels_say_so(op):
    assert op in jpr.PALLAS_OPS
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_op(op, SimWorld(8, CPU), 64, 1)
