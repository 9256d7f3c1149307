"""The port's ring kernels (plain PyTorch versions, on the CPU) against the
JAX package's Pallas kernels under the TPU interpreter, on the same
``make_fill`` input carried across with ``to_world``.

Tolerance: rtol 1e-6 for float32 — both sides sum each chunk in ring
order (the interpreter's tiled adds and the plain version's adds visit the
ranks in the same order), so they agree to the last bit; the
order-sensitive reduce-scatter tests hold that exactly (rtol 0).  bfloat16
is held to one bfloat16 unit in the last place (rtol 8e-3): the adds round
identically, but XLA may keep the 1/n scale's product in float32 before its
final rounding.  The scaled carries on seeded inputs are held exactly in
float32, bfloat16 and float16 (``test_scaled_carries_match_jax``).
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
from tpu_perf.compat import shard_map
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


# --- the kernels on their own: ownership, order of accumulation, n = 1 ---


def _ranks_input(n, row, seed):
    rng = np.random.default_rng(seed)
    # small integers in float32: every sum is exact, so any misrouted
    # chunk shows as an exact mismatch, not a rounding difference
    return torch.from_numpy(rng.integers(-50, 50, (n, row)).astype(np.float32))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_ring_reduce_scatter_ownership(n):
    chunk = 3
    x = _ranks_input(n, n * chunk, seed=n)
    out = tpr.direct_reduce_scatter(x)
    # rank d owns chunk d summed over ranks (psum_scatter(tiled=True))
    assert out.shape == (n, chunk)
    assert torch.equal(out, x.view(n, n, chunk).sum(0))


def _ring_order_sum(xc, dtype=np.float32):
    # numpy, one add at a time in the TPU ring's order: chunk c starts from
    # rank c+1 and adds ranks c+2, ..., c+n (mod n), rounding to the
    # working type after every add
    n = xc.shape[0]
    out = np.empty((n, xc.shape[2]), dtype)
    for c in range(n):
        acc = xc[(c + 1) % n, c].astype(dtype)
        for j in range(2, n + 1):
            acc = (acc + xc[(c + j) % n, c].astype(dtype)).astype(dtype)
        out[c] = acc
    return out


def _order_sensitive(n, chunk, seed):
    # 1e8 swallows a 1 in float32 (its unit in the last place is 8), so the
    # order of addition decides the sum
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([1e8, -1e8, 1.0, -1.0, 3.0, 0.5], np.float32),
                      (n, n * chunk))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_direct_reduce_scatter_sums_in_ring_order(n, eight_devices):
    chunk = 64
    xg = _order_sensitive(n, chunk, seed=30 + n)
    xc = xg.reshape(n, n, chunk)
    want = _ring_order_sum(xc)
    got = tpr.direct_reduce_scatter(torch.from_numpy(xg)).numpy()
    np.testing.assert_array_equal(got, want)
    if n > 2:
        # the inputs do tell the orders apart (two ranks' sum has only one)
        in_rank_order = xc[0].copy()
        for s in range(1, n):
            in_rank_order = in_rank_order + xc[s]
        assert not np.array_equal(want, in_rank_order.reshape(n, chunk))
    # the JAX kernel under the Pallas interpreter, through the same carry:
    # owned chunk * 1/n tiled over the row, rounded the same way
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op("pl_reduce_scatter", mesh, n * chunk * 4, 1)
    jy = np.asarray(jax.device_get(jb.step(jax.device_put(
        xg.reshape(-1), jb.example_input.sharding))))
    pb = build_op("pl_reduce_scatter", SimWorld(n, CPU), n * chunk * 4, 1)
    py = from_world(pb.step(torch.from_numpy(xg)))
    np.testing.assert_array_equal(py, jy)
    if n in (2, 8):
        # 1/n is a power of two: the JAX kernel's owned chunks come back
        # exactly
        owned = jy.reshape(n, n, chunk)[:, 0] * np.float32(n)
        np.testing.assert_array_equal(got, owned)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_direct_reduce_scatter_rounds_after_every_add(dtype):
    import ml_dtypes

    np_dtype = np.float16 if dtype == "float16" else ml_dtypes.bfloat16
    n, chunk = 8, 256
    rng = np.random.default_rng(40)
    xg = (rng.standard_normal((n, n * chunk))
          * rng.choice([1.0, 64.0, 1 / 64], (n, n * chunk))).astype(np_dtype)
    xc = xg.reshape(n, n, chunk)
    want = _ring_order_sum(xc, np_dtype).astype(np.float32)
    x = torch.from_numpy(xg.astype(np.float32)).to(getattr(torch, dtype))
    got = tpr.direct_reduce_scatter(x).float().numpy()
    np.testing.assert_array_equal(got, want)
    # one rounding of the float32 sum would give other values
    once = xc.astype(np.float32).sum(0).astype(np_dtype).astype(np.float32)
    assert not np.array_equal(got, once)


# --- the carry's 1/n scale and tiling, in the kernel's epilogue ---


def _np_dtype(dtype):
    import ml_dtypes

    return {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
            "float16": np.float16}[dtype]


def _dtype_inv(n, dtype):
    # 1/n rounded to the dtype, as the JAX carries' jnp.asarray(inv, dtype)
    return float(np.asarray(1.0 / n).astype(_np_dtype(dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mean_scale_is_the_jax_carries_rounding(dtype):
    import jax.numpy as jnp

    for n in range(2, 257):
        want = float(np.asarray(jnp.asarray(1.0 / n, getattr(jnp, dtype)),
                                np.float64))
        assert tpr.mean_scale(n, getattr(torch, dtype)) == want, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n,iters", [(5, 1), (5, 3), (8, 1)])
@pytest.mark.parametrize("op", ["pl_reduce_scatter", "pl_allreduce"])
def test_scaled_carries_match_jax(op, n, iters, dtype, eight_devices):
    """The kernel's epilogue (sum, times 1/n in the dtype, rounded once;
    tiled for pl_reduce_scatter) against the JAX carries under the Pallas
    interpreter (the owned chunk times 1/n, then tiled or gathered), on
    seeded normal inputs.  Exact in every dtype (rtol 0): a product of two
    16-bit floats is exact in float32, so rounding it once to the dtype is
    what XLA's 16-bit multiply does, and the gather only moves values.  At
    n = 5, 1/n is not a power of two, so the scale does round."""
    chunk = 24
    itemsize = np.dtype(_np_dtype(dtype)).itemsize
    rng = np.random.default_rng(50 + n + iters)
    xg = (rng.standard_normal((n, n * chunk)) * 8).astype(_np_dtype(dtype))
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, n * chunk * itemsize, iters, dtype=dtype)
    jy = np.asarray(jax.device_get(jb.step(jax.device_put(
        xg.reshape(-1), jb.example_input.sharding)))).astype(np.float64)
    pb = build_op(op, SimWorld(n, CPU), n * chunk * itemsize, iters,
                  dtype=dtype)
    x = to_tensor(xg.astype(np.float64), dtype, CPU)
    assert x.shape == pb.example_input.shape
    got = from_world(pb.step(x)).astype(np.float64)
    np.testing.assert_allclose(got, jy, rtol=0, atol=0)
    if n == 5:
        # the scale is not a power of two: the carry really multiplied
        assert _dtype_inv(n, dtype) != 1 / n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", [2, 5, 8])
def test_tiled_reduce_scatter_ownership(n, dtype):
    # every tile of row c is chunk c's sum times the scale: exact small
    # integers, so a misrouted chunk or tile is an exact mismatch
    chunk = 3
    x = _ranks_input(n, n * chunk, seed=60 + n).to(getattr(torch, dtype))
    scale = _dtype_inv(n, dtype)
    out = tpr.direct_reduce_scatter(x, scale=scale, tiles=n)
    assert out.shape == (n, n * chunk) and out.dtype == x.dtype
    owned = x.float().view(n, n, chunk).sum(0).to(x.dtype) * scale
    for t in range(n):
        assert torch.equal(out[:, t * chunk:(t + 1) * chunk], owned), t
    assert torch.equal(tpr.direct_reduce_scatter(x, scale=scale), owned)


@pytest.mark.parametrize("tiles", [1, "n"])
@pytest.mark.parametrize("n", [2, 5, 8])
def test_unit_scale_keeps_the_ring_order_bits(n, tiles):
    # scale 1.0 is exact: on inputs where the order of addition decides the
    # sum, the output is the unscaled ring-order sum bit for bit, in every
    # tile
    chunk = 64
    xg = _order_sensitive(n, chunk, seed=30 + n)
    want = _ring_order_sum(xg.reshape(n, n, chunk))
    t = n if tiles == "n" else 1
    got = tpr.direct_reduce_scatter(torch.from_numpy(xg), scale=1.0,
                                    tiles=t).numpy()
    np.testing.assert_array_equal(got, np.tile(want, t))
    np.testing.assert_array_equal(
        tpr.direct_reduce_scatter(torch.from_numpy(xg)).numpy(), want)


@pytest.mark.parametrize("op", ["pl_reduce_scatter", "pl_allreduce"])
def test_carries_are_the_kernels_alone(op):
    # nothing runs after the kernels: the step is the scaled kernel (and the
    # gather), one plain call each per execution
    n, chunk = 5, 4
    built = build_op(op, SimWorld(n, CPU), n * chunk * 4, 2)
    x = built.example_input
    kernels.reset_counts()
    got = built.step(x)
    assert kernels.PLAIN_CALLS["direct_reduce_scatter"] == 2
    assert kernels.PLAIN_CALLS["direct_all_gather"] == (
        0 if op == "pl_reduce_scatter" else 2)
    inv = _dtype_inv(n, "float32")
    want = x
    for _ in range(2):
        red = tpr.direct_reduce_scatter(want, scale=inv,
                                        tiles=n if op == "pl_reduce_scatter" else 1)
        want = red if op == "pl_reduce_scatter" else tpr.direct_all_gather(red)
    assert torch.equal(got, want)


@pytest.mark.parametrize("src_full", [False, True])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_ring_all_gather_every_row_gathers_every_chunk(n, src_full):
    chunk = 3
    x = _ranks_input(n, n * chunk if src_full else chunk, seed=20 + n)
    own = x.view(n, n, chunk)[range(n), range(n)] if src_full else x
    out = tpr.direct_all_gather(x, src_full=src_full)
    assert torch.equal(out, own.reshape(1, -1).expand(n, -1))


def _jax_gather(host: np.ndarray, n: int, chunk: int,
                src_full: bool) -> np.ndarray:
    """The raw ring Pallas kernel ``_all_gather_kernel`` (no take-own-shard
    carry) under the TPU interpreter: every device's whole gathered buffer,
    ``(n, n*chunk)``.  ``host`` is ``(n, chunk)``, or ``(n, n*chunk)`` with
    ``src_full``."""
    mesh = make_mesh(devices=jax.devices()[:n])
    axis = mesh.axis_names[0]
    kern = jpr._all_gather_kernel(axis, n, chunk, src_full=src_full)
    sems = pltpu.SemaphoreType.DMA((max(n - 1, 1),))

    def call(x):
        return pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((chunk * n,), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[pltpu.SemaphoreType.DMA, sems, sems],
            compiler_params=pltpu.CompilerParams(
                collective_id=jpr._COLLECTIVE_IDS["pl_all_gather"]),
            interpret=pltpu.InterpretParams(),
        )(x)

    step = jax.jit(shard_map(call, mesh=mesh, in_specs=P(axis),
                             out_specs=P(axis), check_vma=False))
    x = jax.device_put(jnp.asarray(host.reshape(-1)),
                       NamedSharding(mesh, P(axis)))
    return np.asarray(jax.device_get(step(x))).reshape(n, n * chunk)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n,chunk", [(2, 2), (5, 6), (8, 4)])
@pytest.mark.parametrize("src_full", [False, True])
def test_direct_gather_plain_is_the_jax_ring_kernels_whole_buffer(
        src_full, n, chunk, dtype, eight_devices):
    # the ring forwards chunks without adding anything, so dropping its
    # order of forwarding changes no bit of the whole gathered buffer (the
    # take-own-shard carry would hide a chunk in the wrong slot)
    width = n * chunk if src_full else chunk
    host = ((np.arange(n * width) * 7 + 3) % 251).astype(dtype).reshape(
        n, width)
    want = _jax_gather(host, n, chunk, src_full)
    got = tpr.direct_all_gather_plain(torch.from_numpy(host.copy()), src_full)
    np.testing.assert_array_equal(got.numpy(), want)
    own = host.reshape(n, n, chunk)[range(n), range(n)] if src_full else host
    np.testing.assert_array_equal(want, np.broadcast_to(own.reshape(-1),
                                                        want.shape))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kernels.reset_counts()
    x = _ranks_input(4, 8, seed=0)
    tpr.direct_all_gather(tpr.direct_reduce_scatter(x))
    tpr.stream(x)
    tpr.hbm_write(tpr.hbm_read(tpr.hbm_copy(x)), 4)
    tpr.barrier(tpr.pingpong(tpr.pair_exchange(tpr.ring_shift(x)))[0])
    tpr.direct_all_gather_bidir(tpr.all_to_all(x))
    # the peer kernels, one rank's launch each, on CPU parts
    parts = list(x.view(4, 4, 2)[:, 0])
    tpr.peer_all_gather([tpr.peer_reduce_scatter(parts, 0)] * 4)
    tpr.peer_barrier([torch.zeros(4, dtype=torch.int32)] * 4,
                     torch.zeros(1, dtype=torch.int32), 0)
    for name in tpr.PEER_COPIES:
        tpr.peer_copy(name, parts[0])
    tpr.peer_all_to_all(parts)
    tpr.peer_all_gather_bidir(parts, 1)
    tpr.peer_barrier([torch.zeros(4, dtype=torch.int32)] * 4,
                     torch.zeros(1, dtype=torch.int32), 0, peers="ring",
                     copy=(parts[0], torch.empty(2)))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)
    assert kernels.PLAIN_CALLS == dict.fromkeys(kernels.KERNELS, 1)


@pytest.mark.parametrize("wrapper", [
    lambda x: tpr.direct_reduce_scatter(x),
    lambda x: tpr.direct_all_gather(x),
    lambda x: tpr.stream(x),
])
def test_wrappers_refuse_other_devices(wrapper):
    # only a CPU tensor takes the plain version; a non-CUDA device is an
    # error, never a quiet fallback
    with pytest.raises(ValueError):
        wrapper(torch.empty((4, 8), device="meta"))


def test_ring_reduce_scatter_rejects_ints_and_one_rank():
    with pytest.raises(ValueError, match="floats"):
        tpr.direct_reduce_scatter(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match=">= 2 ranks"):
        tpr.direct_reduce_scatter(torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="whole chunks"):
        tpr.direct_reduce_scatter(torch.zeros((2, 5)))


@pytest.mark.parametrize("tiles", [0, 2, 3, 5])
def test_reduce_scatter_tiles_is_one_or_n(tiles):
    with pytest.raises(ValueError, match="tiles is 1 or 4"):
        tpr.direct_reduce_scatter(torch.zeros((4, 8)), tiles=tiles)


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


@pytest.mark.parametrize("op", ["pl_all_gather_bidir", "pl_all_to_all"])
def test_unported_kernels_say_so(op):
    # the last two kernels to be ported now build and run: no op of the
    # JAX package's kernel list says "not yet ported" any more
    assert op in jpr.PALLAS_OPS and op in tpr.PALLAS_OPS
    built = build_op(op, SimWorld(8, CPU), 64, 1)
    x = built.example_input
    assert built.step(x).shape == x.shape
