"""The all-to-all's push, the pingpong's pushed legs and the pull's
order, in plain PyTorch, against the JAX package's raw Pallas kernels
(``_all_to_all_direct_kernel``, ``_pingpong_kernel``) under the TPU
interpreter on its eight virtual CPU devices.

These move bytes without arithmetic, so every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_perf.parallel import make_mesh as jax_make_mesh

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import kernels


def _jax_raw(kern, op: str, host: np.ndarray, n: int, scratch: list,
             outs: int) -> list[np.ndarray]:
    """The raw Pallas kernel ``kern`` of ``op`` under the TPU interpreter
    on n virtual devices, device d's input row ``host[d]``: each of its
    ``outs`` outputs, every device's, ``(n, len)``."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import tpu_perf.ops.pallas_ring as jpr
    from tpu_perf.compat import shard_map

    mesh = jax_make_mesh(devices=jax.devices()[:n])
    axis = mesh.axis_names[0]
    width = host.shape[1]
    shape = jax.ShapeDtypeStruct((width,), host.dtype)

    def call(x):
        got = pl.pallas_call(
            kern(axis),
            out_shape=[shape] * outs,
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * outs,
            scratch_shapes=scratch,
            compiler_params=pltpu.CompilerParams(
                collective_id=jpr._COLLECTIVE_IDS[op]),
            interpret=pltpu.InterpretParams(),
        )(x)
        return tuple(got)

    step = jax.jit(shard_map(call, mesh=mesh, in_specs=P(axis),
                             out_specs=(P(axis),) * outs, check_vma=False))
    x = jax.device_put(jnp.asarray(host.reshape(-1)),
                       NamedSharding(mesh, P(axis)))
    return [np.asarray(jax.device_get(o)).reshape(n, width) for o in step(x)]


def _host(n: int, width: int, dtype: str) -> np.ndarray:
    return ((np.arange(n * width) * 7 + 3) % 251).astype(dtype).reshape(
        n, width)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_the_all_to_all_push_order_staggers_its_destinations(n):
    # the push's destinations: each rank once, its own first; across the
    # ranks no two start their remote stores at the same rank
    firsts = []
    for rank in range(n):
        order = [s for _, _, s in tpr.push_order(n, rank)]
        assert sorted(order) == list(range(n))
        assert order[0] == rank
        assert order == [(rank + k) % n for k in range(n)]
        if n > 1:
            firsts.append(order[1])
    if n > 2:
        assert len(set(firsts)) == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_the_all_to_all_push_writes_only_its_slot(n, dtype):
    chunk = 5
    xs = [(torch.arange(n * chunk) * 3 + 11 * s).to(dtype) for s in range(n)]
    sentinel = torch.tensor(97).to(dtype)
    outs = [torch.full((n * chunk,), int(sentinel)).to(dtype)
            for _ in range(n)]
    kernels.reset_counts()
    for r in range(n):
        before = [o.clone() for o in outs]
        tpr.peer_all_to_all_push(xs[r], outs, r)
        for s, (o, b) in enumerate(zip(outs, before)):
            mine = slice(r * chunk, (r + 1) * chunk)
            assert torch.equal(o[mine], xs[r][s * chunk:(s + 1) * chunk])
            o_rest, b_rest = o.clone(), b.clone()
            o_rest[mine], b_rest[mine] = 0, 0
            assert torch.equal(o_rest, b_rest), "a store outside its slot"
    assert torch.equal(torch.stack(outs),
                       tpr.all_to_all_plain(torch.stack(xs)))
    assert kernels.PLAIN_CALLS["peer_all_to_all"] == n
    assert not any(kernels.LAUNCHES.values())


def test_the_all_to_all_push_refuses_what_it_cannot_store():
    outs = [torch.zeros(6) for _ in range(2)]
    with pytest.raises(ValueError, match="not 2 chunks"):
        tpr.peer_all_to_all_push(torch.ones(5), outs, 0)
    with pytest.raises(ValueError, match="into 2 outputs"):
        tpr.peer_all_to_all_push(torch.ones(4), outs, 0)
    with pytest.raises(ValueError, match="into 2 outputs"):
        tpr.peer_all_to_all_push(torch.ones(6, dtype=torch.int32), outs, 1)
    with pytest.raises(ValueError, match="rank 2 outside"):
        tpr.peer_all_to_all_push(torch.ones(6), outs, 2)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n,chunk", [(2, 2), (5, 6), (8, 4)])
def test_the_all_to_all_push_is_the_jax_kernels_whole_buffer(n, chunk, dtype,
                                                             eight_devices):
    # every rank stores chunk s of its input into slot d of rank s's
    # output, as the TPU kernel sends it: the whole outputs are the raw
    # kernel's
    from jax.experimental.pallas import tpu as pltpu

    import tpu_perf.ops.pallas_ring as jpr

    host = _host(n, n * chunk, dtype)
    sems = pltpu.SemaphoreType.DMA((n - 1,))
    want, = _jax_raw(lambda axis: jpr._all_to_all_direct_kernel(
        axis, n, chunk), "pl_all_to_all", host, n,
        [pltpu.SemaphoreType.DMA, sems, sems], 1)
    xs = torch.from_numpy(host.copy())
    outs = [torch.zeros(n * chunk, dtype=xs.dtype) for _ in range(n)]
    for r in range(n):
        tpr.peer_all_to_all_push(xs[r], outs, r)
    np.testing.assert_array_equal(torch.stack(outs).numpy(), want)


def _pushed_pingpong(xs: torch.Tensor) -> tuple[list, list]:
    """One pingpong execution over the rows of ``xs`` as the card's step
    runs it, each rank's copies through ``peer_copy`` (its plain version
    on the CPU): group 0 pushes its input into its partner's stage (leg
    1) while group 1 copies its own input into its output; then group 1
    pushes its stage into its partner's output (leg 2).  Returns every
    rank's output and stage."""
    n = xs.shape[0]
    half = n // 2
    outs = [torch.zeros_like(x) for x in xs]
    stages = [torch.zeros_like(x) for x in xs]
    for r in range(n):
        tpr.peer_copy("peer_pingpong", xs[r],
                      out=stages[r + half] if r < half else outs[r])
    for r in range(half, n):
        tpr.peer_copy("peer_pingpong", stages[r], out=outs[r - half])
    return outs, stages


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_pushed_pingpong_legs_are_the_jax_kernels(n, dtype,
                                                      eight_devices):
    # every rank's output, and group 1's stage (the payload in flight),
    # are the raw kernel's; group 0's stage the kernel never writes
    from jax.experimental.pallas import tpu as pltpu

    import tpu_perf.ops.pallas_ring as jpr

    host = _host(n, 6, dtype)
    want_out, want_stage = _jax_raw(
        lambda axis: jpr._pingpong_kernel(axis, n // 2), "pl_pingpong", host,
        n, [pltpu.SemaphoreType.DMA] * 5, 2)
    kernels.reset_counts()
    outs, stages = _pushed_pingpong(torch.from_numpy(host.copy()))
    np.testing.assert_array_equal(torch.stack(outs).numpy(), want_out)
    np.testing.assert_array_equal(torch.stack(stages[n // 2:]).numpy(),
                                  want_stage[n // 2:])
    assert kernels.PLAIN_CALLS["peer_pingpong"] == n + n // 2


class _Logged(list):
    """Parts that log the order their items are read in."""

    def __init__(self, items):
        super().__init__(items)
        self.read = []

    def __getitem__(self, s):
        if isinstance(s, int):
            self.read.append(s)
        return super().__getitem__(s)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_the_pull_reads_from_its_rank_on_and_stores_in_rank_order(n):
    for rank in range(n):
        assert tpr.pull_order(n, rank) == [(rank + k) % n for k in range(n)]
        for name, pull in (("peer_all_gather", tpr.peer_all_gather_plain),
                           ("peer_all_to_all", tpr.peer_all_to_all_plain)):
            parts = _Logged(torch.arange(4, dtype=torch.int32) + 10 * s
                            for s in range(n))
            kernels.reset_counts()
            got = pull(parts, rank)
            assert parts.read == tpr.pull_order(n, rank)
            assert torch.equal(got, torch.cat(list(parts)))
            assert kernels.PLAIN_CALLS[name] == 1


@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_pull_wrappers_take_the_rank_on_the_cpu(n):
    parts = [torch.arange(3, dtype=torch.float32) + 10 * s for s in range(n)]
    out = torch.empty(3 * n)
    for rank in range(n):
        assert torch.equal(tpr.peer_all_to_all(parts, rank, out=out),
                           torch.cat(parts))
        assert torch.equal(tpr.peer_all_gather(parts, rank), torch.cat(parts))
    with pytest.raises(ValueError, match=f"rank {n} outside"):
        tpr.peer_all_gather(parts, n)
