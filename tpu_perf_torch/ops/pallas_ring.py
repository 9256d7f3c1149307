"""The hand-scheduled ring ops (port of ``tpu_perf/ops/pallas_ring.py``).

On the TPU each ``pl_*`` op is a Pallas kernel that drives the
interconnect with remote DMA.  Here the sim world
(:mod:`tpu_perf_torch.world`) stands in for the ranks, and each kernel
is written by hand for Hopper:

* ``ring_reduce_scatter`` — CUDA C++, ``csrc/ring_reduce_scatter.cu``
  (replaces ``_reduce_scatter_kernel`` with ``_acc_add`` and
  ``_ring_barrier``);
* ``ring_all_gather`` — CUDA C++, ``csrc/ring_all_gather.cu`` (replaces
  ``_all_gather_kernel``, both modes);
* ``stream`` — Triton, :mod:`tpu_perf_torch.ops.stream_triton` (replaces
  ``_hbm_stream_vec_kernel``).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version, the same ring schedule step by step over the sim ranks,
for a CPU tensor; anything else raises.  The sizes, carries and op names
are the JAX package's, so rows land on the same curve keys.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_perf_torch import kernels
from tpu_perf_torch.kernels import _build
from tpu_perf_torch.ops.stream_triton import stream
from tpu_perf_torch.world import SimWorld

PALLAS_OPS = (
    "pl_ring", "pl_exchange", "pl_all_gather", "pl_reduce_scatter",
    "pl_allreduce", "pl_pingpong", "pl_all_gather_bidir", "pl_hbm_copy",
    "pl_hbm_stream", "pl_hbm_read", "pl_hbm_write", "pl_barrier",
    "pl_all_to_all",
)
#: the pl_* ops this package runs; the others raise NotImplementedError
PORTED_OPS = ("pl_all_gather", "pl_reduce_scatter", "pl_allreduce",
              "pl_hbm_stream")

#: the JAX package's chunk-rounding tile (its VMEM accumulation tile):
#: reduce-scatter chunks above it round up to a multiple of it.  It decides
#: ``nbytes`` on the curve keys, so it stays the JAX value; the CUDA
#: kernels' own tile is a separate constant in their sources.
_ACC_TILE_ELEMS = 65536
#: the JAX package's stream tile, kept only for hbm_dma_block_elems
_STREAM_TILE_ELEMS = 524288

_RS_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def hbm_dma_block_elems(itemsize: int, elems: int) -> int:
    """The JAX package's DMA block (elements) for its single-sided memory
    instruments and its stream tile: the stream-tile byte budget scaled by
    itemsize, capped by the buffer."""
    return min(max(1, _STREAM_TILE_ELEMS * itemsize // 4), elems)


def _stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, kernel needs cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")


# --- ring reduce-scatter ------------------------------------------------


def ring_reduce_scatter_plain(x: torch.Tensor, out: torch.Tensor,
                              stage: torch.Tensor) -> None:
    """The kernel's schedule in plain PyTorch: for each ring step, every
    rank d copies its left neighbour's partial of chunk r = (d-2-k) mod n
    into staging row k and adds it into its own chunk r.  ``out`` and
    ``stage`` are written in place."""
    kernels.PLAIN_CALLS["ring_reduce_scatter"] += 1
    n = x.shape[0]
    chunk = x.shape[1] // n
    xc, oc = x.view(n, n, chunk), out.view(n, n, chunk)
    d = torch.arange(n, device=x.device)
    left = (d - 1) % n
    for step in range(n - 1):
        r = (d + 2 * n - 2 - step) % n
        partial = (xc if step == 0 else oc)[left, r]
        stage[:, step] = partial
        oc[d, r] = xc[d, r] + partial
        if step == 0:
            oc[d, left] = xc[d, left]  # own chunk, forwarded unreduced


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """Ring reduce-scatter over the sim ranks: ``x`` is ``(n, n*chunk)``;
    returns ``out`` of the same shape, where rank d's chunk d is the sum
    over ranks of chunk d (the other chunks hold the partials the ring
    left there, as on the TPU).  One kernel launch per ring step."""
    n, row = x.shape
    if n < 2 or row % n:
        raise ValueError(
            f"ring_reduce_scatter needs >= 2 ranks and whole chunks, got {tuple(x.shape)}")
    if x.dtype not in _RS_DTYPE_CODES:
        raise ValueError(f"ring_reduce_scatter reduces floats, got {x.dtype}")
    chunk = row // n
    out = torch.empty_like(x)
    stage = x.new_empty((n, n - 1, chunk))
    if x.device.type == "cpu":
        ring_reduce_scatter_plain(x, out, stage)
        return out
    _check_cuda("ring_reduce_scatter", x)
    fn = _build.entry("ring_reduce_scatter")
    stream_ptr = _stream_of(x)
    for step in range(n - 1):
        err = fn(x.data_ptr(), out.data_ptr(), stage.data_ptr(), n, chunk,
                 step, _RS_DTYPE_CODES[x.dtype], stream_ptr)
        _build.check("ring_reduce_scatter", err)
        kernels.LAUNCHES["ring_reduce_scatter"] += 1
    return out


# --- ring all-gather ----------------------------------------------------


def ring_all_gather_plain(x: torch.Tensor, out: torch.Tensor,
                          src_full: bool = False) -> None:
    """The kernel's schedule in plain PyTorch: at ring step k every rank d
    stores the chunk (d-1-k) mod n its left neighbour forwards; step 0
    also places the rank's own chunk.  ``out`` is written in place."""
    kernels.PLAIN_CALLS["ring_all_gather"] += 1
    n = x.shape[0]
    chunk = out.shape[1] // n
    oc = out.view(n, n, chunk)
    d = torch.arange(n, device=x.device)
    left = (d - 1) % n
    own = x.view(n, n, chunk)[d, d] if src_full else x
    for step in range(max(1, n - 1)):
        c = (left - step) % n
        oc[d, c] = own[left] if step == 0 else oc[left, c]
        if step == 0:
            oc[d, d] = own


def ring_all_gather(x: torch.Tensor, *, src_full: bool = False) -> torch.Tensor:
    """Ring all-gather over the sim ranks.  ``x`` is ``(n, chunk)`` (each
    rank's own chunk) or, with ``src_full``, ``(n, n*chunk)`` whose chunk d
    of row d is rank d's own; returns ``(n, n*chunk)`` with every row the
    gathered chunks.  One kernel launch per ring step (one when n = 1)."""
    n, row = x.shape
    if src_full and row % n:
        raise ValueError(f"src_full needs whole chunks, got {tuple(x.shape)}")
    chunk = row // n if src_full else row
    out = x.new_empty((n, n * chunk))
    if x.device.type == "cpu":
        ring_all_gather_plain(x, out, src_full)
        return out
    _check_cuda("ring_all_gather", x)
    fn = _build.entry("ring_all_gather")
    isz = x.element_size()
    src_row = row * isz
    src_own = chunk * isz if src_full else 0
    stream_ptr = _stream_of(x)
    for step in range(max(1, n - 1)):
        err = fn(x.data_ptr(), out.data_ptr(), n, chunk * isz, src_row,
                 src_own, step, stream_ptr)
        _build.check("ring_all_gather", err)
        kernels.LAUNCHES["ring_all_gather"] += 1
    return out


# --- the pl_* ops -------------------------------------------------------


def build_pallas_step(op: str, world: SimWorld, nbytes: int, iters: int, *,
                      dtype: str = "float32") -> tuple[Callable, int, int]:
    """The step executing ``iters`` chained kernel executions for ``op``.

    Returns ``(step, elems_per_rank, actual_nbytes)``; the caller
    (ops.build_op) makes the example input and wraps it into a BuiltOp.
    """
    from tpu_perf_torch.ops.collectives import DTYPES, chained

    if op not in PALLAS_OPS:
        raise ValueError(f"unknown pallas op {op!r}; known: {PALLAS_OPS}")
    if op not in PORTED_OPS:
        raise NotImplementedError(f"{op} is not yet ported; see ROADMAP")
    n = world.n
    tdtype = DTYPES[dtype]
    itemsize = tdtype.itemsize
    if op == "pl_all_gather":
        # nbytes = gathered total; per-rank shard = nbytes/n
        chunk = max(1, -(-nbytes // (itemsize * n)))
        elems = chunk
        actual = chunk * n * itemsize
    elif op in ("pl_reduce_scatter", "pl_allreduce"):
        if n < 2:
            raise ValueError(f"{op} needs at least 2 devices, got {n}")
        # nbytes = per-rank input buffer; chunk = elems/n, rounded up to a
        # whole number of the JAX package's accumulation tiles
        raw_chunk = max(1, -(-max(1, -(-nbytes // itemsize)) // n))
        if raw_chunk > _ACC_TILE_ELEMS:
            chunk = -(-raw_chunk // _ACC_TILE_ELEMS) * _ACC_TILE_ELEMS
        else:
            chunk = raw_chunk
        elems = chunk * n
        actual = elems * itemsize
    else:  # pl_hbm_stream: exactly the hbm_stream rounding
        elems = chunk = max(1, -(-nbytes // itemsize))
        actual = elems * itemsize

    d = torch.arange(n, device=world.device)

    def own_chunks(t):
        # row d's chunk d, as (n, chunk): the take-own-shard slice
        return t.view(n, n, chunk)[d, d]

    if op == "pl_all_gather":
        # gather, then take the own shard back out (the JAX carry)
        return chained(lambda x: own_chunks(ring_all_gather(x)), iters), \
            elems, actual
    if op == "pl_hbm_stream":
        return chained(stream, iters), elems, actual
    inv = torch.tensor(1.0 / n, dtype=tdtype, device=world.device)
    if op == "pl_reduce_scatter":
        # own reduced chunk * 1/n, tiled over the whole buffer
        def rs_carry(x):
            return (own_chunks(ring_reduce_scatter(x)) * inv).repeat(1, n)

        return chained(rs_carry, iters), elems, actual

    def allreduce_carry(x):
        # reduce-scatter phase, all-gather phase, * 1/n — the scale is done
        # in place on the gathered buffer, which saves one buffer the size
        # of the payload
        return ring_all_gather(ring_reduce_scatter(x), src_full=True).mul_(inv)

    return chained(allreduce_carry, iters), elems, actual
