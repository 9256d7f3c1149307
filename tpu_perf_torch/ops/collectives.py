"""Measurement ops: sizing, input fill, and the library-call bodies
(port of ``tpu_perf/ops/collectives.py``).

Every op runs ``iters`` executions chained on the carry: each
iteration's output is the next one's input, so no execution can be
skipped or overlapped away, and values stay bounded (the reductions carry
the mean, not the sum).  The ops of this slice:

* ``allreduce`` — the library reduction, as XLA's ``psum`` is a library
  collective there: in the sim world, ``torch.sum`` over the ranks times
  1/n, broadcast back to every rank;
* ``hbm_stream`` — the local memory baseline, ``x * 1.0000001 + 1e-7``
  (``x + 1`` for integers) as plain PyTorch operations;
* the ``pl_*`` ops — the hand-written kernels, built by
  :func:`tpu_perf_torch.ops.pallas_ring.build_pallas_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpu_perf_torch.config import SUPPORTED_DTYPES
from tpu_perf_torch.ops import stream_triton
from tpu_perf_torch.world import SimWorld

DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int32": torch.int32, "uint8": torch.uint8,
}
if set(DTYPES) != set(SUPPORTED_DTYPES):
    raise RuntimeError("DTYPES and config.SUPPORTED_DTYPES drifted apart")

#: elements per float64 staging piece of example_input (512 MiB)
_FILL_PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class BuiltOp:
    """A measurement step plus its sim-world example input."""

    name: str
    step: Callable[[torch.Tensor], torch.Tensor]  # runs `iters` chained ops
    example_input: torch.Tensor  # (n_devices, elems) on the world's device
    nbytes: int  # actual message size in bytes (after rounding)
    n_devices: int
    iters: int


def payload_elems(op: str, nbytes: int, n: int, itemsize: int) -> tuple[int, int]:
    """Per-device element count for ``op`` at message size ``nbytes``.

    Returns ``(elems_per_device, actual_nbytes)``, rounded exactly as the
    JAX package rounds (nccl-tests size semantics): ``all_gather``'s
    ``nbytes`` is the gathered total, ``reduce_scatter``/``all_to_all``'s
    the per-device input, everything else the per-device buffer."""
    if op == "barrier":
        return 1, itemsize
    elems = max(1, -(-nbytes // itemsize))
    if op == "all_gather":
        shard = max(1, -(-elems // n))
        return shard, shard * n * itemsize
    if op in ("reduce_scatter", "all_to_all", "hier_allreduce"):
        elems = -(-elems // n) * n
        return elems, elems * itemsize
    if op in ("halo", "hbm_triad"):
        elems = max(2, elems + (elems % 2))
        return elems, elems * itemsize
    return elems, elems * itemsize


#: ops that reduce (scale by 1/n) — integer payloads would measure another
#: computation (the JAX package's list, restricted to this slice's ops)
FLOAT_ONLY_OPS = ("allreduce", "pl_allreduce", "pl_reduce_scatter")


def is_float_dtype(dtype: str) -> bool:
    """The one predicate deciding float-vs-integer op behaviour."""
    return DTYPES[dtype].is_floating_point


def make_fill(total: int, dtype: str) -> np.ndarray:
    """Deterministic example-input fill, the JAX package's exactly.
    Floats get a [1, 2) ramp; integers keep the raw 0..250 ramp."""
    host = (np.arange(total) % 251).astype(np.float64)
    if is_float_dtype(dtype):
        host = host / 251.0 + 1.0
    return host


def to_tensor(host: np.ndarray, dtype: str, device) -> torch.Tensor:
    """Cast a float64 host array to ``dtype`` the way ``jnp.asarray(host,
    dtype)`` does: through float32 for the 16-bit floats, round to nearest
    even at each step."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if DTYPES[dtype] in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)
    return t.to(DTYPES[dtype]).to(device)


def example_input(world: SimWorld, elems: int, dtype: str) -> torch.Tensor:
    """The make_fill input in sim-world rows: global ``(n*elems,)`` ->
    ``(n, elems)``, rank r on row r.  Computed on the world's device with
    make_fill's float64 arithmetic (each step correctly rounded, so the
    values are make_fill's bit for bit) and cast as :func:`to_tensor`
    casts: a gigabyte buffer is not filled element by element on the
    host.  The float64 staging goes in pieces of _FILL_PIECE elements."""
    total = world.n * elems
    out = torch.empty(total, dtype=DTYPES[dtype], device=world.device)
    for lo in range(0, total, _FILL_PIECE):
        hi = min(total, lo + _FILL_PIECE)
        fill = torch.arange(lo, hi, dtype=torch.float64,
                            device=world.device).remainder_(251)
        if is_float_dtype(dtype):
            fill = fill.div_(251.0).add_(1.0)
        if DTYPES[dtype] in (torch.bfloat16, torch.float16):
            fill = fill.to(torch.float32)
        out[lo:hi] = fill
    return out.view(world.n, elems)


# Op bodies: (world, dtype) -> body.  Constants are made on the device
# once, at build time: a tensor made from a Python scalar inside the body
# would copy host to device on every execution.


def _allreduce(world: SimWorld, dtype: torch.dtype) -> Callable:
    inv = torch.tensor(1.0 / world.n, dtype=dtype, device=world.device)

    def body(x):
        return (x.sum(dim=0, keepdim=True) * inv).expand_as(x).contiguous()

    return body


def _hbm_stream(world: SimWorld, dtype: torch.dtype) -> Callable:
    # the library form of the stream body: plain PyTorch operations with
    # the constants rounded to the dtype (stream_triton.stream_constants)
    if not dtype.is_floating_point:
        return lambda x: x + 1
    scale, shift = (c.to(world.device)
                    for c in stream_triton.stream_constants(dtype))

    def body(x):
        return x * scale + shift

    return body


OP_BUILDERS: dict[str, Callable] = {
    "allreduce": _allreduce,
    "hbm_stream": _hbm_stream,
}


def chained(call: Callable, iters: int) -> Callable:
    """``iters`` executions of ``call``, each fed the previous output."""
    def step(x):
        for _ in range(iters):
            x = call(x)
        return x

    return step


def known_ops() -> list[str]:
    from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS

    return sorted(OP_BUILDERS) + list(PALLAS_OPS)


def build_op(op: str, world: SimWorld, nbytes: int, iters: int, *,
             dtype: str = "float32",
             reuse_input: torch.Tensor | None = None) -> BuiltOp:
    """Build the measurement step for ``op`` at message size ``nbytes``.

    ``reuse_input`` adopts an existing example buffer (the slope and trace
    fences build one op at two trip counts; the fill is identical, so one
    buffer serves both)."""
    from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS, build_pallas_step

    if op not in OP_BUILDERS and op not in PALLAS_OPS:
        raise ValueError(f"unknown op {op!r}; known: {known_ops()}")
    if iters <= 0:
        raise ValueError(f"iters must be positive, got {iters}")
    if dtype not in DTYPES:
        raise ValueError(
            f"unsupported dtype {dtype!r}; supported: {SUPPORTED_DTYPES}")
    if op in FLOAT_ONLY_OPS and not is_float_dtype(dtype):
        raise ValueError(
            f"{op} reduces/multiplies its payload and needs a float dtype, "
            f"got {dtype} (byte-movement ops accept any dtype)"
        )
    if op in PALLAS_OPS:
        step, elems, actual = build_pallas_step(op, world, nbytes, iters,
                                                dtype=dtype)
    else:
        itemsize = DTYPES[dtype].itemsize
        elems, actual = payload_elems(op, nbytes, world.n, itemsize)
        step = chained(OP_BUILDERS[op](world, DTYPES[dtype]), iters)
    if reuse_input is not None:
        want = (world.n, elems)
        if (tuple(reuse_input.shape) != want
                or reuse_input.dtype != DTYPES[dtype]
                or reuse_input.device != world.device):
            raise ValueError(
                f"reuse_input spec mismatch: have {tuple(reuse_input.shape)}/"
                f"{reuse_input.dtype}/{reuse_input.device}, need {want}/"
                f"{DTYPES[dtype]}/{world.device}")
        x = reuse_input
    else:
        x = example_input(world, elems, dtype)
    return BuiltOp(name=op, step=step, example_input=x, nbytes=actual,
                   n_devices=world.n, iters=iters)
