"""Measurement ops: sizing, input fill, and the library-call bodies
(port of ``tpu_perf/ops/collectives.py``).

Every op runs ``iters`` executions chained on the carry: each
iteration's output is the next one's input, so no execution can be
skipped or overlapped away, and values stay bounded (the reductions carry
the mean, not the sum).  The ops of this slice:

* ``allreduce`` — the library reduction, as XLA's ``psum`` is a library
  collective there: in the sim world, ``torch.sum`` over the ranks times
  1/n, broadcast back to every rank; ``barrier`` is the same body on one
  element;
* the collectives ``all_gather``, ``reduce_scatter``, ``all_to_all``,
  ``broadcast`` (the binomial tree from rank 0) and ``broadcast_psum``
  (the masked sum from rank 0) — XLA's collectives as PyTorch operations
  on the rows (see their bodies);
* the point-to-point ops ``pingpong``, ``pingpong_unidir``, ``exchange``
  (alias ``ppermute``), ``ring`` and ``halo`` — XLA's ``ppermute`` as
  PyTorch indexing on the ``(n, elems)`` rows: row d of the result is the
  row its source rank sent, and a rank no one sends to gets zeros, as
  ``ppermute`` zero-fills it;
* ``hbm_stream`` — the local memory baseline, ``x * 1.0000001 + 1e-7``
  (``x + 1`` for integers) as plain PyTorch operations;
* ``hbm_read``, ``hbm_write``, ``hbm_triad`` — the read, write and 2R:1W
  memory instruments, as plain PyTorch operations that update the carry
  in place (see their bodies);
* ``mxu_gemm`` — the compute roofline: each rank's m x m carry times a
  fixed orthogonal matrix, wrap-added, one ``addmm`` an iteration;
  ``overlap_ring`` — a ring shift of a payload and the same product in one
  iteration, the shift on a side stream so it can run under the product;
* ``hier_allreduce`` — the two-level all-reduce of a ``(dcn, ici)``
  mesh: a reduce-scatter over ``ici``, an all-reduce over ``dcn``, an
  all-gather over ``ici``, times 1/n;
* the ``pl_*`` ops — the hand-written kernels, built by
  :func:`tpu_perf_torch.ops.pallas_ring.build_pallas_step`.

In a multi-process world (:class:`tpu_perf_torch.world.DistWorld`) each
rank holds its own ``(elems,)`` buffer and the library ops are
``torch.distributed`` calls on it (NCCL on the card, gloo on the CPU),
with the same sizes and carries: the collectives on ``dist.*``, the
point-to-point ops as ``batch_isend_irecv`` of XLA's ``ppermute``
permutations.  A rank never sends to itself: its own pair is a local
copy, so a world of one does what the JAX op does on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from tpu_perf_torch.config import SUPPORTED_DTYPES
from tpu_perf_torch.ops import stream_triton
from tpu_perf_torch.topology import (
    one_way_permutation, pair_permutation, ring_permutation,
)
from tpu_perf_torch.world import DistWorld, SimWorld, is_dist

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
    example_input: torch.Tensor  # (n_devices, elems) on the world's device;
                                 # windowed (n_devices, W, elems); in a
                                 # DistWorld this rank's (elems,) or
                                 # (W, elems)
    nbytes: int  # actual message size in bytes (after rounding)
    n_devices: int
    iters: int  # messages a step moves: executions * window


# mxu_gemm's matrix side: multiples of 128, capped at 4096 (the JAX
# package's bounds, so both packages build the same matrix for a size);
# overlap_ring keeps its own smaller cap, so its compute block stays
# comparable across sizes
_GEMM_MIN_M, _GEMM_MAX_M = 128, 4096
_OVERLAP_MAX_M = 2048


def _gemm_m(elems: int, max_m: int | None = None) -> int:
    """Matrix side for a compute block scaled to ``elems`` buffer elements;
    ``max_m`` None reads the module cap at call time."""
    m = int(round(math.sqrt(max(1, elems)) / 128)) * 128
    return max(_GEMM_MIN_M, min(_GEMM_MAX_M if max_m is None else max_m, m))


def _overlap_split(total: int) -> tuple[int, int]:
    """Invert payload_elems's overlap_ring sizing: per-rank ``total`` ->
    (ring_elems, m); the largest matching m is unique."""
    for m in range(_OVERLAP_MAX_M, _GEMM_MIN_M - 1, -128):
        r = total - m * m
        if r >= 1 and _gemm_m(r, _OVERLAP_MAX_M) == m:
            return r, m
    raise ValueError(f"not an overlap_ring payload size: {total}")


def _ortho(m: int, _cache={}) -> np.ndarray:
    """Deterministic m x m orthogonal matrix (float64): iterated ``x @ q``
    keeps the norm, so long chains stay bounded."""
    if m not in _cache:
        rng = np.random.default_rng(7)
        q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        _cache[m] = q
    return _cache[m]


def payload_elems(op: str, nbytes: int, n: int, itemsize: int) -> tuple[int, int]:
    """Per-device element count for ``op`` at message size ``nbytes``.

    Returns ``(elems_per_device, actual_nbytes)``, rounded exactly as the
    JAX package rounds (nccl-tests size semantics): ``all_gather``'s
    ``nbytes`` is the gathered total, ``reduce_scatter``/``all_to_all``'s
    the per-device input, ``mxu_gemm``'s the m x m operand (m from the
    size), ``overlap_ring``'s the ring payload (the m x m block rides
    beside it), everything else the per-device buffer."""
    if op == "barrier":
        return 1, itemsize
    elems = max(1, -(-nbytes // itemsize))
    if op == "mxu_gemm":
        m = _gemm_m(elems)
        return m * m, m * m * itemsize
    if op == "overlap_ring":
        m = _gemm_m(elems, _OVERLAP_MAX_M)
        return elems + m * m, elems * itemsize
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


#: ops that reduce (scale by 1/n, or take a mean) — integer payloads would
#: measure another computation (the JAX package's list, restricted to the
#: ported ops)
FLOAT_ONLY_OPS = ("allreduce", "barrier", "hier_allreduce", "reduce_scatter",
                  "mxu_gemm", "overlap_ring", "hbm_read", "pl_allreduce",
                  "pl_reduce_scatter")
#: the point-to-point ops whose pair permutation needs an even rank count
#: (ring and halo shift by one, valid for any n)
_NEEDS_EVEN = ("pingpong", "pingpong_unidir", "exchange", "ppermute")
#: the ops built on ppermute: they run over one mesh axis
_PAIRWISE = ("pingpong", "pingpong_unidir", "exchange", "ppermute", "halo",
             "ring", "broadcast", "overlap_ring")
#: the ops whose function is the same on every rank's own buffer, whatever
#: the world: a multi-process world runs their one-rank bodies
_LOCAL_OPS = ("hbm_stream", "hbm_read", "hbm_write", "hbm_triad",
              "mxu_gemm")


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


def _fill(out: torch.Tensor, start: int, dtype: str) -> None:
    """Write make_fill's elements ``[start, start + out.numel())`` into the
    flat ``out``, in float64 pieces of _FILL_PIECE elements."""
    total = out.numel()
    for lo in range(0, total, _FILL_PIECE):
        hi = min(total, lo + _FILL_PIECE)
        fill = torch.arange(start + lo, start + hi, dtype=torch.float64,
                            device=out.device).remainder_(251)
        if is_float_dtype(dtype):
            fill = fill.div_(251.0).add_(1.0)
        if DTYPES[dtype] in (torch.bfloat16, torch.float16):
            fill = fill.to(torch.float32)
        out[lo:hi] = fill


def example_input(world: SimWorld | DistWorld, elems: int, dtype: str, *,
                  window: int = 1) -> torch.Tensor:
    """The make_fill input in sim-world rows: global ``(n*elems,)`` ->
    ``(n, elems)``, rank r on row r; windowed, the fill of the global
    ``(W, n*elems)`` in the sim world's ``(n, W, elems)``
    (:func:`tpu_perf_torch.world.to_world`).  In a multi-process world,
    this rank's part of the same global fill: ``(elems,)``, or its ``(W,
    elems)`` columns (:func:`tpu_perf_torch.world.to_rank`).  Computed on
    the world's device with make_fill's float64 arithmetic (each step
    correctly rounded, so the values are make_fill's bit for bit) and cast
    as :func:`to_tensor` casts: a gigabyte buffer is not filled element by
    element on the host."""
    if is_dist(world):
        out = torch.empty(window, elems, dtype=DTYPES[dtype],
                          device=world.device)
        for w in range(window):
            _fill(out[w], (w * world.n + world.rank) * elems, dtype)
        return out if window > 1 else out.view(elems)
    out = torch.empty(window * world.n * elems, dtype=DTYPES[dtype],
                      device=world.device)
    _fill(out, 0, dtype)
    if window > 1:
        return out.view(window, world.n, elems).transpose(0, 1).contiguous()
    return out.view(world.n, elems)


# Op bodies: (world, dtype) -> body.  Constants are made on the device
# once, at build time: a tensor made from a Python scalar inside the body
# would copy host to device on every execution.


def _allreduce(world: SimWorld, dtype: torch.dtype) -> Callable:
    inv = torch.tensor(1.0 / world.n, dtype=dtype, device=world.device)

    def body(x):
        return (x.sum(dim=0, keepdim=True) * inv).expand_as(x).contiguous()

    return body


def _all_gather(world: SimWorld, dtype: torch.dtype) -> Callable:
    # gather every rank's shard into every row (a real copy: the result is
    # the identity, so the gather must not be elided), then take the own
    # shard back out, the JAX carry
    n = world.n
    d = torch.arange(n, device=world.device)

    def body(x):
        g = x.reshape(1, -1).expand(n, -1).contiguous()
        return g.view(n, n, -1)[d, d]

    return body


def _reduce_scatter(world: SimWorld, dtype: torch.dtype) -> Callable:
    # row d's chunk d <- (sum over ranks of chunk d) * 1/n, in the dtype,
    # updated in place on the carry as XLA's dynamic_update_slice does; the
    # other chunks stay as they are
    n = world.n
    inv = torch.tensor(1.0 / n, dtype=dtype, device=world.device)

    def body(x):
        chunks = x.view(n, n, -1)
        chunks.diagonal(0, 0, 1).copy_((chunks.sum(0) * inv).T)
        return x

    return body


def _all_to_all(world: SimWorld, dtype: torch.dtype) -> Callable:
    # the chunk transpose: out[d][s] = x[s][d]
    n = world.n

    def body(x):
        return x.view(n, n, -1).transpose(0, 1).contiguous().view(n, -1)

    return body


def _broadcast(world: SimWorld, dtype: torch.dtype) -> Callable:
    # the binomial tree from rank 0 (tpu_perf's _perms_for): round k copies
    # rows [0, hi - lo) to [lo, hi), lo = 2**k, in place, one slice copy a
    # round: ceil(log2 n) rounds and n - 1 row copies in all
    rounds = []
    lo = 1
    while lo < world.n:
        hi = min(2 * lo, world.n)
        rounds.append((lo, hi))
        lo = hi

    def body(x):
        for lo, hi in rounds:
            x[lo:hi] = x[:hi - lo]
        return x

    return body


def _broadcast_psum(world: SimWorld, dtype: torch.dtype) -> Callable:
    # rank 0's row, zeros elsewhere, summed over the ranks and broadcast
    # back: exact in any dtype (one nonzero term)
    root = (torch.arange(world.n, device=world.device) == 0)[:, None]
    zero = torch.zeros((), dtype=dtype, device=world.device)

    def body(x):
        masked = torch.where(root, x, zero)
        return masked.sum(0, keepdim=True, dtype=dtype).expand_as(x).contiguous()

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


# The three instruments below update the carry in place where the JAX
# bodies rebuild it functionally: a clone per execution would add a full
# copy to what the instrument times (the failure the JAX package recorded
# for hbm_triad's first formulation on the TPU).  Each keeps the JAX
# function's roundings: the constants are rounded to the dtype first and
# every operation rounds to the dtype.


def _hbm_read(world: SimWorld, dtype: torch.dtype) -> Callable:
    # slot 0 of each rank <- mean(max(row, row[0])), accumulated in float32
    # and rounded once to the dtype.  Eager PyTorch makes two passes: the
    # maximum writes a temporary the size of the buffer, the mean reads it.
    def body(x):
        s = torch.maximum(x, x[:, :1]).mean(dim=1, keepdim=True,
                                            dtype=torch.float32)
        x[:, :1] = s
        return x

    return body


def _hbm_write(world: SimWorld, dtype: torch.dtype) -> Callable:
    # every row <- f(row[0]): one copy from the (n, 1) values broadcast over
    # the buffer, which is what fill_ with a device tensor does; it writes
    # the buffer once and reads n elements
    if not dtype.is_floating_point:
        def body(x):
            return x.copy_((x[:, :1] + 1).expand_as(x))

        return body
    scale, shift = (c.to(world.device)
                    for c in stream_triton.stream_constants(dtype))

    def body(x):
        return x.copy_((x[:, :1] * scale + shift).expand_as(x))

    return body


def _hbm_triad(world: SimWorld, dtype: torch.dtype) -> Callable:
    # first half a <- a * 1.0000001 + b * 1e-7 (a + b for integers) through
    # two views of the halves; the second half b is read, never written.
    # Eager: b * 1e-7 reads b and writes a temporary, a *= k1 reads and
    # writes a, a += tmp reads both and writes a.
    if not dtype.is_floating_point:
        def body(x):
            h = x.shape[1] // 2
            x[:, :h].add_(x[:, h:])
            return x

        return body
    scale, shift = (c.to(world.device)
                    for c in stream_triton.stream_constants(dtype))

    def body(x):
        h = x.shape[1] // 2
        bk = x[:, h:] * shift
        x[:, :h].mul_(scale).add_(bk)
        return x

    return body


def _hier_allreduce(world: SimWorld, dtype: torch.dtype) -> Callable:
    # the (dcn, ici) mesh's schedule as row ops on (dcn, ici, elems): rank
    # (d, i)'s row is the sum over its ici group of chunk i (the
    # reduce-scatter), summed over dcn (the all-reduce), gathered back over
    # ici and scaled by 1/n; each sum rounds to the dtype as a collective
    # does
    dcn, ici = world.mesh.shape
    n = world.n
    inv = torch.tensor(1.0 / n, dtype=dtype, device=world.device)

    def body(x):
        chunks = x.view(dcn, ici, ici, -1)
        owned = chunks.sum(1, dtype=dtype).sum(0, dtype=dtype)  # (ici, c)
        return (owned.reshape(1, -1) * inv).expand(n, -1).contiguous()

    return body


# The point-to-point bodies: XLA's ppermute over the rows.  ``shift_rows``
# is the ring permutation i -> i + k; the pair ops split the ranks into
# group 0 (rows [0, n/2)) and group 1 (rows [n/2, n)), rank i paired with
# i + n/2 (tpu_perf/topology.py pair_permutation).


def shift_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """``out[d] = x[(d - k) mod n]``: every rank sends its row to rank
    d + k, in two slice copies."""
    n = x.shape[0]
    k %= n
    out = torch.empty_like(x)
    out[k:] = x[:n - k]
    out[:k] = x[n - k:]
    return out


def _one_way(x: torch.Tensor, *, back: bool = False) -> torch.Tensor:
    # group 0 -> group 1 (or back), the unidirectional half of the pair
    # permutation; the ranks no one sends to get zeros
    half = x.shape[0] // 2
    src, dst = (slice(half, None), slice(None, half)) if back else \
        (slice(None, half), slice(half, None))
    out = torch.empty_like(x)
    out[dst] = x[src]
    out[src] = 0
    return out


def _pingpong(world: SimWorld, dtype: torch.dtype) -> Callable:
    # payload there and back: group 0 gets its payload back, group 1 ends
    # with zeros (it is no target of the return leg)
    def body(x):
        return _one_way(_one_way(x), back=True)

    return body


def _pingpong_unidir(world: SimWorld, dtype: torch.dtype) -> Callable:
    # the payload goes one way; its first element comes back as the
    # 1-element ack into slot 0 (mpi_perf.c:137,142).  Slot 0 is updated in
    # place on the carry, as XLA updates the loop carry: group 0 gets its
    # own first element back, group 1's slot 0 gets zero
    def body(x):
        ack = _one_way(x)[:, :1]
        x[:, :1] = _one_way(ack, back=True)
        return x

    return body


def _exchange(world: SimWorld, dtype: torch.dtype) -> Callable:
    # both directions of the pair permutation at once
    # (tpu_perf_torch.topology.pair_permutation); on the windowed
    # (n, W, elems) rows one shift moves every buffer of the window
    half = world.n // 2
    return lambda x: shift_rows(x, half)


def _ring(world: SimWorld, dtype: torch.dtype) -> Callable:
    return lambda x: shift_rows(x, 1)


def _halo(world: SimWorld, dtype: torch.dtype) -> Callable:
    # my right edge -> right neighbour's left halo and my left edge -> left
    # neighbour's right halo: each rank ends with [left neighbour's right
    # edge, right neighbour's left edge]
    def body(x):
        h = x.shape[1] // 2
        return torch.cat([shift_rows(x[:, h:], 1), shift_rows(x[:, :h], -1)],
                         dim=1)

    return body


# The compute ops.  Their carry is not the (n, elems) rows: mxu_gemm
# carries the ranks' m x m matrices stacked as one (n*m, m) matrix across
# iterations (a reshape back and forth every iteration would be a copy),
# overlap_ring the pair (ring payload, matrices).  Each builder returns
# (pre, body, post): pre and post convert between the rows and the carry
# once a step, body is one iteration.


def _gemm_operands(m: int, dtype: str, device: torch.device):
    """(q, alpha, bias) of one iteration ``x @ q * 1.0000001 + 1e-7``: q
    cast as ``jnp.asarray(_ortho(m), dtype)`` casts, the constants rounded
    to the dtype (stream_triton.stream_constants), the shift as a
    contiguous bias row, so the iteration is one ``addmm`` whose
    multiply-add cuBLASLt does in the product's epilogue."""
    q = to_tensor(_ortho(m), dtype, device)
    scale, shift = stream_triton.stream_constants(DTYPES[dtype])
    bias = torch.full((m,), float(shift), dtype=DTYPES[dtype], device=device)
    return q, float(scale), bias


def _mxu_gemm(world: SimWorld, dtype: str, elems: int):
    # every rank's m x m carry times the same q: the (n, m, m) @ (m, m)
    # batch is one (n*m, m) @ (m, m) product.  The wrap-add keeps the chain
    # from being folded into powers of q.
    n, m = world.n, math.isqrt(elems)
    q, alpha, bias = _gemm_operands(m, dtype, world.device)

    def body(x):
        return torch.addmm(bias, x, q, alpha=alpha)

    return (lambda x: x.view(n * m, m)), body, (lambda c: c.view(n, m * m))


def _overlap_ring(world: SimWorld, dtype: str, elems: int):
    # one iteration: the ring shift of the first r elements of every rank
    # and the gemm of its m x m block.  On a card the shift runs on a side
    # stream that forks from the current stream and joins it after the
    # product, so the two can overlap (under graph capture the fork is a
    # parallel branch); on one stream they would run one after the other.
    n = world.n
    r, m = _overlap_split(elems)
    q, alpha, bias = _gemm_operands(m, dtype, world.device)
    side = (torch.cuda.Stream(world.device) if world.device.type == "cuda"
            else None)

    def pre(x):
        return x[:, :r].contiguous(), x[:, r:].reshape(n * m, m)

    def body(carry):
        comm, comp = carry
        if side is None:
            return shift_rows(comm, 1), torch.addmm(bias, comp, q,
                                                    alpha=alpha)
        cur = torch.cuda.current_stream(world.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            moved = shift_rows(comm, 1)
        y = torch.addmm(bias, comp, q, alpha=alpha)
        # the join: the current stream waits for the shift before this
        # iteration's tensors can be freed, and the side stream waits for
        # the current one before it allocates again, so no block is reused
        # while the other stream still reads it; a record_stream here would
        # keep every iteration's blocks from reuse under graph capture (the
        # trace fence's legs held 54 GiB at 8 x 256 MiB)
        cur.wait_stream(side)
        return moved, y

    def post(carry):
        comm, comp = carry
        return torch.cat([comm, comp.view(n, m * m)], dim=1)

    return pre, body, post


#: ops whose carry is not the rows: op -> (world, dtype name, elems) ->
#: (pre, body, post)
CARRY_BUILDERS: dict[str, Callable] = {
    "mxu_gemm": _mxu_gemm,
    "overlap_ring": _overlap_ring,
}


OP_BUILDERS: dict[str, Callable] = {
    "hier_allreduce": _hier_allreduce,
    "all_gather": _all_gather,
    "all_to_all": _all_to_all,
    "allreduce": _allreduce,
    # a 1-element mean: the collective's latency (payload_elems fixes it)
    "barrier": _allreduce,
    "broadcast": _broadcast,
    "broadcast_psum": _broadcast_psum,
    "exchange": _exchange,
    "halo": _halo,
    "hbm_read": _hbm_read,
    "hbm_stream": _hbm_stream,
    "hbm_triad": _hbm_triad,
    "hbm_write": _hbm_write,
    "pingpong": _pingpong,
    "pingpong_unidir": _pingpong_unidir,
    "ppermute": _exchange,  # alias: the raw pairwise exchange
    "reduce_scatter": _reduce_scatter,
    "ring": _ring,
}


# --- the multi-process world's bodies -----------------------------------
# x is this rank's own buffer.  Each maker returns (body, in_place); an
# in-place body updates the carry it is given, so the step copies its
# input once first (the example input stays as it was).  The collectives
# run on the world's group at any size (a world of one too); only a
# hier_allreduce axis of one rank, which has no group, is local.


def _global_rank(world: DistWorld, rank: int) -> int:
    """The default group's rank of ``rank`` of the world's group (a
    point-to-point peer and a broadcast's source are named by it)."""
    if world.group is None:
        return rank
    import torch.distributed as dist

    return dist.get_global_rank(world.group, rank)


def _ppermute(world: DistWorld, x: torch.Tensor,
              perm: list[tuple[int, int]]) -> torch.Tensor:
    """XLA's ppermute on this rank: the buffer its source sent it, or zeros
    when no rank sends to it; its own pair is a local copy, never a send
    to itself.  One ``batch_isend_irecv``."""
    import torch.distributed as dist

    rank = world.rank
    srcs = [s for s, d in perm if d == rank]
    out = torch.empty_like(x) if srcs else torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == d == rank:
            out.copy_(x)
        elif s == rank:
            ops.append(dist.P2POp(dist.isend, x, _global_rank(world, d),
                                  world.group))
        elif d == rank:
            ops.append(dist.P2POp(dist.irecv, out, _global_rank(world, s),
                                  world.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _dist_allreduce(world: DistWorld, dtype: torch.dtype):
    import torch.distributed as dist

    inv = torch.tensor(1.0 / world.n, dtype=dtype, device=world.device)

    def body(x):
        dist.all_reduce(x, group=world.group)
        return x.mul_(inv)

    return body, True


def _dist_all_gather(world: DistWorld, dtype: torch.dtype):
    from tpu_perf_torch.parallel.multihost import _all_gather_tensor

    n, r = world.n, world.rank

    def body(x):
        g = x.new_empty(n * x.numel())
        _all_gather_tensor(g, x, group=world.group)
        return g.view(n, -1)[r]

    return body, False


def _dist_reduce_scatter(world: DistWorld, dtype: torch.dtype):
    # this rank's chunk <- the sum of chunk r over the ranks * 1/n, in
    # place on the carry, as the sim body updates its rows
    from tpu_perf_torch.parallel.multihost import _reduce_scatter_tensor

    n, r = world.n, world.rank
    inv = torch.tensor(1.0 / n, dtype=dtype, device=world.device)

    def body(x):
        mine = x.view(n, -1)[r]
        s = torch.empty_like(mine)
        _reduce_scatter_tensor(s, x, group=world.group)
        mine.copy_(s.mul_(inv))
        return x

    return body, True


def _dist_all_to_all(world: DistWorld, dtype: torch.dtype):
    import torch.distributed as dist

    def body(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=world.group)
        return out

    return body, False


def _dist_broadcast(world: DistWorld, dtype: torch.dtype):
    # the library's own broadcast from rank 0, in place
    import torch.distributed as dist

    src = _global_rank(world, 0)

    def body(x):
        dist.broadcast(x, src=src, group=world.group)
        return x

    return body, True


def _dist_broadcast_psum(world: DistWorld, dtype: torch.dtype):
    # rank 0's buffer, zeros elsewhere, summed over the ranks
    import torch.distributed as dist

    def body(x):
        y = x.clone() if world.rank == 0 else torch.zeros_like(x)
        dist.all_reduce(y, group=world.group)
        return y

    return body, False


def _dist_pingpong(world: DistWorld, dtype: torch.dtype):
    fwd = one_way_permutation(world.n)
    back = one_way_permutation(world.n, reverse=True)
    return (lambda x: _ppermute(world, _ppermute(world, x, fwd), back)), False


def _dist_pingpong_unidir(world: DistWorld, dtype: torch.dtype):
    # the payload one way, its first element back as the ack into slot 0
    fwd = one_way_permutation(world.n)
    back = one_way_permutation(world.n, reverse=True)

    def body(x):
        ack = _ppermute(world, x, fwd)[:1]
        x[:1] = _ppermute(world, ack, back)
        return x

    return body, True


def _dist_exchange(world: DistWorld, dtype: torch.dtype):
    perm = pair_permutation(world.n)
    return (lambda x: _ppermute(world, x, perm)), False


def _dist_ring(world: DistWorld, dtype: torch.dtype):
    perm = ring_permutation(world.n)
    return (lambda x: _ppermute(world, x, perm)), False


def _dist_halo(world: DistWorld, dtype: torch.dtype):
    # my right edge -> right neighbour's left halo, my left edge -> left
    # neighbour's right halo
    fwd = ring_permutation(world.n, shift=1)
    back = ring_permutation(world.n, shift=-1)

    def body(x):
        h = x.shape[-1] // 2
        return torch.cat([_ppermute(world, x[x.shape[-1] - h:], fwd),
                          _ppermute(world, x[:h], back)])

    return body, False


def _dist_hier_allreduce(world: DistWorld, dtype: torch.dtype):
    # a reduce-scatter over ici, an all-reduce over dcn, an all-gather
    # over ici, then 1/n; the axis groups are made once per world
    import torch.distributed as dist

    from tpu_perf_torch.parallel.multihost import (
        _all_gather_tensor, _reduce_scatter_tensor,
    )

    dcn_axis, ici_axis = world.axis_names
    ici, ici_ranks = world.axis_group(ici_axis)
    dcn, dcn_ranks = world.axis_group(dcn_axis)
    n_ici, n_dcn = len(ici_ranks), len(dcn_ranks)
    inv = torch.tensor(1.0 / world.n, dtype=dtype, device=world.device)

    def body(x):
        if n_ici > 1:
            s = x.new_empty(x.numel() // n_ici)
            _reduce_scatter_tensor(s, x, group=ici)
        else:
            s = x.clone()
        if n_dcn > 1:
            dist.all_reduce(s, group=dcn)
        if n_ici > 1:
            y = x.new_empty(x.numel())
            _all_gather_tensor(y, s, group=ici)
        else:
            y = s
        return y.mul_(inv)

    return body, False


#: op -> (world, dtype) -> (body, in_place), in a multi-process world
DIST_BODIES: dict[str, Callable] = {
    "all_gather": _dist_all_gather,
    "all_to_all": _dist_all_to_all,
    "allreduce": _dist_allreduce,
    "barrier": _dist_allreduce,
    "broadcast": _dist_broadcast,
    "broadcast_psum": _dist_broadcast_psum,
    "exchange": _dist_exchange,
    "halo": _dist_halo,
    "hier_allreduce": _dist_hier_allreduce,
    "pingpong": _dist_pingpong,
    "pingpong_unidir": _dist_pingpong_unidir,
    "ppermute": _dist_exchange,
    "reduce_scatter": _dist_reduce_scatter,
    "ring": _dist_ring,
}


def _dist_overlap_ring(world: DistWorld, dtype: str, elems: int):
    # the sim world's iteration on one rank of many: the ring shift of the
    # first r elements through the library's ppermute and the gemm of the
    # rank's m x m block.  On a card the shift runs on a side stream that
    # forks from the current stream and joins it after the product, so the
    # two can overlap; on the CPU (gloo) they run one after the other.
    r, m = _overlap_split(elems)
    q, alpha, bias = _gemm_operands(m, dtype, world.device)
    perm = ring_permutation(world.n)
    side = (torch.cuda.Stream(world.device) if world.device.type == "cuda"
            else None)

    def pre(x):
        return x[:r].contiguous(), x[r:].reshape(m, m)

    def body(carry):
        comm, comp = carry
        if side is None:
            return (_ppermute(world, comm, perm),
                    torch.addmm(bias, comp, q, alpha=alpha))
        cur = torch.cuda.current_stream(world.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            moved = _ppermute(world, comm, perm)
        y = torch.addmm(bias, comp, q, alpha=alpha)
        cur.wait_stream(side)  # the join orders reuse (see _overlap_ring)
        return moved, y

    def post(carry):
        comm, comp = carry
        return torch.cat([comm, comp.reshape(-1)])

    return pre, body, post


def _dist_step(op: str, world: DistWorld, dtype: str, elems: int,
               iters: int) -> Callable:
    """The step of a non-``pl_*`` op on one rank of a multi-process world:
    the library bodies above, ``overlap_ring``'s shift through the
    library's ppermute beside its product, or, for the ops whose function
    is each rank's own (and ``overlap_ring`` in a world of one), the sim
    world's body at one rank on this rank's buffer."""
    if op in DIST_BODIES:
        body, in_place = DIST_BODIES[op](world, DTYPES[dtype])
        return chained(body, iters, pre=(lambda x: x.clone()) if in_place
                       else None)
    if op == "overlap_ring" and world.n > 1:
        pre, body, post = _dist_overlap_ring(world, dtype, elems)
        return chained(body, iters, pre, post)
    if op not in _LOCAL_OPS and world.n > 1:
        raise NotImplementedError(
            f"{op} across {world.n} ranks is not yet ported, see ROADMAP")
    return _local_step(op, world.device, dtype, elems, iters)


def chained(call: Callable, iters: int, pre: Callable | None = None,
            post: Callable | None = None) -> Callable:
    """``iters`` executions of ``call``, each fed the previous output;
    ``pre`` and ``post`` convert the input into the carry and back, once
    a step."""
    def step(x):
        if pre is not None:
            x = pre(x)
        for _ in range(iters):
            x = call(x)
        return post(x) if post is not None else x

    return step


def build_fused_step(built: BuiltOp, reps: int) -> Callable:
    """The fused measurement loop (``tpu_perf/ops/collectives.py``
    build_fused_step): ``reps`` whole runs of ``built.step``, each fed the
    previous run's output, so no run can be skipped or reordered.
    ``on_run(i)``, when given, is called after run i is issued: the timing
    layer records its events there.  The CUDA graph that makes the loop
    one device dispatch lives in the timing layer
    (:class:`tpu_perf_torch.timing.FusedRunner`)."""
    if reps <= 0:
        raise ValueError(f"reps must be positive, got {reps}")
    inner = built.step

    def fused(x, on_run=None):
        for i in range(reps):
            x = inner(x)
            if on_run is not None:
                on_run(i)
        return x

    fused.__name__ = fused.__qualname__ = f"tpuperf_fused_{built.name}"
    return fused


def host_constants(op: str, nbytes: int, dtype: str, n: int) -> None:
    """Compute the host-side constants a build of ``op`` at ``nbytes`` on
    ``n`` ranks will ask for (``mxu_gemm`` and ``overlap_ring``'s
    orthogonal matrix, a QR of up to 4096 x 4096 on the host), touching
    no device: the compile pipeline's worker runs it ahead of the build."""
    if op not in ("mxu_gemm", "overlap_ring") or dtype not in DTYPES:
        return
    elems, _ = payload_elems(op, nbytes, n, DTYPES[dtype].itemsize)
    m = (math.isqrt(elems) if op == "mxu_gemm"
         else _overlap_split(elems)[1])
    _ortho(m)


def known_ops() -> list[str]:
    from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS

    return sorted([*OP_BUILDERS, *CARRY_BUILDERS]) + list(PALLAS_OPS)


def _axes_of(world: SimWorld | DistWorld,
             axis: str | tuple[str, ...] | None) -> tuple[str, ...]:
    """``axis`` as a tuple of the world's axis names (None: every axis, in
    the mesh's order; the JAX package's ``_flat_axes``)."""
    if axis is None:
        return tuple(world.axis_names)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = [a for a in axes if a not in world.axis_names]
    if unknown or not axes:
        raise ValueError(
            f"axis {axis!r} names no axis of the mesh {world.axis_names}")
    return axes


def _local_step(op: str, device, dtype: str, elems: int,
                iters: int) -> Callable:
    """The step of a library op on one rank alone, on this rank's
    ``(elems,)`` buffer: the sim world's body at one rank (a collective
    over one rank moves nothing across ranks)."""
    one = SimWorld(1, device)
    if op in CARRY_BUILDERS:
        pre, body, post = CARRY_BUILDERS[op](one, dtype, elems)
        return chained(body, iters, lambda x: pre(x.view(1, -1)),
                       lambda c: post(c).view(-1))
    body = OP_BUILDERS[op](one, DTYPES[dtype])
    return chained(body, iters, lambda x: x.unsqueeze(0),
                   lambda x: x.squeeze(0))


def _sim_step(op: str, world: SimWorld, dtype: str, elems: int,
              iters: int) -> Callable:
    if op in CARRY_BUILDERS:
        pre, body, post = CARRY_BUILDERS[op](world, dtype, elems)
        return chained(body, iters, pre, post)
    return chained(OP_BUILDERS[op](world, DTYPES[dtype]), iters)


def _along_axes(op: str, world: SimWorld | DistWorld, axes: tuple[str, ...],
                nbytes: int, iters: int, dtype: str, window: int,
                reuse_input: torch.Tensor | None) -> BuiltOp:
    """A library op along ``axes`` of the world's mesh (the JAX package's
    ``build_op(..., axis=)``): k ranks a group, where k is the product of
    the axes' sizes, each group's ranks holding the k shards of one global
    input (replicated over the other axes, as ``P(axes)`` shards it).

    In a multi-process world this rank runs the op on its axis group
    (:meth:`DistWorld.along`, the groups made once a world).  In the sim
    world every group runs it: the rows are held group by group (row j is
    member ``j % k`` of group ``j // k`` of ``mesh.groups(axes)``), and
    each step runs the k-rank step on each group's block in turn."""
    if op == "hier_allreduce" and len(axes) != 2:
        raise ValueError(
            f"hier_allreduce needs a 2-axis (dcn, ici) mesh, got {axes}")
    if op in _PAIRWISE and len(axes) != 1:
        raise ValueError(f"{op} needs a single mesh axis, got {axes}")
    if is_dist(world):
        sub = world.along(axes)
    else:
        groups = world.mesh.groups(axes)
        sub = SimWorld(len(groups[0]), world.device)
    k = sub.n
    if op in _NEEDS_EVEN and k % 2:
        raise ValueError(f"{op} needs an even device count, got {k}")
    elems, actual = payload_elems(op, nbytes, k, DTYPES[dtype].itemsize)
    if is_dist(world):
        step = (_local_step(op, world.device, dtype, elems, iters) if k == 1
                else _dist_step(op, sub, dtype, elems, iters))
        x = example_input(sub, elems, dtype, window=window)
    else:
        g = len(groups)
        one = _sim_step(op, sub, dtype, elems, iters)

        def step(x):
            blocks = x.view(g, k, *x.shape[1:])
            return torch.stack([one(blocks[i]) for i in range(g)]).view(
                x.shape)

        x = example_input(sub, elems, dtype, window=window)
        x = x.repeat(g, *([1] * (x.dim() - 1)))
    if reuse_input is not None:
        if (reuse_input.shape != x.shape or reuse_input.dtype != x.dtype
                or reuse_input.device != x.device):
            raise ValueError(
                f"reuse_input spec mismatch: have {tuple(reuse_input.shape)}/"
                f"{reuse_input.dtype}/{reuse_input.device}, need "
                f"{tuple(x.shape)}/{x.dtype}/{x.device}")
        x = reuse_input
    return BuiltOp(name=op, step=step, example_input=x, nbytes=actual,
                   n_devices=k, iters=iters * window)


def build_op(op: str, world: SimWorld | DistWorld, nbytes: int, iters: int, *,
             dtype: str = "float32", window: int = 1,
             axis: str | tuple[str, ...] | None = None,
             reuse_input: torch.Tensor | None = None) -> BuiltOp:
    """Build the measurement step for ``op`` at message size ``nbytes``.

    ``window`` (``exchange`` / ``ppermute`` only) stacks W buffers that
    every execution exchanges, the reference's windowed non-blocking
    kernel (mpi_perf.c:85-125): the input is ``(n, W, elems)``, the row's
    ``nbytes`` stays one message and ``iters`` counts ``iters * W``
    messages, the JAX package's convention.

    ``reuse_input`` adopts an existing example buffer (the slope and trace
    fences build one op at two trip counts; the fill is identical, so one
    buffer serves both).

    ``axis`` runs the op along one axis (or a tuple of axes) of the
    world's mesh, as the JAX package's ``build_op(..., axis=)`` does: the
    row's ``n_devices`` is the axes' rank count (:func:`_along_axes`).
    The ``pl_*`` ops keep the JAX rule, a single-axis mesh only, so their
    axis can only be that one."""
    from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS, build_pallas_step

    if op not in known_ops():
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
    if op in PALLAS_OPS and window != 1:
        raise ValueError("window does not apply to pallas ops")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window > 1 and op not in ("exchange", "ppermute"):
        raise ValueError(f"window only applies to exchange/ppermute, got {op!r}")
    if axis is not None:
        axes = _axes_of(world, axis)
        if (op in PALLAS_OPS and len(world.axis_names) == 1
                and len(axes) != 1):
            raise ValueError(f"pallas ops need a single mesh axis, got {axes}")
        if op not in PALLAS_OPS and axes != tuple(world.axis_names):
            return _along_axes(op, world, axes, nbytes, iters, dtype, window,
                               reuse_input)
    axes = world.axis_names
    if op == "hier_allreduce" and len(axes) != 2:
        raise ValueError(
            f"hier_allreduce needs a 2-axis (dcn, ici) mesh, got {axes}")
    if op in _PAIRWISE and len(axes) != 1:
        raise ValueError(f"{op} needs a single mesh axis, got {axes}")
    if op in _NEEDS_EVEN and world.n % 2:
        raise ValueError(f"{op} needs an even device count, got {world.n}")
    if op in PALLAS_OPS:
        step, elems, actual = build_pallas_step(op, world, nbytes, iters,
                                                dtype=dtype)
    else:
        itemsize = DTYPES[dtype].itemsize
        elems, actual = payload_elems(op, nbytes, world.n, itemsize)
        if is_dist(world):
            step = _dist_step(op, world, dtype, elems, iters)
        else:
            step = _sim_step(op, world, dtype, elems, iters)
    if reuse_input is not None:
        rows = () if is_dist(world) else (world.n,)
        want = (*rows, window, elems) if window > 1 else (*rows, elems)
        if (tuple(reuse_input.shape) != want
                or reuse_input.dtype != DTYPES[dtype]
                or reuse_input.device != world.device):
            raise ValueError(
                f"reuse_input spec mismatch: have {tuple(reuse_input.shape)}/"
                f"{reuse_input.dtype}/{reuse_input.device}, need {want}/"
                f"{DTYPES[dtype]}/{world.device}")
        x = reuse_input
    else:
        x = example_input(world, elems, dtype, window=window)
    return BuiltOp(name=op, step=step, example_input=x, nbytes=actual,
                   n_devices=world.n, iters=iters * window)
