"""Latency / bandwidth math (copy of ``tpu_perf/metrics.py``'s tables).

Algorithm and bus bandwidth follow the nccl-tests convention: bus
bandwidth normalizes by the bytes each link must carry, so numbers are
comparable across ops and rank counts.  In the single-card sim world
(:mod:`tpu_perf_torch.world`) the factor ``2(n-1)/n`` is kept for schema
compatibility with the JAX rows, but every "link" is the card's own
memory system: a ``torch-sim`` busbw measures device memory traffic, not
a wire.
"""

from __future__ import annotations

import math

from tpu_perf_torch.config import SUPPORTED_DTYPES

# Bus-bandwidth correction factor per collective, as a function of the number
# of participating devices n.  busbw = algbw * factor(n).
_BUS_FACTORS = {
    # ring allreduce moves 2(n-1)/n of the buffer over each link.
    "allreduce": lambda n: 2.0 * (n - 1) / n if n > 1 else 1.0,
    # barrier is latency-only: a 1-element psum, no meaningful bandwidth
    "barrier": lambda n: 0.0,
    "all_gather": lambda n: (n - 1) / n if n > 1 else 1.0,
    "reduce_scatter": lambda n: (n - 1) / n if n > 1 else 1.0,
    "all_to_all": lambda n: (n - 1) / n if n > 1 else 1.0,
    "broadcast": lambda n: 1.0,
    "broadcast_psum": lambda n: 1.0,
    # point-to-point patterns: the wire carries exactly the payload.
    "ppermute": lambda n: 1.0,
    "pingpong": lambda n: 1.0,
    "pingpong_unidir": lambda n: 1.0,
    "exchange": lambda n: 1.0,
    "ring": lambda n: 1.0,
    "halo": lambda n: 1.0,
    # local memory baseline: each execution reads + writes the buffer once
    "hbm_stream": lambda n: 2.0,
    # single-sided memory instruments: read (or write) the buffer once
    "hbm_read": lambda n: 1.0,
    "hbm_write": lambda n: 1.0,
    # triad mix: reads the whole buffer, writes half of it in place
    "hbm_triad": lambda n: 1.5,
    # matmul roofline, memory-traffic view (x and q read, y written)
    "mxu_gemm": lambda n: 3.0,
    # overlap instrument: busbw counts only the ring payload
    "overlap_ring": lambda n: 1.0,
    # hand-scheduled ring kernels (tpu_perf_torch.ops.pallas_ring)
    "pl_ring": lambda n: 1.0,
    "pl_exchange": lambda n: 1.0,
    "pl_all_gather": lambda n: (n - 1) / n if n > 1 else 1.0,
    "pl_reduce_scatter": lambda n: (n - 1) / n if n > 1 else 1.0,
    "pl_allreduce": lambda n: 2.0 * (n - 1) / n if n > 1 else 1.0,
    "pl_pingpong": lambda n: 1.0,
    "pl_all_gather_bidir": lambda n: (n - 1) / n if n > 1 else 1.0,
    "pl_hbm_copy": lambda n: 2.0,
    # local stream kernel: reads + writes once, like hbm_stream
    "pl_hbm_stream": lambda n: 2.0,
    "pl_hbm_read": lambda n: 1.0,
    "pl_hbm_write": lambda n: 1.0,
    "pl_barrier": lambda n: 0.0,
    "pl_all_to_all": lambda n: (n - 1) / n if n > 1 else 1.0,
    # print-only external launcher (mpi_perf.c:147-168): nothing crosses the
    # wire; rows record only the wall time, like the reference's CSV does
    "extern": lambda n: 0.0,
    # a composed scenario step chains several collectives over several
    # windows, so no one bus factor is honest: its rows carry the step's
    # wall time and lat_us only
    "scenario": lambda n: 0.0,
}

# hier_allreduce is allreduce over a (dcn, ici) mesh: the same wire math;
# the v-ops move their balanced counterparts' aggregate volume at the
# row's size semantics
for _op, _like in (("hier_allreduce", "allreduce"),
                   ("allgatherv", "all_gather"),
                   ("reduce_scatter_v", "reduce_scatter"),
                   ("all_to_all_v", "all_to_all"),
                   ("seg_allreduce", "allreduce")):
    _BUS_FACTORS[_op] = _BUS_FACTORS[_like]

KNOWN_OPS = tuple(sorted(_BUS_FACTORS))

#: FLOPs one iteration performs, per compute op: (nbytes, itemsize) ->
#: flops.  mxu_gemm's buffer is the m x m operand, one m x m x m product
#: an iteration = 2m^3 (the wrap-add's 2m^2 is not counted, the JAX
#: package's convention).  The grid's TFLOP/s verdicts, the report's
#: tflops column and bench read it.
FLOPS_PER_ITER = {
    "mxu_gemm":
        lambda nbytes, itemsize: 2.0 * math.isqrt(nbytes // itemsize) ** 3,
}

#: itemsize per supported payload dtype, by name (no torch import: the
#: report reads it)
DTYPE_ITEMSIZE = {
    "float32": 4, "bfloat16": 2, "float16": 2, "int32": 4, "uint8": 1,
}
if set(DTYPE_ITEMSIZE) != set(SUPPORTED_DTYPES):
    raise RuntimeError(
        "DTYPE_ITEMSIZE and config.SUPPORTED_DTYPES drifted apart: "
        f"{sorted(set(DTYPE_ITEMSIZE) ^ set(SUPPORTED_DTYPES))}")


def flops_per_iter(op: str, nbytes: int, itemsize: int) -> float | None:
    """FLOPs one iteration of ``op`` performs, or None for ops without a
    compute model."""
    fn = FLOPS_PER_ITER.get(op)
    return None if fn is None else fn(nbytes, itemsize)


def flops_per_iter_dtype(op: str, nbytes: int, dtype: str) -> float | None:
    """:func:`flops_per_iter` from the dtype's name; None for ops without
    a model and for dtypes outside the table."""
    itemsize = DTYPE_ITEMSIZE.get(dtype)
    if itemsize is None or op not in FLOPS_PER_ITER:
        return None
    return flops_per_iter(op, nbytes, itemsize)


def is_latency_only(op: str, n_devices: int = 2) -> bool:
    """True for ops whose bus factor is 0: their rows carry wall time /
    latency only, bandwidth columns are zeroed."""
    try:
        return _BUS_FACTORS[op](n_devices) == 0.0
    except KeyError:
        raise ValueError(f"unknown op {op!r}; known: {KNOWN_OPS}") from None


def alg_bandwidth_gbps(nbytes: int, seconds: float) -> float:
    """Algorithm bandwidth in GB/s (decimal): payload bytes / wall time."""
    if seconds <= 0:
        raise ValueError(f"non-positive time {seconds}")
    return nbytes * 1e-9 / seconds


#: kernels whose bus factor is another op's
_METRIC_ALIASES = {"hier_allreduce": "allreduce",
                   "allgatherv": "all_gather",
                   "reduce_scatter_v": "reduce_scatter",
                   "all_to_all_v": "all_to_all",
                   "seg_allreduce": "allreduce"}


def metric_op(op: str) -> str:
    """Resolve a kernel name to the op that carries its bus factor."""
    return _METRIC_ALIASES.get(op, op)


def imbalance_volume_scale(op: str, imbalance: int, n_devices: int) -> float:
    """Wire-volume correction for the v-ops whose moved bytes shrink with
    imbalance at a fixed row nbytes (the JAX package's): ``all_to_all_v``
    fills (n-1+ratio)/(n*ratio) of its slot matrix, and ``seg_allreduce``
    reduces ceil(n/ratio) of its n segments.  The runner multiplies it
    into busbw, so busbw stays the bytes that crossed the wire."""
    r = max(1, int(imbalance))
    if r == 1 or n_devices <= 1:
        return 1.0
    if op == "all_to_all_v":
        return (n_devices - 1 + r) / (n_devices * r)
    if op == "seg_allreduce":
        return -(-n_devices // r) / n_devices
    return 1.0


def bus_bandwidth_gbps(op: str, nbytes: int, seconds: float, n_devices: int) -> float:
    """Bus bandwidth in GB/s for one execution of ``op`` on ``nbytes``."""
    try:
        factor = _BUS_FACTORS[op](n_devices)
    except KeyError:
        raise ValueError(f"unknown op {op!r}; known: {KNOWN_OPS}") from None
    return alg_bandwidth_gbps(nbytes, seconds) * factor


def latency_us(seconds: float, iters: int, *, round_trip: bool = False) -> float:
    """Per-operation latency in microseconds from a timed loop of ``iters``.

    With ``round_trip`` the time covers a full ping-pong round trip and the
    one-way latency is half of it (the reference reports the round trip's
    wall time; the rows report one way, as latency benchmarks do)."""
    if iters <= 0:
        raise ValueError(f"non-positive iters {iters}")
    t = seconds / iters
    return (t / 2 if round_trip else t) * 1e6


def percentile(samples: list[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0,100]) without numpy."""
    if not samples:
        raise ValueError("no samples")
    if not 0 <= q <= 100:
        raise ValueError(f"bad percentile {q}")
    xs = sorted(samples)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= len(xs):
        return xs[-1]
    return xs[lo] * (1 - frac) + xs[lo + 1] * frac


def summarize(samples: list[float]) -> dict[str, float]:
    """min/max/avg like the reference's three MPI_Allreduce (mpi_perf.c:560-562),
    plus p50/p95/p99."""
    if not samples:
        raise ValueError("no samples")
    return {
        "min": min(samples),
        "max": max(samples),
        "avg": sum(samples) / len(samples),
        "p50": percentile(samples, 50),
        "p95": percentile(samples, 95),
        "p99": percentile(samples, 99),
    }
