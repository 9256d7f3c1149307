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
}

KNOWN_OPS = tuple(sorted(_BUS_FACTORS))


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


def bus_bandwidth_gbps(op: str, nbytes: int, seconds: float, n_devices: int) -> float:
    """Bus bandwidth in GB/s for one execution of ``op`` on ``nbytes``."""
    try:
        factor = _BUS_FACTORS[op](n_devices)
    except KeyError:
        raise ValueError(f"unknown op {op!r}; known: {KNOWN_OPS}") from None
    return alg_bandwidth_gbps(nbytes, seconds) * factor


def latency_us(seconds: float, iters: int) -> float:
    """Per-operation latency in microseconds from a timed loop of ``iters``."""
    if iters <= 0:
        raise ValueError(f"non-positive iters {iters}")
    return seconds / iters * 1e6


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
