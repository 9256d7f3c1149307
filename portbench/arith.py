"""The benchmark's frozen arithmetic: bus factors, the bytes an execution
must move, the card's data-sheet peaks, percentiles, quartile spreads and
the device's busy and idle time in a profiler trace.

Copied, not imported, from the program (``tpu_perf_torch/metrics.py``'s
bus factors and ``percentile``, ``tpu_perf_torch/traceparse.py``'s
``device_summary``, ``tpu_perf_torch/chips.py``'s data-sheet rates), so a
change to the program cannot move the yardstick.  Imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import statistics

#: NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; NVLink 900 GB/s a card,
#: 450 GB/s each way
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9


def _ring(n: int) -> float:
    return (n - 1) / n if n > 1 else 1.0


#: nccl-tests' bus factor per op (doc/PERFORMANCE.md): busbw = algbw x
#: factor(n); the local memory ops count the bytes an execution reads and
#: writes (copy and stream read and write the buffer, write touches it
#: once, triad reads it whole and writes half)
BUS_FACTORS = {
    "pl_allreduce": lambda n: 2.0 * _ring(n) if n > 1 else 1.0,
    "pl_reduce_scatter": _ring,
    "pl_all_to_all": _ring,
    "pl_hbm_copy": lambda n: 2.0,
    "pl_hbm_stream": lambda n: 2.0,
    "pl_hbm_write": lambda n: 1.0,
    "hbm_triad": lambda n: 1.5,
}


def bus_bytes(op: str, nbytes: int, n: int) -> float:
    """Bytes one execution of ``op`` at ``nbytes`` a rank counts toward
    busbw in a world of ``n`` ranks."""
    return nbytes * BUS_FACTORS[op](n)


def memory_bytes(op: str, nbytes: int, n: int) -> int:
    """Bytes one execution must move through one card's memory: each input
    byte read once, each output byte written once, for every rank the card
    holds (``n`` sim ranks on one card; pass n=1 for one rank of a world
    of cards).  ``nbytes`` is the rank's buffer."""
    if op in ("pl_allreduce", "pl_reduce_scatter", "pl_all_to_all",
              "pl_hbm_copy", "pl_hbm_stream"):
        return 2 * nbytes * n
    if op == "pl_hbm_write":
        return nbytes * n
    if op == "hbm_triad":
        return nbytes * 3 // 2 * n
    raise KeyError(op)


def least_seconds(op: str, nbytes: int, ranks: int, *,
                  across_cards: bool) -> float:
    """The least time one execution needs on one card: its memory bytes
    over the HBM rate and, across cards, the bytes a rank sends over its
    links (the bus bytes) over one NVLink direction; the larger bounds
    it.  In the sim world every rank lives on the card."""
    if not across_cards:
        return memory_bytes(op, nbytes, ranks) / HBM_BYTES_PER_S
    # one rank of a world of cards: its own input read, its output written
    mem = memory_bytes(op, nbytes, 1) / HBM_BYTES_PER_S
    link = bus_bytes(op, nbytes, ranks) / NVLINK_BYTES_PER_S
    return max(mem, link)


def window_busbw(visits: list, ranks: int, window_s: float) -> float:
    """GB/s over a window: every execution's bus bytes over its wall."""
    moved = sum(bus_bytes(v.op, v.nbytes, ranks) * v.iters for v in visits)
    return moved / window_s / 1e9


def roofline_share(traced: list, ranks: int, across_cards: bool,
                   busy_s: float) -> float:
    """Percent: the traced executions' least time over the busy time."""
    least = sum(least_seconds(v.op, v.nbytes, ranks,
                              across_cards=across_cards) * v.iters
                for v in traced)
    return 100.0 * least / busy_s


def percentile(samples: list[float], q: float) -> float:
    """Linear-interpolated percentile, q in [0, 100]."""
    if not samples:
        raise ValueError("no samples")
    if not 0 <= q <= 100:
        raise ValueError(f"bad percentile {q}")
    xs = sorted(samples)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    if lo + 1 >= len(xs):
        return xs[-1]
    frac = pos - lo
    return xs[lo] * (1 - frac) + xs[lo + 1] * frac


def quartile_spread(values: list[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, by ``statistics.quantiles(values, n=4)``: the spread the
    bounds are set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


#: chrome-trace categories of work the device itself ran
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass(frozen=True)
class DeviceSummary:
    """What the device did in one traced stretch (seconds)."""

    busy_s: float
    window_s: float
    kernels: dict  # kernel name -> total seconds
    gaps: list     # (start, end) of each idle gap, trace clock, seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else 0.0


def first_span(events: list[dict], name: str) -> float | None:
    """Start (trace clock, seconds) of the first host span ``name``."""
    starts = [float(e["ts"]) * 1e-6 for e in events
              if e.get("ph") == "X" and e.get("name") == name]
    return min(starts) if starts else None


def device_summary(events: list[dict], since: float | None = None
                   ) -> DeviceSummary | None:
    """Busy time (the union of every device event, so overlapping work
    counts once), the window from the first device event's start to the
    last one's end, kernel time by name and the idle gaps between, from
    a chrome trace's events, leaving out events that start before
    ``since`` (trace clock, seconds); None when it holds no device event
    (a CPU run)."""
    spans = []
    kernels: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if since is not None and ts < since:
            continue
        spans.append((ts, ts + dur))
        if e["cat"] == "kernel":
            name = e.get("name", "")
            kernels[name] = kernels.get(name, 0.0) + dur
    if not spans:
        return None
    spans.sort()
    busy, gaps = 0.0, []
    cur_lo, cur_hi = spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            gaps.append((cur_hi, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return DeviceSummary(busy_s=busy, window_s=cur_hi - spans[0][0],
                         kernels=kernels, gaps=gaps)


#: host events the profiler records for the CUDA runtime calls that
#: name an idle gap: the graph's launch, and the fence's wait
_DISPATCH = ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel")
_WAIT = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize")


def name_gaps(gaps: list, events: list[dict], *, top: int = 10) -> list:
    """The ``top`` longest idle gaps as ``[name, seconds]``, each named by
    what the host was doing at its middle: ``dispatch`` (a graph or kernel
    launch), ``fence wait`` (a synchronize), ``visit`` (the harness's
    ``portbench.visit`` span, outside both) or ``between visits``."""
    host = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "")
        if name.startswith(_DISPATCH):
            kind = "dispatch"
        elif name.startswith(_WAIT):
            kind = "fence wait"
        elif name == "portbench.visit":
            kind = "visit"
        else:
            continue
        ts = float(e["ts"]) * 1e-6
        host.append((ts, ts + float(e["dur"]) * 1e-6, kind))
    rank = {"dispatch": 0, "fence wait": 0, "visit": 1}
    out = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        # an inner runtime call names the gap before the visit around it
        mid = (lo + hi) / 2
        kinds = sorted((rank[k], k) for a, b, k in host if a <= mid < b)
        out.append([kinds[0][1] if kinds else "between visits", hi - lo])
    return out
