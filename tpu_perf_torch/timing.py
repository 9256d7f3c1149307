"""Timing harness (port of ``tpu_perf/timing.py``).

PyTorch launches CUDA work asynchronously, as XLA dispatches it, so every
timed call ends in a fence:

* ``block``    — ``torch.cuda.synchronize()``: the host clock stops when
  the device is idle;
* ``readback`` — ``.item()`` of one element of the result: the element
  is on the host only once the work that wrote it finished;
* ``slope``    — two readback-fenced runs at ``iters`` and
  ``iters * SLOPE_ITERS_FACTOR`` executions; the difference over the extra
  executions cancels every constant cost (launch, fence round trip);
* ``trace``    — the device's own clock: CUDA events recorded around each
  run of the (lo, hi) pair, slope-disciplined like ``slope``.  It stands
  in for the JAX package's ``jax.profiler`` device lane.

On a CPU tensor ``block`` and ``readback`` are host-clock timings of the
plain PyTorch versions; ``trace`` needs a card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

#: slope and trace build the kernel at `iters` and `iters * SLOPE_ITERS_FACTOR`
SLOPE_ITERS_FACTOR = 4
#: re-measurements of a slope pair that came out non-positive
_SLOPE_RETRIES = 3


class DegenerateSlopeError(RuntimeError):
    """Every slope sample of a run came out non-positive (t_hi <= t_lo):
    the kernel is lost in timing noise."""


def fence(out: torch.Tensor, mode: str = "block") -> None:
    """Wait for ``out`` according to ``mode`` (block/readback)."""
    if mode == "block":
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif mode == "readback":
        out.reshape(-1)[0].item()
    else:
        raise ValueError(f"fence() takes block|readback, got {mode!r}")


def slope_sample(
    step_lo: Callable,
    step_hi: Callable,
    x_lo,
    x_hi,
    d_iters: int,
    *,
    perf_clock: Callable[[], float] = time.perf_counter,
) -> float | None:
    """One two-point slope measurement: marginal seconds per execution.

    A noise spike during the low run can make ``t_hi < t_lo``; such
    degenerate pairs are retried up to ``_SLOPE_RETRIES`` times and ``None`` is
    returned if the slope never comes out positive."""
    for _ in range(_SLOPE_RETRIES + 1):
        t0 = perf_clock()
        fence(step_lo(x_lo), "readback")
        t_lo = perf_clock() - t0
        t0 = perf_clock()
        fence(step_hi(x_hi), "readback")
        t_hi = perf_clock() - t0
        if t_hi > t_lo:
            return (t_hi - t_lo) / d_iters
    return None


@dataclasses.dataclass(frozen=True)
class RunTimes:
    """Per-run wall times for one sweep point (seconds)."""

    samples: list[float]  # one entry per *measured* run (warm-ups excluded)
    warmup_s: float  # duration of the warm-up call(s)


def time_step(
    step: Callable,
    x,
    num_runs: int,
    *,
    warmup_runs: int = 1,
    fence_mode: str = "block",
) -> RunTimes:
    """Time ``num_runs`` fenced executions of ``step(x)`` after
    ``warmup_runs`` discarded ones (the reference's run-0 skip,
    mpi_perf.c:545, which here also builds the kernels)."""
    if num_runs <= 0:
        raise ValueError(f"num_runs must be positive, got {num_runs}")
    if fence_mode not in ("block", "readback"):
        raise ValueError(f"time_step fences with block|readback, got {fence_mode!r}")
    t0 = time.perf_counter()
    for _ in range(max(1, warmup_runs)):
        fence(step(x), fence_mode)
    warmup_s = time.perf_counter() - t0
    samples = []
    for _ in range(num_runs):
        t0 = time.perf_counter()
        fence(step(x), fence_mode)
        samples.append(time.perf_counter() - t0)
    return RunTimes(samples=samples, warmup_s=warmup_s)


def time_slope(
    step_lo: Callable,
    step_hi: Callable,
    x,
    iters_lo: int,
    iters_hi: int,
    num_runs: int,
    *,
    warmup_runs: int = 1,
) -> RunTimes:
    """Per-execution time via the two-point slope, readback-fenced.
    Samples are *per single execution*; callers multiply by their iters
    for whole-run times."""
    if iters_hi <= iters_lo:
        raise ValueError(f"need iters_hi > iters_lo, got {iters_lo}, {iters_hi}")
    if num_runs <= 0:
        raise ValueError(f"num_runs must be positive, got {num_runs}")
    t0 = time.perf_counter()
    for _ in range(max(1, warmup_runs)):
        fence(step_lo(x), "readback")
        fence(step_hi(x), "readback")
    warmup_s = time.perf_counter() - t0
    d_iters = iters_hi - iters_lo
    samples = []
    for _ in range(num_runs):
        s = slope_sample(step_lo, step_hi, x, x, d_iters)
        if s is not None:
            samples.append(s)
    if not samples:
        raise DegenerateSlopeError(
            "slope timing produced no valid samples (t_hi never exceeded "
            "t_lo) — the measured kernel is lost in timing noise; raise "
            "iters or use more runs"
        )
    return RunTimes(samples=samples, warmup_s=warmup_s)


def time_trace(
    step_lo: Callable,
    step_hi: Callable,
    x,
    iters_lo: int,
    iters_hi: int,
    num_runs: int,
    *,
    warmup_runs: int = 1,
) -> RunTimes:
    """Per-execution time via the two-point slope on the DEVICE clock:
    CUDA events around each (lo, hi) run pair, all recorded on the current
    stream and read after one synchronize.  Each sample is
    ``(dur_hi - dur_lo) / (iters_hi - iters_lo)``, which cancels the
    per-run constants the events still enclose.  Samples are per single
    execution, like :func:`time_slope`."""
    if not x.is_cuda:
        raise ValueError(
            "the trace fence times with CUDA events and needs a CUDA device")
    if iters_hi <= iters_lo:
        raise ValueError(f"need iters_hi > iters_lo, got {iters_lo}, {iters_hi}")
    if num_runs <= 0:
        raise ValueError(f"num_runs must be positive, got {num_runs}")
    t0 = time.perf_counter()
    for _ in range(warmup_runs):
        fence(step_lo(x), "readback")
        fence(step_hi(x), "readback")
    warmup_s = time.perf_counter() - t0
    pairs = []
    for _ in range(num_runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        step_lo(x)
        ev[1].record()
        ev[2].record()
        step_hi(x)
        ev[3].record()
        pairs.append(ev)
    torch.cuda.synchronize(x.device)
    d_iters = iters_hi - iters_lo
    samples = []
    for i, ev in enumerate(pairs):
        d_lo = ev[0].elapsed_time(ev[1]) * 1e-3
        d_hi = ev[2].elapsed_time(ev[3]) * 1e-3
        if d_hi <= d_lo:
            # on the device clock a longer run cannot be faster
            raise RuntimeError(
                f"device-time slope pair {i} is non-positive "
                f"({d_lo:.6f} -> {d_hi:.6f} s)")
        samples.append((d_hi - d_lo) / d_iters)
    return RunTimes(samples=samples, warmup_s=warmup_s)
