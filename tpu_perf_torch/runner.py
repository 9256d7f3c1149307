"""Sweep runner: build op -> time -> rows (port of ``tpu_perf/runner.py``).

One sweep point is measured under the configured fence; the driver
(:mod:`tpu_perf_torch.driver`) owns logging and the CLI's run loop.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import (
    alg_bandwidth_gbps, bus_bandwidth_gbps, is_latency_only, latency_us,
)
from tpu_perf_torch.ops.collectives import DTYPES, BuiltOp, build_op
from tpu_perf_torch.schema import ResultRow, timestamp_now
from tpu_perf_torch.sweep import parse_sweep
from tpu_perf_torch.timing import (
    SLOPE_ITERS_FACTOR, RunTimes, time_slope, time_step, time_trace,
)
from tpu_perf_torch.world import SimWorld, resolve_device


def world_for(opts: Options) -> SimWorld:
    """The sim world an Options asks for: ``sim_ranks`` ranks on the card
    (or on the CPU when ``device="cpu"``)."""
    return SimWorld(opts.sim_ranks, resolve_device(opts.device))


@dataclasses.dataclass(frozen=True)
class SweepPointResult:
    """All measured runs of one (op, nbytes) point."""

    op: str
    nbytes: int
    iters: int
    n_devices: int
    times: RunTimes
    dtype: str = "float32"

    def rows(self, job_id: str, backend: str) -> list[ResultRow]:
        no_payload = is_latency_only(self.op, self.n_devices)
        out = []
        for run_id, t in enumerate(self.times.samples, start=1):
            per_op = t / self.iters
            out.append(ResultRow(
                timestamp=timestamp_now(),
                job_id=job_id,
                backend=backend,
                op=self.op,
                nbytes=self.nbytes,
                iters=self.iters,
                run_id=run_id,
                n_devices=self.n_devices,
                lat_us=latency_us(t, self.iters),
                algbw_gbps=0.0 if no_payload
                else alg_bandwidth_gbps(self.nbytes, per_op),
                busbw_gbps=bus_bandwidth_gbps(
                    self.op, self.nbytes, per_op, self.n_devices),
                time_ms=t * 1e3,
                dtype=self.dtype,
            ))
        return out


def build_point_pair(opts: Options, world: SimWorld, op: str,
                     nbytes: int) -> tuple[BuiltOp, BuiltOp | None]:
    """One point's (lo, hi) op pair for the configured fence: hi is the
    same op at ``iters * SLOPE_ITERS_FACTOR`` executions under slope/trace
    (sharing lo's example buffer), else None."""
    built = build_op(op, world, nbytes, opts.iters, dtype=opts.dtype)
    built_hi = None
    if opts.fence in ("slope", "trace"):
        built_hi = build_op(op, world, nbytes,
                            opts.iters * SLOPE_ITERS_FACTOR,
                            dtype=opts.dtype,
                            reuse_input=built.example_input)
    return built, built_hi


def run_point(opts: Options, world: SimWorld, nbytes: int, *,
              op: str | None = None) -> SweepPointResult:
    """Measure one sweep point: ``opts.num_runs`` runs of ``opts.iters``
    chained executions each."""
    op = op or opts.op
    built, built_hi = build_point_pair(opts, world, op, nbytes)
    x = built.example_input
    if opts.fence in ("slope", "trace"):
        timer = time_trace if opts.fence == "trace" else time_slope
        per_exec = timer(built.step, built_hi.step, x, built.iters,
                         built_hi.iters, opts.num_runs,
                         warmup_runs=opts.warmup_runs)
        times = RunTimes(samples=[t * opts.iters for t in per_exec.samples],
                         warmup_s=per_exec.warmup_s)
    else:
        times = time_step(built.step, x, opts.num_runs,
                          warmup_runs=opts.warmup_runs, fence_mode=opts.fence)
    return SweepPointResult(op=op, nbytes=built.nbytes, iters=built.iters,
                            n_devices=built.n_devices, times=times,
                            dtype=opts.dtype)


def sizes_for(opts: Options) -> list[int]:
    """The sweep (or single buff_sz) for ``opts``, dtype-aligned."""
    if opts.sweep:
        return parse_sweep(opts.sweep, align=DTYPES[opts.dtype].itemsize)
    return [opts.buff_sz]


def run_sweep(opts: Options, world: SimWorld) -> Iterator[SweepPointResult]:
    """Run every point of the configured sweep (or the single buff_sz)."""
    for nbytes in sizes_for(opts):
        yield run_point(opts, world, nbytes)
