"""Benchmark driver: the finite run loop and rotating CSV logs (port of the
finite path of ``tpu_perf/driver.py``).

* warm-up runs are executed and never logged (the reference's run-0 skip,
  mpi_perf.c:545);
* with a logfolder, rows go out in both schemas: legacy rows to
  ``tcp-*.log`` (mpi_perf.c:550-554) and extended rows to ``tpu-*.log``;
  files rotate every ``log_refresh_sec`` (mpi_perf.c:16,479);
* every ``stats_every`` runs a min/max/avg/p50 heartbeat goes to stderr
  (mpi_perf.c:564-568).

The daemon, chaos, push and span paths of the JAX driver are not ported
yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
import time
from typing import Callable

from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import summarize
from tpu_perf_torch.ops.collectives import BuiltOp
from tpu_perf_torch.runner import (
    SweepPointResult, build_point_pair, op_for_options, sizes_for, world_for,
)
from tpu_perf_torch.schema import (
    EXT_PREFIX, LEGACY_PREFIX, LegacyRow, ResultRow, timestamp_now,
)
from tpu_perf_torch.timing import (
    RunTimes, fence, slope_sample, time_trace,
)


def local_ip() -> str:
    """Best-effort IPv4 of this host (get_ipaddress, mpi_perf.c:171-198);
    ``0.0.0.0`` when the host name does not resolve."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "0.0.0.0"


def log_file_name(uuid: str, rank: int, now: float | None = None, *,
                  prefix: str = LEGACY_PREFIX) -> str:
    """``<prefix>-<uuid>-<rank>-<timestamp>.log`` (mpi_perf.c:492-495)."""
    ts = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    return f"{prefix}-{uuid}-{rank}-{ts}.log"


class RotatingCsvLog:
    """Append-only CSV log with timed rotation (mpi_perf.c:479-497)."""

    def __init__(self, folder: str, uuid: str, rank: int, *,
                 refresh_sec: int, clock: Callable[[], float] = time.time,
                 prefix: str = LEGACY_PREFIX):
        self.folder = folder
        self.uuid = uuid
        self.rank = rank
        self.refresh_sec = refresh_sec
        self.clock = clock
        self.prefix = prefix
        self._fh = None
        self._opened_at = None
        os.makedirs(folder, exist_ok=True)

    def _open(self) -> None:
        path = os.path.join(
            self.folder,
            log_file_name(self.uuid, self.rank, self.clock(), prefix=self.prefix),
        )
        self._fh = open(path, "a")
        self._opened_at = self.clock()

    def maybe_rotate(self) -> bool:
        """Open on first use; close and reopen when the refresh period has
        elapsed.  Returns True on a rotation."""
        if self._fh is None:
            self._open()
            return False
        if self.clock() - self._opened_at >= self.refresh_sec:
            self._fh.close()
            self._open()
            return True
        return False

    def write_row(self, row: LegacyRow | ResultRow) -> None:
        if self._fh is None:
            self._open()
        self._fh.write(row.to_csv() + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class Driver:
    """One finite benchmark invocation over the configured sweep."""

    def __init__(self, opts: Options, *,
                 clock: Callable[[], float] = time.time,
                 perf_clock: Callable[[], float] = time.perf_counter,
                 err=None):
        self.opts = opts
        self.world = world_for(opts)
        self.clock = clock
        self.perf_clock = perf_clock
        self.err = err if err is not None else sys.stderr
        self.rank = 0  # one process drives every sim rank
        self.ip = local_ip()
        self.log: RotatingCsvLog | None = None
        self.ext_log: RotatingCsvLog | None = None
        if opts.logfolder:
            self.log = RotatingCsvLog(
                opts.logfolder, opts.uuid, self.rank,
                refresh_sec=opts.log_refresh_sec, clock=clock,
                prefix=LEGACY_PREFIX)
            self.ext_log = RotatingCsvLog(
                opts.logfolder, opts.uuid, self.rank,
                refresh_sec=opts.log_refresh_sec, clock=clock,
                prefix=EXT_PREFIX)
        self.result_rows: list[ResultRow] = []
        self.legacy_rows: list[LegacyRow] = []

    def run(self) -> list[ResultRow]:
        """Execute the configured sweep; returns the extended-schema rows."""
        op = op_for_options(self.opts)
        try:
            for nbytes in sizes_for(self.opts, op):
                self._run_finite(op, nbytes)
        finally:
            if self.log is not None:
                self.log.close()
            if self.ext_log is not None:
                self.ext_log.close()
        return self.result_rows

    def _warm(self, built: BuiltOp, built_hi: BuiltOp | None) -> None:
        fmode = "readback" if built_hi is not None else self.opts.fence
        for _ in range(max(1, self.opts.warmup_runs)):
            fence(built.step(built.example_input), fmode)
            if built_hi is not None:
                fence(built_hi.step(built_hi.example_input), fmode)

    def _measure(self, built: BuiltOp, built_hi: BuiltOp | None) -> float | None:
        """One run's wall time for `iters` executions under opts.fence;
        None when a slope sample is lost to timing noise."""
        if built_hi is not None:  # slope
            s = slope_sample(built.step, built_hi.step, built.example_input,
                             built_hi.example_input,
                             built_hi.iters - built.iters,
                             perf_clock=self.perf_clock)
            return None if s is None else s * built.iters
        t0 = self.perf_clock()
        fence(built.step(built.example_input), self.opts.fence)
        return self.perf_clock() - t0

    def _run_finite(self, op: str, nbytes: int) -> None:
        built, built_hi = build_point_pair(self.opts, self.world, op, nbytes)
        window: list[float] = []
        if self.opts.fence == "trace":
            # one batch of event pairs covers the point's whole budget
            times = time_trace(built.step, built_hi.step, built.example_input,
                               built.iters, built_hi.iters,
                               self.opts.num_runs,
                               warmup_runs=self.opts.warmup_runs)
            for run_id, t in enumerate(times.samples, start=1):
                self._record_run(built, run_id, t * built.iters, window)
            return
        self._warm(built, built_hi)
        for run_id in range(1, self.opts.num_runs + 1):
            t = self._measure(built, built_hi)
            if t is None:
                print(f"[tpu-perf-torch] run {run_id}: slope sample lost "
                      "to noise, skipped", file=self.err)
            self._record_run(built, run_id, t, window)

    def _record_run(self, built: BuiltOp, run_id: int, t: float | None,
                    window: list[float]) -> None:
        for log in (self.log, self.ext_log):
            if log is not None:
                log.maybe_rotate()
        if t is not None:
            window.append(t)
            self._emit(built, run_id, t)
        if run_id % self.opts.stats_every == 0:
            self._heartbeat(run_id, window)
            window.clear()

    def _heartbeat(self, run_id: int, samples: list[float]) -> None:
        if not samples:
            print(f"[tpu-perf-torch] run {run_id}: no samples this window",
                  file=self.err, flush=True)
            return
        s = summarize(samples)
        print(
            f"[tpu-perf-torch] run {run_id}: total {sum(samples)*1e3:.3f} ms, "
            f"min {s['min']*1e3:.3f} max {s['max']*1e3:.3f} "
            f"avg {s['avg']*1e3:.3f} p50 {s['p50']*1e3:.3f} ms",
            file=self.err, flush=True)

    def _emit(self, built: BuiltOp, run_id: int, t: float) -> None:
        point = SweepPointResult(
            op=built.name, nbytes=built.nbytes, iters=built.iters,
            n_devices=built.n_devices,
            times=RunTimes(samples=[t], warmup_s=0.0), dtype=self.opts.dtype)
        rrow = point.rows(self.opts.uuid, backend=self.world.backend)[0]
        rrow = dataclasses.replace(rrow, run_id=run_id)
        lrow = LegacyRow(
            timestamp=timestamp_now(),
            job_id=self.opts.uuid,
            rank=self.rank,
            vm_count=1,
            local_ip=self.ip,
            remote_ip=self.ip,  # the sim ranks share this host
            num_flows=1,
            buffer_size=built.nbytes,
            num_buffers=built.iters,
            time_taken_ms=t * 1e3,
            run_id=run_id,
        )
        self.result_rows.append(rrow)
        self.legacy_rows.append(lrow)
        if self.log is not None:
            self.log.write_row(lrow)
        if self.ext_log is not None:
            self.ext_log.write_row(rrow)
