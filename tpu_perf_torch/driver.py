"""Benchmark driver: the finite run loop, the monitoring daemon and the
rotating CSV logs (port of ``tpu_perf/driver.py``).

* warm-up runs are executed and never logged (the reference's run-0 skip,
  mpi_perf.c:545);
* with a logfolder, rows go out in both schemas: legacy rows to
  ``tcp-*.log`` (mpi_perf.c:550-554) and extended rows to ``tpu-*.log``;
  files rotate every ``log_refresh_sec`` (mpi_perf.c:16,479), and each
  rotation of the legacy log fires the ingest hook (mpi_perf.c:483-490),
  in one process a node (its local rank 0, mpi_perf.c:359-362), whose
  pass skips the node's live writers;
* every ``stats_every`` runs a min/max/avg/p50 heartbeat goes to stderr
  (mpi_perf.c:564-568);
* ``--heartbeat-format json`` prints the heartbeat as one JSON object a
  line, with the JAX package's keys where this package has the value;
* ``-r -1`` is the infinite daemon: one measured run per visit,
  round-robin over every ``(op, nbytes)`` point of the op family and the
  sweep, rows in the rotating logs only (``mode="daemon"``), stopped by
  ``max_runs`` or a signal;
* a finite run walks the family op by op, each over its sizes; with
  ``--streams K`` the same plan rides K CUDA streams in waves
  (:meth:`Driver._run_overlapped`), each row carrying its lane;
* under ``--fence fused`` a finite point's whole budget is one replay of
  a CUDA graph per chunk, and a daemon visit one replay of its point's
  one-run graph;
* ``-d`` (op ``extern``) runs no kernel: each run prints the rendered
  external command to stderr and its rows record the print's wall time
  (mpi_perf.c:147-168, 504-507);
* ``-f`` / ``-n`` check the group-1 file against the sim world's ranks,
  and ``-p`` fills the legacy rows' NumOfFlows;
* in a multi-process world (``--distributed``) every rank drives its own
  rank: each run's time is its maximum over the ranks (one
  ``all_reduce(MAX)`` a point, after its last fence), the logs are named
  by rank, every rank enters the heartbeat's cross-rank min/max/avg
  triple and rank 0 alone prints it, and the peer of the pair topology
  (its IP from the rank-card allgather) is the legacy rows' remote and
  ``extern``'s peer; with ``--streams K`` each lane's collectives ride
  a process group of the lane's own.

The chaos, push and span paths of the JAX driver are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import sys
import time
from typing import Callable

from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import summarize
from tpu_perf_torch.ops.collectives import BuiltOp
from tpu_perf_torch.runner import (
    SweepPointResult, build_point_pair, max_over_ranks, ops_for_options,
    run_point_fused, sizes_for, world_for,
)
from tpu_perf_torch.schema import (
    EXT_PREFIX, LEGACY_PREFIX, LegacyRow, ResultRow, timestamp_now,
    window_index,
)
from tpu_perf_torch.topology import validate_groups
from tpu_perf_torch.timing import (
    FusedPoint, FusedRunner, RunTimes, TraceRunner, fence, measure_overhead,
    resolve_fence, slope_sample, time_trace,
)
from tpu_perf_torch.traceparse import profile_window
from tpu_perf_torch.world import is_dist


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
    """Append-only CSV log with timed rotation (mpi_perf.c:479-497).
    ``on_rotate`` fires after each rotation closes the old file, never on
    the first open; a hook that raises is reported on stderr and counted
    in ``hook_failures``, and never stops the caller: the files it left
    are retried at the next rotation."""

    def __init__(self, folder: str, uuid: str, rank: int, *,
                 refresh_sec: int, clock: Callable[[], float] = time.time,
                 prefix: str = LEGACY_PREFIX,
                 on_rotate: Callable[[], None] | None = None):
        self.folder = folder
        self.uuid = uuid
        self.rank = rank
        self.refresh_sec = refresh_sec
        self.clock = clock
        self.prefix = prefix
        self.on_rotate = on_rotate
        self.hook_failures = 0
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
        elapsed, firing the hook in between.  Returns True on a rotation."""
        if self._fh is None:
            self._open()
            return False
        if self.clock() - self._opened_at < self.refresh_sec:
            return False
        self._fh.close()
        if self.on_rotate is not None:
            try:
                self.on_rotate()
            except Exception as e:  # noqa: BLE001 — a failing ingest must
                # never kill the monitoring daemon
                self.hook_failures += 1
                print(f"[tpu-perf-torch] ingest hook failed: {e}",
                      file=sys.stderr)
        self._open()
        return True

    def write_row(self, row: LegacyRow | ResultRow) -> None:
        if self._fh is None:
            self._open()
        self._fh.write(row.to_csv() + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@dataclasses.dataclass(frozen=True)
class _ExternOp:
    """Stand-in for BuiltOp in the print-only external-launcher mode
    (mpi_perf.c:147-168): what row emission needs, no kernel."""

    name: str
    nbytes: int
    iters: int
    n_devices: int


class Driver:
    """One benchmark invocation: a finite sweep, or the daemon (-r -1)."""

    def __init__(self, opts: Options, *,
                 clock: Callable[[], float] = time.time,
                 perf_clock: Callable[[], float] = time.perf_counter,
                 on_rotate: Callable[[], None] | None = None,
                 ingest: Callable[[int], Callable[[], None]] | None = None,
                 err=None):
        self.world = world_for(opts)
        if opts.fence == "auto":
            # resolved once for the whole job, by the device
            opts = dataclasses.replace(
                opts, fence=resolve_fence(opts.fence, self.world.device))
        self.opts = opts
        self.clock = clock
        self.perf_clock = perf_clock
        self.err = err if err is not None else sys.stderr
        # one process drives every sim rank; a distributed world's
        # process drives its own
        dist_world = is_dist(self.world)
        self.rank = self.world.rank if dist_world else 0
        self.n_hosts = self.world.n if dist_world else 1
        self.ip = local_ip()
        # the pair topology's peer and its IP (the rank-card allgather,
        # made once here by every rank); a process of one is its own
        self.peer_ip = self.ip
        self._peer_ips = [self.ip]
        if self.n_hosts > 1:
            from tpu_perf_torch.parallel import exchange_ips

            self._peer_ips = exchange_ips(self.ip)
            if self.n_hosts % 2 == 0:
                from tpu_perf_torch.extern_launch import pair_for_rank

                _, peer = pair_for_rank(self.rank, self.n_hosts)
                self.peer_ip = self._peer_ips[peer]
        if not self.fires_ingest:
            on_rotate = None
        elif ingest is not None and on_rotate is None:
            on_rotate = ingest(self.ingest_skip)
        self.on_rotate = on_rotate
        self.log: RotatingCsvLog | None = None
        self.ext_log: RotatingCsvLog | None = None
        if opts.logfolder:
            # ingest fires off the legacy log's rotation only: one
            # rotation, one ingest pass
            self.log = RotatingCsvLog(
                opts.logfolder, opts.uuid, self.rank,
                refresh_sec=opts.log_refresh_sec, clock=clock,
                prefix=LEGACY_PREFIX, on_rotate=on_rotate)
            self.ext_log = RotatingCsvLog(
                opts.logfolder, opts.uuid, self.rank,
                refresh_sec=opts.log_refresh_sec, clock=clock,
                prefix=EXT_PREFIX)
        if opts.profile_dir and opts.infinite:
            print("[tpu-perf-torch] --profile-dir is ignored in daemon mode "
                  "(a trace kept per visit would grow without bound); "
                  "profile a finite run instead", file=self.err)
        # a daemon would grow these without bound: its rows live in the
        # rotating logs only
        self.retain_rows = not opts.infinite
        self.result_rows: list[ResultRow] = []
        self.legacy_rows: list[LegacyRow] = []
        # (op, nbytes) -> the launch floor of --measure-dispatch, seconds
        self._overhead_s: dict[tuple[str, int], float] = {}
        # runs whose slope sample was lost to noise, over the whole job
        self.dropped = 0
        # the overlapped sweep's self-audit (--streams K): window_s sums
        # the lanes' dispatch-to-fence windows, wall_s the waves' host
        # walls; with lanes really in flight together window_s > wall_s
        self.stream_totals = {"k": opts.streams, "waves": 0,
                              "window_s": 0.0, "wall_s": 0.0}
        # (op, nbytes) -> recorded runs in the current heartbeat window
        self._window_points: dict[tuple[str, int], int] = {}
        if opts.group1_file:
            self._validate_group_file(opts.group1_file)

    @property
    def fires_ingest(self) -> bool:
        """Whether this process hooks the ingest to its log's rotation:
        one process a node does, its local rank 0 (mpi_perf.c:359-362; the
        JAX package's rank 0 on one host).  One pass a rotation of every
        rank would race the others, each deleting files another is still
        reading."""
        if not is_dist(self.world):
            return True
        from tpu_perf_torch.parallel.multihost import local_rank

        return local_rank() == 0

    @property
    def ingest_skip(self) -> int:
        """The newest files of each family the ingest leaves alone: ``-p``,
        and at least the node's live writers in a distributed world (one
        open log a family a rank; ``LOCAL_WORLD_SIZE``)."""
        if not is_dist(self.world):
            return self.opts.ppn
        from tpu_perf_torch.parallel.multihost import local_world_size

        return max(self.opts.ppn, local_world_size())

    def _validate_group_file(self, path: str) -> None:
        """The reference's group-size check (mpi_perf.c:399-419): group-1
        hosts * ppn must equal half the sim world's ranks, whose pairing
        is positional (first half against second half), so the file only
        validates counts.  A non-zero -n (mpi_perf.c:287-289) must match
        the file too."""
        with open(path) as fh:
            hosts = [ln.strip() for ln in fh if ln.strip()]
        if self.opts.n_group1 and self.opts.n_group1 != len(hosts):
            raise ValueError(
                f"-n {self.opts.n_group1} but {path} lists {len(hosts)} hosts"
            )
        validate_groups(self.world.n, len(hosts), self.opts.ppn)

    def run(self) -> list[ResultRow]:
        """Execute the configured job; returns the extended-schema rows
        (none in daemon mode).  The plan is op-major: every size of the
        family's first op, then the next op's."""
        if self.opts.load:
            # an idle point under a loaded label would be the mislabelling
            # the load column exists to prevent
            raise ValueError(
                "load is not valid on the run/monitor path; background "
                "load is raced by `tpu-perf-torch contend`")
        plan = [(op, nbytes) for op in ops_for_options(self.opts)
                for nbytes in sizes_for(self.opts, op)]
        try:
            if self.opts.infinite:
                self._run_daemon(plan)
            elif self.opts.streams > 1:
                self._run_overlapped(plan, self.opts.streams)
            else:
                for op, nbytes in plan:
                    self._run_finite(op, nbytes)
        finally:
            if self.log is not None:
                self.log.close()
            if self.ext_log is not None:
                self.ext_log.close()
        return self.result_rows

    def _build(self, op: str, nbytes: int, world=None):
        """One point's (built, built_hi) pair in ``world`` (the job's by
        default); extern builds nothing."""
        if op == "extern":
            return _ExternOp("extern", nbytes, self.opts.iters,
                             self.world.n), None
        return build_point_pair(self.opts, world or self.world, op, nbytes)

    def _lane_worlds(self, k: int) -> list:
        """The world each of ``k`` lanes builds its steps in.  In a
        multi-process world every lane past the first gets a process group
        of its own over every rank (made in the same order on every rank),
        so two lanes' collectives in flight at once never share a
        communicator; the pl_* ops' peer buffers are each point's own.
        The sim world's lanes share it."""
        if not is_dist(self.world):
            return [self.world] * k
        import torch.distributed as dist

        ranks = list(range(self.world.n))
        return [self.world] + [
            dataclasses.replace(self.world, group=dist.new_group(ranks),
                                _axis_groups={})
            for _ in range(k - 1)]

    def _extern_command(self, nbytes: int) -> str:
        """The external client/server command for this process, from the
        two-group pair topology (mpi_perf.c:147-168).  One process driving
        every sim rank is its own loopback pair, its peer's IP its own; a
        distributed world's process pairs with its peer rank, whose IP the
        rank-card allgather brought."""
        from tpu_perf_torch.extern_launch import (
            pair_for_rank, render_extern_command,
        )

        group, peer = pair_for_rank(self.rank, self.n_hosts)
        return render_extern_command(
            self.opts.extern_cmd, group=group, rank=self.rank,
            peer_rank=peer, my_ip=self.ip, peer_ip=self._peer_ips[peer],
            ppn=self.opts.ppn, buff_sz=nbytes, iters=self.opts.iters)

    def _warm(self, built: BuiltOp, built_hi: BuiltOp | None) -> None:
        fmode = "readback" if built_hi is not None else self.opts.fence
        for _ in range(max(1, self.opts.warmup_runs)):
            fence(built.step(built.example_input), fmode)
            if built_hi is not None:
                fence(built_hi.step(built_hi.example_input), fmode)
        if self.opts.measure_dispatch and built_hi is None:
            # once a point, after the warm-up, outside every timed window,
            # fenced as the samples are; slope rows skip it (the slope
            # cancels constant costs)
            self._overhead_s[(built.name, built.nbytes)] = measure_overhead(
                built.example_input, fence_mode=fmode)

    def _measure(self, built: BuiltOp, built_hi) -> float | None:
        """One run's wall time for `iters` executions under opts.fence;
        None when a slope sample is lost to timing noise."""
        if isinstance(built, _ExternOp):
            # print-only, as the reference's commented-out system() call:
            # the command goes to stderr every run and the run records the
            # print's wall time (mpi_perf.c:157-165)
            t0 = self.perf_clock()
            print(self._extern_command(built.nbytes), file=self.err,
                  flush=True)
            return self.perf_clock() - t0
        if isinstance(built_hi, FusedRunner):
            # a fused daemon visit: one replay of the point's one-run graph
            return built_hi.chunk(1)[0]
        if isinstance(built_hi, TraceRunner):
            # a trace daemon visit: one replay of each leg's graph
            return built_hi.sample() * built.iters
        if built_hi is not None:  # slope
            s = slope_sample(built.step, built_hi.step, built.example_input,
                             built_hi.example_input,
                             built_hi.iters - built.iters,
                             perf_clock=self.perf_clock)
            return None if s is None else s * built.iters
        t0 = self.perf_clock()
        fence(built.step(built.example_input), self.opts.fence)
        return self.perf_clock() - t0

    def _profile(self, built: BuiltOp):
        """The point's measured window, kept as a trace under
        --profile-dir."""
        return profile_window(self.opts.profile_dir,
                              f"{built.name}-{built.nbytes}",
                              built.example_input.device)

    def _run_finite(self, op: str, nbytes: int) -> None:
        built, built_hi = self._build(op, nbytes)
        runs = range(self.opts.num_runs)
        if isinstance(built, _ExternOp):
            times = [self._measure(built, None) for _ in runs]
        elif isinstance(built_hi, FusedPoint):
            # the whole budget in one graph replay a chunk, per-run device
            # times from the events inside the graph
            times = run_point_fused(self.opts, built, built_hi,
                                    perf_clock=self.perf_clock).samples
        elif self.opts.fence == "trace":
            # one batch of event pairs covers the point's whole budget
            with self._profile(built):
                per_exec = time_trace(built.step, built_hi.step,
                                      built.example_input, built.iters,
                                      built_hi.iters, self.opts.num_runs,
                                      warmup_runs=self.opts.warmup_runs)
            times = [t * built.iters for t in per_exec.samples]
        else:
            self._warm(built, built_hi)
            with self._profile(built):
                times = [self._measure(built, built_hi) for _ in runs]
        # after the point's last fence, outside every timed window
        window: list[float] = []
        for run_id, t in enumerate(max_over_ranks(self.world, times),
                                   start=1):
            if t is None:
                print(f"[tpu-perf-torch] run {run_id}: slope sample lost "
                      "to noise, skipped", file=self.err)
            self._record_run(built, run_id, t, window)

    def _run_overlapped(self, plan: list[tuple[str, int]], k: int) -> None:
        """The overlapped finite sweep (``--streams K``): the plan's points
        ride K lanes in waves (:func:`~tpu_perf_torch.streams.plans.wave_plan`),
        each run dispatching every lane back to back and fencing them in
        dispatch order, so up to K different steps are in flight on the
        card at once without changing any measured step.  A wave's points
        are built and warmed serially before it starts.  The rows carry
        exactly the serial sweep's coordinates, plus each row's 1-based
        lane in the stream column.  Each wave's runs are one window under
        --profile-dir.  In a multi-process world each lane's collectives
        ride a process group of the lane's own (:meth:`_lane_worlds`),
        and each run's lane times are their maxima over the ranks."""
        from tpu_perf_torch.streams.engine import StreamEngine
        from tpu_perf_torch.streams.plans import wave_plan

        worlds = self._lane_worlds(k)
        for w, wave in enumerate(wave_plan(plan, k)):
            lanes = []
            for lane, (op, nbytes) in wave:
                built, built_hi = self._build(op, nbytes, worlds[lane])
                self._warm(built, built_hi)
                lanes.append((lane, built))
            engine = StreamEngine(len(lanes), fence_mode=self.opts.fence,
                                  perf_clock=self.perf_clock)
            windows: dict[int, list[float]] = {lane: [] for lane, _ in lanes}
            self.stream_totals["waves"] += 1
            with profile_window(self.opts.profile_dir, f"streams{k}-wave{w}",
                                self.world.device):
                for run_id in range(1, self.opts.num_runs + 1):
                    t0 = self.perf_clock()
                    for lane, built in lanes:
                        engine.dispatch(lane, built.step,
                                        built.example_input, label=built.name)
                    walls = engine.fence_all()
                    self.stream_totals["wall_s"] += self.perf_clock() - t0
                    # each lane's time its maximum over the ranks, after
                    # the run's last fence
                    times = max_over_ranks(
                        self.world, [walls[lane] for lane, _ in lanes])
                    for (lane, built), t in zip(lanes, times):
                        self.stream_totals["window_s"] += walls[lane]
                        self._record_run(built, run_id, t, windows[lane],
                                         stream=lane + 1)

    def _run_daemon(self, plan: list[tuple[str, int]]) -> None:
        """Infinite monitoring: one measured run per visit, round-robin
        over every (op, nbytes) point of the plan, so a family
        (``--op a,b,c``) rotates the whole instrument set through one
        daemon.  Every point is built (and warmed) before run 1, so a bad
        combination fails before any row is written, and stays resident
        for the daemon's life.  Points whose example inputs have the same
        spec share one buffer; a fused daemon holds one warmed runner (a
        private working buffer and a one-run graph) per point and never
        captures again, a trace daemon one pair of leg graphs per point
        (:class:`~tpu_perf_torch.timing.TraceRunner`)."""
        canon: dict[tuple, object] = {}
        points = []
        for op, nbytes in plan:
            built, built_hi = self._build(op, nbytes)
            if isinstance(built, _ExternOp):
                points.append((built, None))
                continue
            x = built.example_input
            keep = canon.setdefault((tuple(x.shape), x.dtype, x.device), x)
            if keep is not x:
                built = dataclasses.replace(built, example_input=keep)
                if isinstance(built_hi, BuiltOp):
                    built_hi = dataclasses.replace(built_hi,
                                                   example_input=keep)
                del x
            if isinstance(built_hi, FusedPoint):
                built_hi = FusedRunner(built_hi, built,
                                       perf_clock=self.perf_clock)
                built_hi.warm()
            elif self.opts.fence == "trace":
                built_hi = TraceRunner(built.step, built_hi.step, keep,
                                       built.iters, built_hi.iters)
                built_hi.warm(self.opts.warmup_runs)
            else:
                self._warm(built, built_hi)
            points.append((built, built_hi))
        self._print_residency(points, len(canon))
        window: list[float] = []
        run_id = 0
        while self.opts.max_runs is None or run_id < self.opts.max_runs:
            run_id += 1
            built, built_hi = points[(run_id - 1) % len(points)]
            t = self._measure(built, built_hi)
            self._record_run(built, run_id,
                             max_over_ranks(self.world, [t])[0], window)

    def _print_residency(self, points, n_inputs: int) -> None:
        """What the daemon holds on the device for its whole life: the
        bytes of each point's input (shared by the points of one spec)
        and, under the fused fence, of its private working buffer; under
        the trace fence, of its leg graphs' memory pool."""
        held = []
        for built, built_hi in points:
            if isinstance(built, _ExternOp):
                continue
            x = built.example_input
            nb = x.numel() * x.element_size()
            if isinstance(built_hi, FusedRunner):
                nb += nb  # the runner's working copy of the input
            elif isinstance(built_hi, TraceRunner):
                nb += built_hi.graph_bytes
            held.append(f"{built.name}/{built.nbytes}={nb}")
        print(f"[tpu-perf-torch] daemon: {len(points)} points, {n_inputs} "
              f"input buffer(s); bytes each point holds (input, and its "
              f"working copy under fused or its graphs' pool under trace): "
              f"{', '.join(held) or 'none'}", file=self.err, flush=True)

    def _record_run(self, built: BuiltOp, run_id: int, t: float | None,
                    window: list[float], *, stream: int = 0) -> None:
        for log in (self.log, self.ext_log):
            if log is not None:
                log.maybe_rotate()
        if t is not None:
            window.append(t)
            key = (built.name, built.nbytes)
            self._window_points[key] = self._window_points.get(key, 0) + 1
            self._emit(built, run_id, t, stream=stream)
        else:
            self.dropped += 1
        if run_id % self.opts.stats_every == 0:
            self._heartbeat(run_id, window)
            window.clear()
            self._window_points.clear()

    def _heartbeat(self, run_id: int, samples: list[float]) -> None:
        # across ranks: the reference's Allreduce min/max/avg triple over
        # the whole window (mpi_perf.c:560-562).  Every rank enters it,
        # one with no samples this window too (NaN: no data), or the
        # others would wait in it; rank 0 alone prints.
        x = None
        if self.n_hosts > 1:
            from tpu_perf_torch.parallel import allreduce_times

            x = allreduce_times(samples if samples else float("nan"))
        if self.rank != 0:
            return
        if self.opts.heartbeat_format == "json":
            # one object a boundary, the JAX package's keys: `window` is
            # the boundary's heartbeat-window index, `points` each
            # (op, nbytes) point's recorded runs in the window
            data = {
                "event": "heartbeat",
                "run": run_id,
                "window": window_index(run_id, self.opts.stats_every),
                "samples": len(samples),
                "dropped": self.dropped,
                "points": {
                    f"{op}/{nbytes}": n
                    for (op, nbytes), n in sorted(self._window_points.items())
                },
            }
            if samples:
                s = summarize(samples)
                data.update(
                    total_ms=sum(samples) * 1e3,
                    min_ms=s["min"] * 1e3,
                    max_ms=s["max"] * 1e3,
                    avg_ms=s["avg"] * 1e3,
                    p50_ms=s["p50"] * 1e3,
                )
            if x is not None:
                # an all-NaN triple is null, never bare NaN (invalid JSON)
                data["hosts"] = {k: None if math.isnan(x[k]) else x[k] * 1e3
                                 for k in ("min", "max", "avg")}
            print(json.dumps(data, sort_keys=True), file=self.err, flush=True)
            return
        xhost = ""
        if x is not None:
            xhost = (f" | hosts min {x['min']*1e3:.3f} max {x['max']*1e3:.3f} "
                     f"avg {x['avg']*1e3:.3f} ms")
        if not samples:
            print(f"[tpu-perf-torch] run {run_id}: no samples this "
                  f"window{xhost}", file=self.err, flush=True)
            return
        s = summarize(samples)
        print(
            f"[tpu-perf-torch] run {run_id}: total {sum(samples)*1e3:.3f} ms, "
            f"min {s['min']*1e3:.3f} max {s['max']*1e3:.3f} "
            f"avg {s['avg']*1e3:.3f} p50 {s['p50']*1e3:.3f} ms{xhost}",
            file=self.err, flush=True)

    def _emit(self, built: BuiltOp, run_id: int, t: float, *,
              stream: int = 0) -> None:
        point = SweepPointResult(
            op=built.name, nbytes=built.nbytes, iters=built.iters,
            n_devices=built.n_devices,
            times=RunTimes(samples=[t], warmup_s=0.0,
                           overhead_s=self._overhead_s.get(
                               (built.name, built.nbytes), 0.0)),
            dtype=self.opts.dtype,
            mode="daemon" if self.opts.infinite else "oneshot")
        rrow = point.rows(self.opts.uuid, backend=self.world.backend)[0]
        rrow = dataclasses.replace(rrow, run_id=run_id, stream=stream)
        lrow = LegacyRow(
            timestamp=timestamp_now(),
            job_id=self.opts.uuid,
            rank=self.rank,
            vm_count=self.n_hosts,
            local_ip=self.ip,
            remote_ip=self.peer_ip,  # the sim ranks share this host; a
                                     # distributed rank names its peer's
            num_flows=self.opts.ppn,
            buffer_size=built.nbytes,
            num_buffers=built.iters,
            time_taken_ms=t * 1e3,
            run_id=run_id,
        )
        if self.retain_rows:
            self.result_rows.append(rrow)
            self.legacy_rows.append(lrow)
        if self.log is not None:
            self.log.write_row(lrow)
        if self.ext_log is not None:
            self.ext_log.write_row(rrow)
