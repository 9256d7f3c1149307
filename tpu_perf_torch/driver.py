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
  a process group of the lane's own;
* ``--ci-rel`` stops each finite point early once its CI is tight
  enough (:mod:`tpu_perf_torch.adaptive`): one observation a run under
  block, readback and slope, one a chunk under fused, every rank voting
  after each; it is bypassed, loudly, under the trace fence, the daemon,
  ``--streams`` above 1, ``extern`` and a budget not above
  ``--min-runs``;
* the harness times its own phases (``compile`` / ``measure`` / ``log``,
  :class:`~tpu_perf_torch.compilepipe.PhaseTimer`): the JSON heartbeat's
  ``phase`` key and a ``phase-<job>-<rank>.json`` sidecar beside the logs;
  ``--precompile N|auto`` builds the host half of the next points on a
  worker thread (:class:`~tpu_perf_torch.compilepipe.CompilePipeline`),
  and ``--compile-cache DIR`` keeps the kernel builds in DIR;
* ``--spans`` records the harness' own spans (:mod:`tpu_perf_torch.spans`:
  job, sweep, point, run, measure, fence, warmup, build, stop_vote,
  rotate, ingest_hook, inject, heartbeat, dispatch, stream_fence) into
  the ``spans-*.log`` family, and stamps each row and health event with
  its run span;
* ``--health`` judges every recorded run against its point's streaming
  baseline (:mod:`tpu_perf_torch.health`): events to ``health-*.log``,
  gauges to ``--health-textfile``;
* ``chaos`` (a fault schedule, or ``--synthetic``) consults a seeded
  :class:`~tpu_perf_torch.faults.FaultInjector` each run: ``skew`` faults
  stagger the dispatch, the others perturb or drop the measured sample,
  fail the ingest hook, or corrupt the selftest's read-back output, and
  the injections go to the ``chaos-*.log`` ledger.

* ``--push URL`` / ``--push-textfile PATH`` tee every record family but
  the chaos ledger, after its durable write, into the push plane
  (:mod:`tpu_perf_torch.push`): a bounded queue that a background thread
  sends as NDJSON to ``URL/v1/<Table>``, spooling what it cannot deliver;
  its counters ride the heartbeat, the phase sidecar and the exporter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import socket
import sys
import time
from typing import Callable

from tpu_perf_torch.compilepipe import (
    CompilePipeline, CompileSpec, PhaseTimer, enable_compile_cache, prepare,
)
from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import summarize
from tpu_perf_torch.ops.collectives import BuiltOp
from tpu_perf_torch.push.plane import NULL_PUSHER
from tpu_perf_torch.runner import (
    SweepPointResult, algos_for_options, build_point_pair, fused_plan_for,
    max_over_ranks, ops_for_options, point_controller, run_point_fused,
    sizes_for, trace_align, without_p50, world_for,
)
from tpu_perf_torch.schema import (
    CHAOS_PREFIX, EXT_PREFIX, HEALTH_PREFIX, LEGACY_PREFIX, SPANS_PREFIX,
    LegacyRow, ResultRow, decorate_op, timestamp_now, window_index,
)
from tpu_perf_torch.spans import NULL_TRACER, SpanTracer
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
    in ``hook_failures`` (the driver turns each into a health event), and
    never stops the caller: the files it left are retried at the next
    rotation.

    A ``lazy`` log (the sparse JSONL families: health, chaos, spans) opens
    only when a row is written, keeps its active file under a ``.open``
    suffix (so every ``<prefix>-*.log`` on disk is finished), and stays
    closed after a rotation until the next row."""

    def __init__(self, folder: str, uuid: str, rank: int, *,
                 refresh_sec: int, clock: Callable[[], float] = time.time,
                 prefix: str = LEGACY_PREFIX,
                 on_rotate: Callable[[], None] | None = None,
                 lazy: bool = False,
                 tee: Callable[[str], None] | None = None):
        self.folder = folder
        self.uuid = uuid
        self.rank = rank
        self.refresh_sec = refresh_sec
        self.clock = clock
        self.prefix = prefix
        self.on_rotate = on_rotate
        self.lazy = lazy
        #: the push plane's per-family tee (--push): each written line is
        #: also handed here, after the durable write; None (always for the
        #: chaos ledger) leaves the write path as it was
        self.tee = tee
        self.hook_failures = 0
        self._fh = None
        self._opened_at = None
        os.makedirs(folder, exist_ok=True)

    def _open(self) -> None:
        path = os.path.join(
            self.folder,
            log_file_name(self.uuid, self.rank, self.clock(), prefix=self.prefix),
        )
        if self.lazy:
            # the close renames .open over the bare name, so a rotation
            # within one second must not reuse (and overwrite) an earlier
            # file's name; the CSV families just append to it
            base, i = path, 0
            while os.path.exists(path) or os.path.exists(path + ".open"):
                i += 1
                path = f"{base[:-len('.log')]}-{i}.log"
            path += ".open"
        self._fh = open(path, "a")
        self._opened_at = self.clock()

    def _close_current(self) -> None:
        """Close the active file; a lazy log drops the ``.open`` suffix, so
        the finished file becomes visible to ingest as <prefix>-*.log."""
        if self._fh is None:
            return
        path = self._fh.name
        self._fh.close()
        self._fh = None
        if self.lazy and path.endswith(".open"):
            os.replace(path, path[: -len(".open")])

    def maybe_rotate(self) -> bool:
        """Open on first use (a lazy log does not); rotate when the refresh
        period has elapsed.  Returns True on a rotation."""
        if self._fh is None:
            if not self.lazy:
                self._open()
            return False
        if self.clock() - self._opened_at < self.refresh_sec:
            return False
        return self.rotate_now()

    def rotate_now(self) -> bool:
        """Close, fire the hook and reopen, whatever the clock (a
        ``hook_fail`` fault forces its rotation at a set run, so the
        failure's run does not depend on the wall clock).  A no-op while
        nothing is open: the first open is not a rotation."""
        if self._fh is None:
            return False
        self._close_current()
        if self.on_rotate is not None:
            try:
                self.on_rotate()
            except Exception as e:  # noqa: BLE001 — a failing ingest must
                # never kill the monitoring daemon
                self.hook_failures += 1
                print(f"[tpu-perf-torch] ingest hook failed: {e}",
                      file=sys.stderr)
        if not self.lazy:
            self._open()
        return True

    def write_row(self, row) -> None:
        if self._fh is None:
            self._open()
        line = row.to_csv()
        self._fh.write(line + "\n")
        self._fh.flush()
        if self.tee is not None:
            # the push plane's tee, after the durable write: an enqueue
            self.tee(line)

    def close(self) -> None:
        self._close_current()


def _op_label(built, skew_us: int = 0) -> str:
    """The op name with the arena decomposition, the arrival spread and
    the payload imbalance folded in (``allreduce[ring]@500us``,
    ``allgatherv%8``, ``scenario[moe-dispatch-combine]%8``): what the
    health baselines, the drop counts and the heartbeat's points key on,
    so one daemon racing several algorithms, spreads or ratios never
    blends their latency streams.  The injector and the rows keep the raw
    op name; rows carry the coordinates in their own columns."""
    return decorate_op(built.name, getattr(built, "algo", "native"),
                       skew_us, getattr(built, "imbalance", 1))


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
        if opts.compile_cache:
            # before any kernel builds, the precompile worker's included
            enable_compile_cache(opts.compile_cache)
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
            from tpu_perf_torch.parallel import exchange_ips, share_job_id

            # one job ID for every rank of the world, rank 0's (the
            # reference broadcasts its options, UUID included)
            self.opts = opts = dataclasses.replace(
                opts, uuid=share_job_id(opts.uuid))
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
        # the span tracer (--spans): off, the inert NULL_TRACER (no clock
        # reads, no bytes); its clock is perf_clock, so an injected clock
        # makes the records deterministic
        self.tracer = NULL_TRACER
        if opts.spans:
            span_log = None
            if opts.logfolder:
                span_log = RotatingCsvLog(
                    opts.logfolder, opts.uuid, self.rank,
                    refresh_sec=opts.log_refresh_sec, clock=clock,
                    prefix=SPANS_PREFIX, lazy=True)
            else:
                print("[tpu-perf-torch] --spans without a logfolder keeps "
                      "spans in memory only (no spans-*.log)", file=self.err)
            self.tracer = SpanTracer(
                opts.uuid, rank=self.rank, log=span_log,
                # a daemon must not grow without bound
                retain=not opts.infinite,
                perf_ns=lambda: int(perf_clock() * 1e9),
                sample=opts.spans_sample)
        # the push plane (--push / --push-textfile): every family but the
        # chaos ledger teed at its write boundary into a bounded queue a
        # background thread drains; off, the inert NULL_PUSHER (no thread,
        # no clock reads)
        self.pusher = NULL_PUSHER
        if opts.push_url or opts.push_textfile:
            from tpu_perf_torch.push import plane_from_options

            self.pusher = plane_from_options(
                opts, rank=self.rank, tracer=self.tracer, err=self.err)
            if opts.push_url and not opts.logfolder:
                print("[tpu-perf-torch push] no logfolder: the dead-letter "
                      "spool is disabled — batches that exhaust their "
                      "retries are dropped (counted in the gauges)",
                      file=self.err)
            span_log = getattr(self.tracer, "log", None)
            if span_log is not None:
                # the plane's own push spans need the tracer: the tee
                # attaches after both exist
                span_log.tee = self.pusher.tee_for(SPANS_PREFIX)
        # the fault injector (chaos: a schedule, or --synthetic alone for
        # the fault-free soak), its ledger the chaos-*.log family
        self.injector = None
        if opts.faults is not None or opts.synthetic_s is not None:
            from tpu_perf_torch.faults import FaultInjector

            ledger = None
            if opts.logfolder:
                ledger = RotatingCsvLog(
                    opts.logfolder, opts.uuid, self.rank,
                    refresh_sec=opts.log_refresh_sec, clock=clock,
                    prefix=CHAOS_PREFIX, lazy=True)
            self.injector = FaultInjector(
                list(opts.faults or ()), seed=opts.fault_seed,
                stats_every=opts.stats_every, ledger=ledger,
                synthetic_s=opts.synthetic_s, rank=self.rank, err=self.err)
            self.injector.write_meta()
        if (self.injector is not None and self.injector.has_skew()
                and not self.injector.synthetic):
            # a skew fault no peer process can observe would be a planted
            # fault no detector can catch
            if self.n_hosts == 1:
                raise ValueError(
                    "skew fault(s) on a single-process job with real "
                    "timing: the entry stagger is real but no peer "
                    "process exists to observe it, so the injection is "
                    "undetectable by construction — use --synthetic "
                    "for the modeled victim cost, or run multi-process "
                    "(--distributed)")
            phantom = [f.rank for f in opts.faults or ()
                       if f.kind == "skew" and f.rank is not None
                       and f.rank >= self.n_hosts]
            if phantom:
                raise ValueError(
                    f"skew fault(s) name straggler rank(s) {phantom} "
                    f"beyond the real world (n_hosts={self.n_hosts}): "
                    "real timing cannot model a phantom straggler, so "
                    "those specs could never fire — use --synthetic, "
                    "or run on enough ranks to seat the named rank")
        if any(opts.skew_spread) and self.n_hosts == 1 and (
                self.injector is None or not self.injector.synthetic):
            # the arrival-spread axis in one process with real timing: the
            # stagger is real, but no peer process waits for it
            print("[tpu-perf-torch] arrival skew on a single-process job: "
                  "the entry stagger is real but no peer process exists "
                  "to wait for it, so measured samples carry no straggler "
                  "cost — use --synthetic for the modeled cost, or run "
                  "multi-process (--distributed)", file=self.err)
        # the ingest hook: the chaos wrapper inside (hook_fail faults
        # raise through it, even with no real ingest configured), the
        # tracer outermost (an injected failure is an error span)
        hook = on_rotate
        if self.injector is not None and self.fires_ingest:
            hook = self.injector.wrap_hook(hook)
        hook = self.tracer.wrap_hook(hook)
        self.log: RotatingCsvLog | None = None
        self.ext_log: RotatingCsvLog | None = None
        if opts.logfolder:
            # ingest fires off the legacy log's rotation only: one
            # rotation, one ingest pass
            self.log = RotatingCsvLog(
                opts.logfolder, opts.uuid, self.rank,
                refresh_sec=opts.log_refresh_sec, clock=clock,
                prefix=LEGACY_PREFIX, on_rotate=hook,
                tee=self.pusher.tee_for(LEGACY_PREFIX))
            self.ext_log = RotatingCsvLog(
                opts.logfolder, opts.uuid, self.rank,
                refresh_sec=opts.log_refresh_sec, clock=clock,
                prefix=EXT_PREFIX, tee=self.pusher.tee_for(EXT_PREFIX))
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
        # runs dropped (a slope sample lost to noise, a drop_run fault),
        # over the whole job
        self.dropped = 0
        self._hook_failures_seen = 0  # polled to emit hook_fail events
        # the overlapped sweep's self-audit (--streams K): window_s sums
        # the lanes' dispatch-to-fence windows, wall_s the waves' host
        # walls; with lanes really in flight together window_s > wall_s
        self.stream_totals = {"k": opts.streams, "waves": 0,
                              "window_s": 0.0, "wall_s": 0.0}
        # (op, nbytes) -> recorded runs in the current heartbeat window
        self._window_points: dict[tuple[str, int], int] = {}
        if opts.group1_file:
            self._validate_group_file(opts.group1_file)
        # the harness' own phases: compile / measure / log seconds, the
        # precompile worker's builds added from its thread
        self.phases = PhaseTimer(perf_clock=perf_clock)
        self._recorded = 0  # runs recorded, dropped ones included
        self._adaptive_cfg = self._adaptive_config()
        # runs_attempted is budget consumed (recorded + dropped); the rows'
        # runs_taken counts recorded samples only
        self.adaptive_totals = {
            "points": 0, "runs_requested": 0, "runs_attempted": 0,
            "runs_saved": 0, "wall_saved_s": 0.0,
        }
        # the last completed point's achieved CI (the exporter's gauge)
        self._adaptive_last_ci = 0.0
        # the health monitor (--health): events to the health-*.log
        # family, gauges to a Prometheus textfile from rank 0 alone
        self.health = None
        if opts.health:
            from tpu_perf_torch.health import HealthConfig, HealthMonitor

            event_log = None
            if opts.logfolder:
                event_log = RotatingCsvLog(
                    opts.logfolder, opts.uuid, self.rank,
                    refresh_sec=opts.log_refresh_sec, clock=clock,
                    prefix=HEALTH_PREFIX, lazy=True,
                    tee=self.pusher.tee_for(HEALTH_PREFIX))
            self.health = HealthMonitor(
                HealthConfig(threshold=opts.health_threshold,
                             warmup=opts.health_warmup),
                job_id=opts.uuid, dtype=opts.dtype, rank=self.rank,
                stats_every=opts.stats_every, event_log=event_log,
                textfile=opts.health_textfile if self.rank == 0 else None,
                err=self.err, phase_source=self.phases.snapshot,
                adaptive_source=lambda: (
                    dict(self.adaptive_totals,
                         last_ci_rel=self._adaptive_last_ci)
                    if self._adaptive_cfg is not None else None),
                push_source=lambda: (self.pusher.totals()
                                     if self.pusher.enabled else None))
        # the fused fence's chunk plan, decided once for the job so every
        # rank of a world walks the same dispatches
        self._fused_plan: tuple[int, ...] | None = None
        if opts.fence == "fused":
            cfg = self._adaptive_cfg
            self._fused_plan = (1,) if opts.infinite else fused_plan_for(
                opts, budget=cfg.max_runs if cfg is not None else None,
                min_runs=cfg.min_runs if cfg is not None else None)
        self.fused_totals = {"points": 0, "measure_dispatches": 0, "runs": 0}
        # --precompile auto: the look-ahead follows the phase ratio, its
        # cap the card's free memory
        self._pipe_tuner = None
        if opts.precompile_auto:
            from tpu_perf_torch.adaptive import PrecompileTuner, hbm_depth_cap

            cap = hbm_depth_cap(self._max_point_bytes(),
                                device=self.world.device)
            if cap != 8:
                print(f"[tpu-perf-torch] precompile auto: depth cap {cap} "
                      "from the card's free memory", file=self.err)
            self._pipe_tuner = PrecompileTuner(initial=opts.precompile,
                                               max_depth=cap)

    def _adaptive_config(self):
        """The job's early-stop policy under ``--ci-rel``, or None: bypassed
        (and said so) where an early stop cannot apply."""
        opts = self.opts
        if opts.ci_rel is None:
            return None
        budget = opts.max_runs or opts.num_runs
        bypass = None
        if self.injector is not None:
            bypass = ("--faults/--synthetic (a fixed run sequence keeps "
                      "the chaos ledger byte-identical)")
        elif opts.infinite:
            bypass = ("daemon mode (one run a point a cycle; no per-point "
                      "budget to trim)")
        elif opts.fence == "trace":
            bypass = ("the trace fence (a point's leg graphs are captured "
                      "once for its whole budget; --fence fused stops "
                      "early a chunk at a time)")
        elif opts.streams > 1:
            bypass = ("overlapped dispatch (--streams: one lane stopping "
                      "early would break the wave's fence order across "
                      "ranks)")
        elif opts.extern_cmd:
            bypass = "extern mode (a print-only run measures no kernel)"
        elif budget <= opts.min_runs:
            bypass = (f"a budget of {budget} run(s) (not above --min-runs "
                      f"{opts.min_runs}: nothing to save)")
        if bypass is not None:
            print(f"[tpu-perf-torch] adaptive sampling (--ci-rel) bypassed "
                  f"under {bypass}: fixed budget", file=self.err)
            return None
        from tpu_perf_torch.adaptive import AdaptiveConfig

        cfg = AdaptiveConfig(ci_rel=opts.ci_rel,
                             confidence=opts.ci_confidence,
                             min_runs=opts.min_runs, max_runs=budget,
                             statistic=opts.ci_statistic)
        return without_p50(cfg, self.err) if opts.fence == "fused" else cfg

    def _max_point_bytes(self) -> int:
        """The largest point the sweep holds, the unit the memory cap
        divides the free memory by."""
        try:
            return max(nbytes for op in ops_for_options(self.opts)
                       for nbytes in sizes_for(self.opts, op))
        except ValueError:
            # a bad family fails later, on the build path, with its own
            # error
            return self.opts.buff_sz

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
        plan = self._plan()
        streams = self.opts.streams
        if streams > 1 and self.injector is not None:
            # the ledger's byte-identity is defined over the serial
            # dispatch sequence
            print("[tpu-perf-torch] overlapped dispatch (--streams) "
                  "bypassed under --faults/--synthetic: the chaos ledger's "
                  "a/b byte-identity is defined over the serial dispatch "
                  "sequence", file=self.err)
            streams = 1
        self.phases.start()
        pipeline = None
        if self.opts.precompile > 0 and not self.opts.extern_cmd:
            # one worker builds the host half of the next `precompile`
            # points while this thread measures
            pipeline = CompilePipeline(
                prepare, [self._spec(op, nbytes, algo, imb)
                          for op, algo, nbytes, imb in _builds(plan)],
                depth=self.opts.precompile, phases=self.phases,
                tracer=self.tracer, err=self.err)
        self._pipeline = pipeline
        completed = False
        try:
            # job -> sweep, the root of the span tree; worker builds (no
            # stack of their own) parent to the sweep span
            with self.tracer.span("job", op=self.opts.op,
                                  backend=self.opts.backend):
                with self.tracer.span("sweep", points=len(plan),
                                      infinite=self.opts.infinite) as sweep:
                    self.tracer.set_anchor(sweep or None)
                    if self.opts.infinite:
                        self._run_daemon(plan)
                    elif streams > 1:
                        self._run_overlapped(plan, streams)
                    else:
                        for build, skews in _builds(plan).items():
                            self._run_finite(*build, skews)
            completed = True
        finally:
            if pipeline is not None:
                pipeline.close()
            if self.log is not None:
                self.log.close()
            if self.ext_log is not None:
                self.ext_log.close()
            if self.health is not None:
                # the final partial window judged, the gauges flushed
                self.health.close()
            if self.injector is not None:
                if completed and self.rank == 0:
                    # an aborted soak's corrupt faults go unverified, and
                    # conformance reports them missed
                    try:
                        self._run_corrupt_selftest()
                    except Exception as e:  # noqa: BLE001
                        print(f"[tpu-perf-torch chaos] corrupt-payload "
                              f"selftest failed to run: {e}", file=self.err,
                              flush=True)
                self.injector.close()
            # after every record producer closed (their last writes tee),
            # before the tracer closes (the final flush emits push spans)
            self.pusher.close()
            self.tracer.close()
            self.phases.stop()
            self._write_phases()
        return self.result_rows

    def _run_corrupt_selftest(self) -> None:
        """The corrupt faults' verification: the selftest of each named op
        with the injector's bit flip on the host copy of its output; the
        read-back validation must FAIL.  The verdicts go to the ledger
        for `chaos verify`.  A distributed world's rank 0 runs it in a
        sim world of as many ranks on its own card (no peer takes part)."""
        ops = self.injector.corrupt_ops()
        if not ops:
            return
        from tpu_perf_torch.selftest import format_results, run_selftest
        from tpu_perf_torch.world import SimWorld

        world = (SimWorld(self.world.n, self.world.device)
                 if is_dist(self.world) else self.world)
        results = run_selftest(world, ops=ops, dtype=self.opts.dtype,
                               injector=self.injector)
        self.injector.record_selftest(results)
        print("[tpu-perf-torch chaos] corrupt-payload selftest:\n"
              + format_results(results), file=self.err, flush=True)

    def _plan(self) -> list[tuple[str, str, int, int, int]]:
        """The job's points as ``(op, algo, nbytes, imbalance, skew_us)``,
        op-major: each op's decompositions (``--algo``), each one's sizes,
        each size's imbalance ratios (a build coordinate), each ratio's
        arrival spreads (``--skew-spread``, the innermost: a skewed point
        runs the synchronized point's build).  Under ``--algo auto`` the
        artifact's winner may change with the point, so the walk is
        op-major, then size, ratio and the winning algorithms
        (:meth:`_auto_plan`)."""
        n_coll = self.world.n
        mesh_axes = self._collective_mesh_axes()
        skews = tuple(self.opts.skew_spread) or (0,)
        ratios = tuple(self.opts.imbalance) or (1,)
        if self.opts.algo == "auto":
            return self._auto_plan(n_coll, mesh_axes, skews, ratios)
        plan = []
        for op in ops_for_options(self.opts):
            for algo in algos_for_options(self.opts, op, n_coll,
                                          err=self.err, mesh_axes=mesh_axes):
                point_ratios = ratios
                if op == "scenario" and any(r > 1 for r in ratios):
                    from tpu_perf_torch.scenarios.compose import (
                        spec_for_label,
                    )

                    spec = spec_for_label(self.opts.scenario, algo)
                    if not spec.uses_imbalance:
                        print(f"[tpu-perf-torch] scenario {spec.name} has "
                              f"no v-variant phase: measuring the balanced "
                              f"point only (the imbalance axis applies to "
                              f"its v-variant peers)", file=self.err)
                        point_ratios = (1,)
                for nbytes in sizes_for(self.opts, op):
                    for imb in point_ratios:
                        for skew_us in skews:
                            plan.append((op, algo, nbytes, imb, skew_us))
        return plan

    def _auto_plan(self, n_coll: int, mesh_axes, skews: tuple[int, ...],
                   ratios: tuple[int, ...]
                   ) -> list[tuple[str, str, int, int, int]]:
        """``--algo auto``'s plan.  The selection artifact is loaded ONCE,
        here: staleness and fingerprint foreignness are judged at load
        (the only wall-clock read, and only under --tune-max-age), so
        every per-point resolve is a static lookup and the same artifact
        bytes give the same plan on every rank.  Each (op, size, ratio)
        point groups its arrival spreads by the algorithm that won them:
        one entry a winning algorithm and spread, measured only at the
        spreads it won."""
        import time as _time

        from tpu_perf_torch.tuner import current_device_kind, load_artifact

        selection = load_artifact(
            self.opts.algo_artifact, n_devices=n_coll,
            device_kind=current_device_kind(),
            max_age_sec=self.opts.tune_max_age,
            now=_time.time() if self.opts.tune_max_age else None,
            err=self.err)
        plan = []
        for op in ops_for_options(self.opts):
            if op == "scenario" and any(r > 1 for r in ratios):
                for spec in self.opts.scenario:
                    if not spec.uses_imbalance:
                        print(f"[tpu-perf-torch] scenario {spec.name} has "
                              f"no v-variant phase: measuring the balanced "
                              f"point only (the imbalance axis applies to "
                              f"its v-variant peers)", file=self.err)
            for nbytes in sizes_for(self.opts, op):
                for imb in ratios:
                    by_algo: dict[str, list[int]] = {}
                    for skew_us in skews:
                        for algo in algos_for_options(
                                self.opts, op, n_coll, err=self.err,
                                mesh_axes=mesh_axes, nbytes=nbytes,
                                skew_us=skew_us, imbalance=imb,
                                selection=selection):
                            by_algo.setdefault(algo, []).append(skew_us)
                    for algo, sks in by_algo.items():
                        if op == "scenario" and imb > 1:
                            from tpu_perf_torch.scenarios.compose import (
                                spec_for_label,
                            )

                            if not spec_for_label(self.opts.scenario,
                                                  algo).uses_imbalance:
                                continue
                        plan.extend((op, algo, nbytes, imb, sk)
                                    for sk in sks)
        return plan

    def _collective_mesh_axes(self) -> tuple[tuple[str, int], ...]:
        """The collective mesh-axis tuple as (name, size) pairs: the
        hierarchical algorithms' coordinate."""
        mesh = self.world.mesh
        if mesh is None:
            return (("x", self.world.n),)
        return tuple((a, mesh.axis_size(a)) for a in mesh.axis_names)

    def _spec(self, op: str, nbytes: int, algo: str = "native",
              imbalance: int = 1) -> CompileSpec:
        """A point's build identity, the pipeline's key."""
        kind = "dist" if is_dist(self.world) else "sim"
        return CompileSpec.make(
            op, nbytes, self.opts.iters, dtype=self.opts.dtype,
            window=self.opts.window, fused=self._fused_plan or (),
            algo=algo, imbalance=imbalance,
            world=f"{kind}/{self.world.n}/{self.world.device.type}")

    def _point(self, op: str, nbytes: int, world=None, algo: str = "native",
               imbalance: int = 1):
        """One ready-to-warm point: its host half from the pipeline when
        one runs (the wait for it is not compile work: the worker charged
        its build), then the build on this thread, charged to compile."""
        if self._pipeline is not None:
            self._pipeline.get(self._spec(op, nbytes, algo, imbalance))
        with self.phases.phase("compile"), \
                self.tracer.span("build", op=op, nbytes=nbytes):
            return self._build(op, nbytes, world, algo, imbalance)

    def _tune_precompile(self) -> None:
        """--precompile auto: fold the cumulative phase ratio into the
        pipeline's depth after a point."""
        if self._pipeline is None or self._pipe_tuner is None:
            return
        snap = self.phases.snapshot()
        depth = self._pipe_tuner.update(snap["compile_s"], snap["measure_s"])
        if depth != self._pipeline.depth:
            print(f"[tpu-perf-torch] precompile auto: look-ahead depth -> "
                  f"{depth} (compile {snap['compile_s']:.3f}s / measure "
                  f"{snap['measure_s']:.3f}s)", file=self.err)
            self._pipeline.set_depth(depth)

    def _write_phases(self) -> None:
        """The ``phase-<job>-<rank>.json`` sidecar beside the logs: the
        phase totals and wall clock, the pipeline's depth, the fused fence's
        dispatch audit, the adaptive totals, the lanes' totals and the
        kernel builds this process ran.  Written atomically (a temporary
        file, then ``os.replace``) once a run was recorded (a job that
        fails before its first run leaves its folder empty); a failed
        write is said, never fatal."""
        if not self.opts.logfolder or not self._recorded:
            return
        from tpu_perf_torch.kernels import _build

        path = os.path.join(self.opts.logfolder,
                            f"phase-{self.opts.uuid}-{self.rank}.json")
        data = {
            "job_id": self.opts.uuid,
            "rank": self.rank,
            "backend": self.world.backend,
            "op": self.opts.op,
            "precompile": ("auto" if self.opts.precompile_auto
                           else self.opts.precompile),
            "wall_s": round(self.phases.wall_s, 6),
            "phase": self.phases.snapshot(),
            "kernel_builds": _build.BUILDS,
        }
        if self._pipe_tuner is not None:
            data["precompile_depth"] = self._pipe_tuner.depth
        if self.opts.fence == "fused":
            data["fused"] = dict(self.fused_totals,
                                 plan=list(self._fused_plan or ()),
                                 trace=False)
        if self._adaptive_cfg is not None:
            data["adaptive"] = self._adaptive_snapshot()
        if self.stream_totals["waves"]:
            data["streams"] = {k: (round(v, 6) if isinstance(v, float) else v)
                               for k, v in self.stream_totals.items()}
        if self.pusher.enabled:
            # written after pusher.close(): the job's final counters
            data["push"] = self.pusher.totals()
        try:
            os.makedirs(self.opts.logfolder, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(data, fh, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, path)
        except OSError as e:
            print(f"[tpu-perf-torch] phase sidecar write failed: {e}",
                  file=self.err)

    def _adaptive_snapshot(self) -> dict:
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in self.adaptive_totals.items()}

    def _note_adaptive_point(self, built, controller) -> None:
        """Fold a finished point's controller verdict into the job's
        totals, and say what it saved."""
        s = controller.summary()
        self._adaptive_last_ci = s["ci_rel"] or 0.0
        self.adaptive_totals["points"] += 1
        self.adaptive_totals["runs_requested"] += s["requested"]
        self.adaptive_totals["runs_attempted"] += s["attempted"]
        self.adaptive_totals["runs_saved"] += s["saved"]
        # the runs not taken would have cost about the point's mean each
        self.adaptive_totals["wall_saved_s"] += \
            s["saved"] * (controller.welford.mean if s["taken"] else 0.0)
        if s["saved"] > 0:
            ci = "n/a" if s["ci_rel"] is None else f"{s['ci_rel']:.2%}"
            print(f"[tpu-perf-torch] adaptive: {built.name}/{built.nbytes} "
                  f"stopped after {s['attempted']}/{s['requested']} runs "
                  f"(ci_rel {ci} <= target {self._adaptive_cfg.ci_rel:.2%})",
                  file=self.err)

    def _build(self, op: str, nbytes: int, world=None, algo: str = "native",
               imbalance: int = 1):
        """One point's (built, built_hi) pair in ``world`` (the job's by
        default); extern builds nothing."""
        if op == "extern":
            return _ExternOp("extern", nbytes, self.opts.iters,
                             self.world.n), None
        return build_point_pair(self.opts, world or self.world, op, nbytes,
                                fused_plan=self._fused_plan, algo=algo,
                                imbalance=imbalance)

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
        with self.tracer.span("warmup", op=built.name, nbytes=built.nbytes):
            fmode = "readback" if built_hi is not None else self.opts.fence
            for _ in range(max(1, self.opts.warmup_runs)):
                fence(built.step(built.example_input), fmode)
                if built_hi is not None:
                    fence(built_hi.step(built_hi.example_input), fmode)
            if self.opts.measure_dispatch and built_hi is None:
                # once a point, after the warm-up, outside every timed
                # window, fenced as the samples are; slope rows skip it
                # (the slope cancels constant costs)
                self._overhead_s[(built.name, built.nbytes)] = \
                    measure_overhead(built.example_input, fence_mode=fmode)

    def _measure(self, built: BuiltOp, built_hi) -> float | None:
        """One run's wall time for `iters` executions under opts.fence;
        None when a slope sample is lost to timing noise.  Under
        ``--synthetic`` the injector's seeded series replaces the sample
        (the point was still built and warmed on the device)."""
        if self.injector is not None and self.injector.synthetic:
            return self.injector.synthetic_sample(built.name, built.nbytes)
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
            self.fused_totals["measure_dispatches"] += 1
            self.fused_totals["runs"] += 1
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
        out = built.step(built.example_input)
        # the fence wait as its own span; its record is written after the
        # window's end read, so the write never enters the sample
        with self.tracer.span("fence", defer=True, mode=self.opts.fence):
            fence(out, self.opts.fence)
        t = self.perf_clock() - t0
        self.tracer.flush()
        return t

    def _entry_skew(self, built, run_id: int,
                    skew_us: int) -> tuple[float, float]:
        """One run's total arrival skew at the entry boundary,
        ``(own_stagger_s, victim_cost_s)``: the sweep axis's arrivals
        (``skew_us``, :func:`~tpu_perf_torch.faults.injector.
        axis_arrivals_us`, drawn over the real ranks, the last one the
        straggler) and any scheduled ``skew`` faults' (drawn over the
        injector's fault world), summed rank by rank before the worst is
        taken: two sources' worst arrivals can land on different ranks,
        so their costs do not add, their arrivals do.  Both are seeded,
        so every rank computes every rank's arrival without a message."""
        from tpu_perf_torch.faults.injector import (
            axis_arrivals_us, reduce_arrivals, skew_world,
        )

        totals: dict[int, float] = {}
        if skew_us:
            axis_us = axis_arrivals_us(
                self.opts.fault_seed, built.name, built.nbytes, skew_us,
                run_id, world=skew_world(self.n_hosts, self.rank))
            for r, v in axis_us.items():
                totals[r] = totals.get(r, 0.0) + v
        if self.injector is not None and self.injector.has_skew():
            fault_us = self.injector.skew_arrivals_us(
                built.name, built.nbytes, run_id,
                world=self.injector.skew_fault_world(
                    self.n_hosts, built.name, built.nbytes, run_id))
            if fault_us is not None:
                for r, v in fault_us.items():
                    totals[r] = totals.get(r, 0.0) + v
        if not totals:
            return 0.0, 0.0
        return reduce_arrivals(totals, self.rank)

    def _measure_skewed(self, built, built_hi, run_id: int,
                        skew_us: int = 0) -> float | None:
        """One measured run with a staggered entry: this rank sleeps its
        arrival (the ``--skew-spread`` axis's and any ``skew`` fault's,
        :meth:`_entry_skew`) before the dispatch, so the collective really
        sees imbalanced arrival, then measures from its own entry.  In a
        multi-process world the ranks that wait carry the straggler's
        lateness in their samples (inside the graph's events under the
        fused fence); the synthetic source has no peers, so the modeled
        wait is added to its sample instead.  A fired skew injection is
        an ``inject`` span over the stagger."""
        if skew_us == 0 and (self.injector is None
                             or not self.injector.has_skew()):
            return self._measure(built, built_hi)
        fired0 = self.injector.fired_total if self.injector else 0
        t0 = self.tracer.now() if self.tracer.enabled else 0
        own, cost = self._entry_skew(built, run_id, skew_us)
        synthetic = self.injector is not None and self.injector.synthetic
        if own > 0.0 and not synthetic:
            time.sleep(own)
        if (self.tracer.enabled and self.injector is not None
                and self.injector.fired_total > fired0):
            self.tracer.emit(
                "inject", t0, self.tracer.now() - t0, run_id=run_id,
                op=built.name, fired=self.injector.fired_total - fired0,
                skew=True)
        t = self._measure(built, built_hi)
        if t is not None and cost > 0.0 and synthetic:
            t += cost
        return t

    def _profile(self, built: BuiltOp):
        """The point's measured window, kept as a trace under
        --profile-dir."""
        return profile_window(self.opts.profile_dir,
                              f"{built.name}-{built.nbytes}",
                              built.example_input.device)

    def _run_finite(self, op: str, algo: str, nbytes: int, imbalance: int,
                    skews: tuple[int, ...] = (0,)) -> None:
        """One build point, measured once per arrival spread."""
        built, built_hi = self._point(op, nbytes, algo=algo,
                                      imbalance=imbalance)
        extern = isinstance(built, _ExternOp)
        fused = isinstance(built_hi, FusedPoint)
        trace = self.opts.fence == "trace" and not extern
        if not (extern or fused or trace):
            # the fused runner and the trace capture warm themselves
            with self.phases.phase("compile"):
                self._warm(built, built_hi)
        for skew_us in skews:
            with self.tracer.span("point", op=op, nbytes=nbytes,
                                  **_coords(built, skew_us)):
                self._measure_point(built, built_hi, extern=extern,
                                    fused=fused, trace=trace,
                                    skew_us=skew_us)
        self._tune_precompile()

    def _measure_point(self, built, built_hi, *, extern: bool, fused: bool,
                       trace: bool, skew_us: int = 0) -> None:
        """One finite point: every run measured, then every run recorded
        (after the point's last fence, each time its maximum over the
        ranks).  A run of the per-run fences is a ``run`` span around its
        measure, whose id its row and events carry; the fused and trace
        fences' run spans are laid out at the record, from the runs'
        device times (fused) or around the record (trace)."""
        controller = None
        if self._adaptive_cfg is not None and not extern:
            controller = point_controller(self._adaptive_cfg, self.world)
        # the controller's state as of each run: (requested, taken, ci_rel)
        states: list[tuple] = []
        span_ids: list[str] = []  # each per-run-fence run's span
        starts: list[tuple[float, int]] = []  # fused: (chunk start, reps)
        if fused:
            # the whole budget in one graph replay a chunk (a chunk a stop
            # vote under --ci-rel), per-run device times from the events
            # inside the graph
            times = run_point_fused(
                self.opts, built, built_hi, perf_clock=self.perf_clock,
                controller=_Recording(controller, states)
                if controller is not None else None,
                phases=self.phases, tracer=self.tracer, starts=starts
            ).samples
            self.fused_totals["points"] += 1
            self.fused_totals["runs"] += len(times)
            self.fused_totals["measure_dispatches"] += _chunks_for(
                built_hi.plan, len(times))
        elif trace:
            # one batch of leg graphs covers the point's whole budget
            with self.phases.phase("measure"), self._profile(built), \
                    self.tracer.span("measure", op=built.name,
                                     nbytes=built.nbytes):
                per_exec = time_trace(built.step, built_hi.step,
                                      built.example_input, built.iters,
                                      built_hi.iters, self.opts.num_runs,
                                      warmup_runs=self.opts.warmup_runs,
                                      align=trace_align(self.world))
            times = [t * built.iters for t in per_exec.samples]
        else:
            budget = (self._adaptive_cfg.max_runs if controller is not None
                      else self.opts.num_runs)
            times = []
            with (contextlib.nullcontext() if extern
                  else self._profile(built)):
                while len(times) < budget:
                    run_id = len(times) + 1
                    with self.tracer.run_span(run_id, op=built.name,
                                              nbytes=built.nbytes) as sid:
                        with self.phases.phase("measure"), \
                                self.tracer.span("measure", run_id=run_id):
                            t = self._measure_skewed(built, built_hi, run_id,
                                                     skew_us)
                        span_ids.append(sid)
                        times.append(t)
                        stop = False
                        if controller is not None:
                            # after the run's fence, outside its window:
                            # every rank observes and votes after every
                            # run
                            controller.observe(t)
                            states.append(_state(controller))
                            stop = controller.should_stop(
                                len(times), tracer=self.tracer)
                    if stop:
                        break
        geometry = (_fused_geometry(starts, times)
                    if fused and self.tracer.enabled else None)
        # after the point's last fence, outside every timed window
        window: list[float] = []
        for run_id, t in enumerate(max_over_ranks(self.world, times),
                                   start=1):
            if t is None:
                print(f"[tpu-perf-torch] run {run_id}: slope sample lost "
                      "to noise, skipped", file=self.err)
            record = dict(adaptive=states[run_id - 1] if states else None)
            if trace:
                with self.tracer.run_span(run_id, op=built.name,
                                          nbytes=built.nbytes) as sid:
                    self._record_run(built, run_id, t, window, span_id=sid,
                                     skew_us=skew_us, **record)
                continue
            if span_ids:
                sid = span_ids[run_id - 1]
            elif geometry is not None:
                sid = self.tracer.emit_run(run_id, *geometry[run_id - 1],
                                           op=built.name, nbytes=built.nbytes)
            else:
                sid = ""
            self._record_run(built, run_id, t, window, span_id=sid,
                             skew_us=skew_us, **record)
        if controller is not None:
            self._note_adaptive_point(built, controller)

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
        for w, wave in enumerate(wave_plan(list(_builds(plan)), k)):
            lanes = []
            for lane, (op, algo, nbytes, imb) in wave:
                built, built_hi = self._point(op, nbytes, worlds[lane],
                                              algo=algo, imbalance=imb)
                with self.phases.phase("compile"):
                    self._warm(built, built_hi)
                lanes.append((lane, built))
            engine = StreamEngine(len(lanes), fence_mode=self.opts.fence,
                                  tracer=self.tracer,
                                  perf_clock=self.perf_clock)
            windows: dict[int, list[float]] = {lane: [] for lane, _ in lanes}
            self.stream_totals["waves"] += 1
            with profile_window(self.opts.profile_dir, f"streams{k}-wave{w}",
                                self.world.device), \
                    self.tracer.span("point", streams=len(lanes),
                                     ops=",".join(b.name for _, b in lanes)):
                for run_id in range(1, self.opts.num_runs + 1):
                    t0 = self.perf_clock()
                    with self.phases.phase("measure"), \
                            self.tracer.span("measure", run_id=run_id,
                                             streams=len(lanes)):
                        for lane, built in lanes:
                            engine.dispatch(lane, built.step,
                                            built.example_input,
                                            label=built.name)
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
            self._tune_precompile()

    def _run_daemon(self, plan: list[tuple]) -> None:
        """Infinite monitoring: one measured run per visit, round-robin
        over every point of the plan (an arrival spread of a build is a
        point of its own on the same warmed build), so a family
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
        resident = []  # each build once, whatever its spreads
        for (op, algo, nbytes, imb), skews in _builds(plan).items():
            built, built_hi = self._point(op, nbytes, algo=algo,
                                          imbalance=imb)
            self._tune_precompile()
            if isinstance(built, _ExternOp):
                resident.append((built, None))
                points += [(built, None, skew_us) for skew_us in skews]
                continue
            x = built.example_input
            keep = canon.setdefault((tuple(x.shape), x.dtype, x.device), x)
            if keep is not x:
                built = dataclasses.replace(built, example_input=keep)
                if isinstance(built_hi, BuiltOp):
                    built_hi = dataclasses.replace(built_hi,
                                                   example_input=keep)
                del x
            with self.phases.phase("compile"):
                if isinstance(built_hi, FusedPoint):
                    built_hi = FusedRunner(built_hi, built,
                                           perf_clock=self.perf_clock)
                    with self.tracer.span("warmup", op=built.name,
                                          nbytes=built.nbytes, fused=True):
                        built_hi.warm()
                    self.fused_totals["points"] += 1
                elif self.opts.fence == "trace":
                    built_hi = TraceRunner(built.step, built_hi.step, keep,
                                           built.iters, built_hi.iters,
                                           align=trace_align(self.world))
                    with self.tracer.span("warmup", op=built.name,
                                          nbytes=built.nbytes):
                        built_hi.warm(self.opts.warmup_runs)
                else:
                    self._warm(built, built_hi)
            resident.append((built, built_hi))
            points += [(built, built_hi, skew_us) for skew_us in skews]
        self._print_residency(resident, len(canon))
        window: list[float] = []
        run_id = 0
        while self.opts.max_runs is None or run_id < self.opts.max_runs:
            run_id += 1
            built, built_hi, skew_us = points[(run_id - 1) % len(points)]
            with self.tracer.run_span(run_id, op=built.name,
                                      nbytes=built.nbytes) as sid:
                with self.phases.phase("measure"), \
                        self.tracer.span("measure", run_id=run_id):
                    t = self._measure_skewed(built, built_hi, run_id,
                                             skew_us)
                self._record_run(built, run_id,
                                 max_over_ranks(self.world, [t])[0], window,
                                 span_id=sid, skew_us=skew_us)

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
            held.append(f"{_op_label(built)}/{built.nbytes}={nb}")
        print(f"[tpu-perf-torch] daemon: {len(points)} points, {n_inputs} "
              f"input buffer(s); bytes each point holds (input, and its "
              f"working copy under fused or its graphs' pool under trace): "
              f"{', '.join(held) or 'none'}", file=self.err, flush=True)

    def _record_run(self, built: BuiltOp, run_id: int, t: float | None,
                    window: list[float], *, stream: int = 0,
                    adaptive: tuple | None = None,
                    span_id: str = "", skew_us: int = 0) -> None:
        """One run's bookkeeping (injection, rotation, emission, health,
        the heartbeat boundary), charged to the log phase.  ``adaptive``
        is the controller's (requested, taken, ci_rel) as of this run,
        stamped into the row; ``span_id`` (the run's span, --spans) is
        stamped into the row and any health event the run raises;
        ``skew_us`` (the arrival-spread coordinate) is stamped into the
        row and folded into the health and heartbeat label
        (:func:`_op_label`)."""
        self._recorded += 1
        with self.phases.phase("log"):
            self._record_run_inner(built, run_id, t, window, stream,
                                   adaptive, span_id, skew_us)

    def _record_run_inner(self, built, run_id: int, t: float | None,
                          window: list[float], stream: int,
                          adaptive: tuple | None, span_id: str,
                          skew_us: int = 0) -> None:
        if self.injector is not None:
            # the injection point: the sample is perturbed (or dropped)
            # before anything sees it, as a sick link would feed them
            fired0 = self.injector.fired_total
            t0 = self.tracer.now() if self.tracer.enabled else 0
            t = self.injector.apply(built.name, built.nbytes, run_id, t)
            if self.tracer.enabled and self.injector.fired_total > fired0:
                self.tracer.emit(
                    "inject", t0, self.tracer.now() - t0, run_id=run_id,
                    op=built.name, fired=self.injector.fired_total - fired0)
        rot0 = self.tracer.now() if self.tracer.enabled else 0
        rotated = False
        if self.log is not None:
            rotated = self.log.maybe_rotate()
            if (self.injector is not None
                    and self.injector.take_forced_rotation() and not rotated):
                # a hook_fail fault forces its rotation at its window's
                # first run, whatever the refresh period
                rotated = self.log.rotate_now()
            if self.log.hook_failures > self._hook_failures_seen:
                self._hook_failures_seen = self.log.hook_failures
                if self.health is not None:
                    # a failing telemetry upload is degradation too
                    self.health.observe_hook_fail(run_id, span_id=span_id)
        if self.ext_log is not None:
            self.ext_log.maybe_rotate()
        if self.health is not None:
            self.health.maybe_rotate()
        if self.injector is not None:
            self.injector.maybe_rotate()
        self.tracer.maybe_rotate()
        if self.tracer.enabled and rotated:
            # the rotation that fired the ingest pass; the hook's own run
            # is a nested ingest_hook span (tracer.wrap_hook)
            self.tracer.emit("rotate", rot0, self.tracer.now() - rot0,
                             run_id=run_id)
        label = _op_label(built, skew_us)
        if t is not None:
            window.append(t)
            key = (label, built.nbytes)
            self._window_points[key] = self._window_points.get(key, 0) + 1
            self._emit(built, run_id, t, stream=stream, adaptive=adaptive,
                       span_id=span_id, skew_us=skew_us)
            if self.health is not None:
                # keyed on the decorated label: algorithms, spreads and
                # ratios run apart by design, so one baseline each
                self.health.observe(label, built.nbytes, built.iters,
                                    built.n_devices, run_id, t,
                                    span_id=span_id)
        else:
            self.dropped += 1
            if self.health is not None:
                self.health.observe_drop(label, run_id)
        if run_id % self.opts.stats_every == 0:
            # in a multi-process world the boundary's allreduce is a
            # barrier, so every rank's heartbeat span ends together
            with self.tracer.span(
                    "heartbeat", run_id=run_id,
                    window=window_index(run_id, self.opts.stats_every),
                    collective=self.n_hosts > 1):
                self._heartbeat(run_id, window)
            if self.health is not None:
                # capture loss over the window's drops, the gauges
                # refreshed
                self.health.heartbeat(run_id)
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
                # the harness' own phases so far: compile is compile
                # work, the precompile worker's overlapped share included
                "phase": self.phases.snapshot(),
                "points": {
                    f"{op}/{nbytes}": n
                    for (op, nbytes), n in sorted(self._window_points.items())
                },
            }
            if self._adaptive_cfg is not None:
                # the completed points' savings so far
                data["adaptive"] = self._adaptive_snapshot()
            if self.pusher.enabled:
                # the push plane's counters: where a collector learns the
                # live plane itself is losing records
                data["push"] = self.pusher.totals()
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
              stream: int = 0, adaptive: tuple | None = None,
              span_id: str = "", skew_us: int = 0) -> None:
        # a fault soak's rows are deliberately perturbed: mode "chaos"
        # keeps them off the clean curves (report --compare-chaos joins
        # the two)
        mode = ("chaos" if self.injector is not None and self.injector.faults
                else "daemon" if self.opts.infinite else "oneshot")
        point = SweepPointResult(
            op=built.name, nbytes=built.nbytes, iters=built.iters,
            n_devices=built.n_devices,
            times=RunTimes(samples=[t], warmup_s=0.0,
                           overhead_s=self._overhead_s.get(
                               (built.name, built.nbytes), 0.0)),
            dtype=self.opts.dtype, mode=mode,
            algo=getattr(built, "algo", "native"),
            imbalance=getattr(built, "imbalance", 1))
        rrow = point.rows(self.opts.uuid, backend=self.world.backend)[0]
        # span_id "" (tracing off) keeps the row's pre-span width
        rrow = dataclasses.replace(rrow, run_id=run_id, stream=stream,
                                   span_id=span_id, skew_us=skew_us)
        if adaptive is not None:
            # the controller as of this run: a point's last row carries its
            # stop verdict (report's adaptive-savings table reads it)
            requested, taken, ci = adaptive
            rrow = dataclasses.replace(
                rrow, runs_requested=requested, runs_taken=taken,
                ci_rel=0.0 if not math.isfinite(ci) else round(ci, 6))
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


def _coords(built, skew_us: int = 0) -> dict:
    """A point span's coordinates beyond (op, nbytes): the algorithm, the
    imbalance and the arrival spread, each only when not the default."""
    out: dict = {}
    if getattr(built, "algo", "native") != "native":
        out["algo"] = built.algo
    if getattr(built, "imbalance", 1) != 1:
        out["imbalance"] = built.imbalance
    if skew_us:
        out["skew_us"] = skew_us
    return out


def _builds(plan) -> dict[tuple, tuple[int, ...]]:
    """The plan's builds, ``(op, algo, nbytes, imbalance)`` -> the arrival
    spreads each is measured at, in plan order (a skewed point runs the
    synchronized point's build)."""
    out: dict[tuple, tuple[int, ...]] = {}
    for op, algo, nbytes, imb, skew_us in plan:
        key = (op, algo, nbytes, imb)
        out[key] = out.get(key, ()) + (skew_us,)
    return out


def _state(controller) -> tuple:
    """A controller's (requested, taken, ci_rel) now: a row's columns."""
    return controller.requested, controller.taken, controller.ci_rel()


class _Recording:
    """A controller that also keeps its state as of each run, for the
    runs of a fused chunk (every run of a chunk carries the state that
    includes the chunk)."""

    def __init__(self, controller, states: list):
        self._c, self._states = controller, states

    def observe_chunk(self, mean: float, reps: int) -> None:
        self._c.observe_chunk(mean, reps)
        self._states.extend([_state(self._c)] * reps)

    def should_stop(self, runs_done: int, *, tracer=None) -> bool:
        return self._c.should_stop(runs_done, tracer=tracer)


def _fused_geometry(starts: list[tuple[float, int]],
                    times: list[float]) -> list[tuple[int, int]]:
    """Each fused run's (start_ns, dur_ns): the chunk's device times laid
    end to end from the chunk's host start."""
    out: list[tuple[int, int]] = []
    i = 0
    for t0, reps in starts:
        cursor = int(t0 * 1e9)
        for t in times[i:i + reps]:
            dur = int(t * 1e9)
            out.append((cursor, dur))
            cursor += dur
        i += reps
    return out


def _chunks_for(plan: tuple[int, ...], runs: int) -> int:
    """The dispatches a fused point made to take ``runs`` runs of
    ``plan``'s chunks (fewer than the plan's when it stopped early)."""
    done = 0
    for i, reps in enumerate(plan, start=1):
        done += reps
        if done >= runs:
            return i
    return len(plan)
