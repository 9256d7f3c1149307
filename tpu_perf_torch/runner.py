"""Sweep runner: build op -> time -> rows (port of ``tpu_perf/runner.py``).

One sweep point is measured under the configured fence (``auto``
resolved once, by the device); the driver (:mod:`tpu_perf_torch.driver`)
owns logging and the CLI's run loop, finite and daemon.  In a
multi-process world each run's time is its maximum over the ranks
(:func:`max_over_ranks`), so every rank's rows carry the same times.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import (
    alg_bandwidth_gbps, bus_bandwidth_gbps, imbalance_volume_scale,
    is_latency_only, latency_us,
)
from tpu_perf_torch.ops.collectives import (
    DTYPES, BuiltOp, build_fused_step, build_op,
)
from tpu_perf_torch.schema import ResultRow, timestamp_now
from tpu_perf_torch.sweep import parse_sweep
from tpu_perf_torch.timing import (
    SLOPE_ITERS_FACTOR, FusedPoint, FusedRunner, RunTimes, fused_chunk_plan,
    resolve_fence, time_slope, time_step, time_trace,
)
from tpu_perf_torch.traceparse import profile_window
from tpu_perf_torch.world import DistWorld, SimWorld, is_dist, resolve_device

#: ops whose timing covers a round trip (latency convention: one way = t/2)
_ROUND_TRIP_OPS = ("pingpong", "pl_pingpong")

#: ops whose payload is fixed whatever -b / --sweep ask (sweeping them
#: would time the identical kernel once per size)
FIXED_PAYLOAD_OPS = ("barrier", "pl_barrier")


def op_for_options(opts: Options) -> str:
    """The kernel an Options selects, with the reference's precedence
    (mpi_perf.c:504-523: extern > nonblocking > unidir > blocking) when
    ``op`` is the default pingpong; any other op is run as named."""
    if opts.extern_cmd:
        return "extern"
    if "," in opts.op:
        # a family reached a single-kernel path: truncating it to its
        # first op would drop the rest without a word
        raise ValueError(
            f"op family {opts.op!r} is not valid here; this path runs a "
            "single kernel (families are supported by run/monitor)"
        )
    if opts.op != "pingpong":
        return opts.op
    if opts.nonblocking:
        return "exchange"
    if opts.uni_dir:
        return "pingpong_unidir"
    return "pingpong"


def ops_for_options(opts: Options) -> list[str]:
    """All kernels the job runs.  ``--op a,b,c`` names an instrument
    family (the finite run walks it op by op, the daemon round-robins
    over it); a single op keeps the reference's flag precedence.  An
    empty family or an unknown name fails here, before any kernel has
    run: a daemon must not die on its fifth op after four wrote rows."""
    if "," not in opts.op:
        return [op_for_options(opts)]
    from tpu_perf_torch.ops.collectives import known_ops

    ops = [s.strip() for s in opts.op.split(",") if s.strip()]
    if not ops:
        raise ValueError(f"empty op family {opts.op!r}")
    unknown = [o for o in ops if o not in known_ops()]
    if unknown:
        raise ValueError(
            f"unknown op(s) {unknown} in family {opts.op!r}; "
            f"known: {sorted(known_ops())}"
        )
    if opts.extern_cmd:
        raise ValueError("extern mode runs a single op, not a family")
    return ops


def algos_for_options(opts: Options, op: str, n_devices: int, err=None,
                      mesh_axes=None, *, nbytes=None, skew_us=0,
                      imbalance=1, selection=None) -> list[str]:
    """The decompositions the job runs for one kernel (``--algo``), the
    JAX package's expansion.

    ``native`` (the default) keeps the library call alone; ``all``
    expands to native plus every registered arena algorithm compatible
    with this op at this rank count (incompatible pow2-only entries are
    skipped with a note); an explicit name or comma family validates
    strictly: an algorithm the op lacks, an unknown name, or a mesh it
    cannot run on fails here, before any kernel has run.  ``mesh_axes``
    is the collective mesh-axis tuple as (name, size) pairs: on a
    multi-axis mesh ``all`` races native against the keyed ``hier*``
    (``vhier``) compositions; on a single-axis mesh an explicit ``hier*``
    request degrades loudly to native.  For the ``scenario`` op the
    labels are the selected scenarios' (``scenario_algos_for``).

    ``auto`` (the crossover auto-tuner, :mod:`tpu_perf_torch.tuner`)
    resolves the point named by ``nbytes`` / ``skew_us`` / ``imbalance``
    against the loaded ``selection`` artifact: a static plan-time lookup
    (never rank- or clock-conditioned), the nearest measured size
    bucket, falling back loudly to native on a stale, foreign, missing
    or low-margin entry, or on a winner this mesh cannot build.  A
    caller without per-point coordinates fails here, before any kernel
    has run."""
    if opts.algo == "auto":
        return _auto_algos(opts, op, n_devices, err=err,
                           mesh_axes=mesh_axes, nbytes=nbytes,
                           skew_us=skew_us, imbalance=imbalance,
                           selection=selection)
    if op == "scenario":
        from tpu_perf_torch.scenarios.compose import scenario_algos_for

        return scenario_algos_for(opts, n_devices, err=err)
    spec = opts.algo
    if spec == "native":
        return ["native"]
    import sys

    from tpu_perf_torch.arena import (
        ARENA_COLLECTIVES, algos_for_op, arena_body_builder, hierarchy,
        valgos,
    )
    from tpu_perf_torch.scenarios.vops import V_OPS

    multi = mesh_axes is not None and len(mesh_axes) >= 2
    if spec == "all":
        if op in V_OPS:
            if multi:
                return ["native"] + valgos.vhier_algos_for(
                    op, tuple(mesh_axes), err=err)
            return ["native"] + valgos.v_algos_for_op(op, n_devices,
                                                      err=err)
        if op not in ARENA_COLLECTIVES:
            if err is not None:
                print(f"[tpu-perf-torch] arena: {op} has no registered "
                      f"decompositions; running the native call only",
                      file=err)
            return ["native"]
        if multi:
            if err is not None:
                print(f"[tpu-perf-torch] arena: {op} on the multi-axis "
                      f"mesh {tuple(mesh_axes)} races native vs the hier* "
                      f"compositions (the flat single-axis schedules are "
                      f"skipped; name one axis to race them)", file=err)
            return ["native"] + hierarchy.hier_algos_for(
                op, tuple(mesh_axes), err=err)
        return ["native"] + algos_for_op(op, n_devices, err=err)
    algos = [a.strip() for a in spec.split(",") if a.strip()]
    if not algos:
        raise ValueError(f"empty algo family {spec!r}")
    resolved: list[str] = []
    for a in algos:
        if a == "native":
            resolved.append(a)
        elif hierarchy.is_hier(a) or valgos.is_vhier(a):
            if not multi:
                print(f"[tpu-perf-torch] arena: {a} needs a 2-axis "
                      f"(slow, fast) mesh and this job's collective axis "
                      f"is flat; running the native call in its place "
                      f"(--mesh DxI --axes dcn,ici builds the two-axis "
                      f"mesh)", file=err if err is not None else sys.stderr)
                resolved.append("native")
            else:
                names = tuple(n for n, _ in mesh_axes)
                sizes = tuple(s for _, s in mesh_axes)
                resolve = (valgos.resolve_vhier if valgos.is_vhier(a)
                           else hierarchy.resolve_hier)
                resolved.append(resolve(op, a, names, sizes))
        else:
            if multi:
                raise ValueError(
                    f"algo {a!r} is a single-axis flat decomposition "
                    f"and this job's collective axes are "
                    f"{tuple(mesh_axes)}; race hier*/vhier/native on a "
                    f"multi-axis mesh, or name one axis")
            if op in V_OPS:
                valgos.v_body_builder_for(op, a, n_devices)  # raises
            else:
                arena_body_builder(op, a, n_devices)  # raises
            resolved.append(a)
    # a hier -> native fallback can repeat an explicit native: one plan
    # slot per decomposition, the first spelling wins
    out: list[str] = []
    for a in resolved:
        if a not in out:
            out.append(a)
    return out


def _auto_algos(opts: Options, op: str, n_devices: int, *, err,
                mesh_axes, nbytes, skew_us, imbalance,
                selection) -> list[str]:
    """--algo auto's plan-time consultation: the artifact's winner for
    ONE sweep point (one label per selected scenario on the scenario
    op).  A winner the current mesh cannot build falls back loudly to
    native: the artifact was fingerprint-matched at load, so this only
    fires on a hand-edited or cross-tree artifact, but a plan must never
    die (or silently relabel) on one."""
    if selection is None:
        raise ValueError(
            "--algo auto resolves against a loaded selection artifact and "
            "this path did not provide one (load it with "
            "tpu_perf_torch.tuner.load_artifact; run/monitor/chaos/"
            "scenario plans do)")
    if nbytes is None:
        raise ValueError(
            "--algo auto resolves per sweep point and this path plans per "
            "op with no point coordinates; it must pass nbytes/skew_us/"
            "imbalance (run/monitor/chaos/scenario plans do)")
    if op == "scenario":
        from tpu_perf_torch.arena import ALGORITHM_NAMES
        from tpu_perf_torch.arena.algorithms import POW2_ONLY
        from tpu_perf_torch.scenarios.compose import (
            scenario_algo_label, scenario_inner_covered,
        )

        labels = []
        for spec in opts.scenario:
            winner = selection.resolve(
                f"scenario[{spec.name}]", nbytes, opts.dtype,
                skew_us=skew_us, imbalance=imbalance,
                n_devices=n_devices, margin_min=opts.tune_margin, err=err)
            if winner not in ("", "native"):
                pow2_bad = (winner in POW2_ONLY
                            and n_devices & (n_devices - 1))
                if (winner not in ALGORITHM_NAMES
                        or not scenario_inner_covered(spec, winner)
                        or pow2_bad):
                    selection.note_once(
                        ("scenario-unbuildable", spec.name, winner),
                        f"artifact winner {winner!r} is not a usable "
                        f"per-phase inner for scenario {spec.name} at "
                        f"{n_devices} devices: --algo auto runs the "
                        f"native composition there", err)
                    winner = "native"
            labels.append(scenario_algo_label(spec, winner))
        return labels
    from tpu_perf_torch.arena import arena_body_builder, hierarchy, valgos
    from tpu_perf_torch.scenarios.vops import V_OPS

    winner = selection.resolve(
        op, nbytes, opts.dtype, skew_us=skew_us, imbalance=imbalance,
        n_devices=n_devices, margin_min=opts.tune_margin, err=err)
    if winner in ("", "native"):
        return ["native"]
    multi = mesh_axes is not None and len(mesh_axes) >= 2
    try:
        if hierarchy.is_hier(winner) or valgos.is_vhier(winner):
            if not multi:
                raise ValueError(
                    "hier/vhier winner on a flat collective axis")
            names = tuple(n for n, _ in mesh_axes)
            sizes = tuple(s for _, s in mesh_axes)
            if valgos.is_vhier(winner):
                return [valgos.resolve_vhier(op, winner, names, sizes)]
            return [hierarchy.resolve_hier(op, winner, names, sizes)]
        if multi:
            raise ValueError("flat winner on a multi-axis mesh")
        if op in V_OPS:
            # v-op winners validate through the v-registry: the balanced
            # catalog knows nothing about them
            valgos.v_body_builder_for(op, winner, n_devices)
        else:
            arena_body_builder(op, winner, n_devices)
    except (ValueError, KeyError) as e:
        selection.note_once(
            ("unbuildable", op, winner),
            f"artifact winner {winner!r} for {op} cannot build on this "
            f"mesh ({e}): --algo auto runs the native call there", err)
        return ["native"]
    return [winner]


def world_for(opts: Options) -> SimWorld | DistWorld:
    """The world an Options asks for: under ``distributed``, this
    process' rank of the joined ``torch.distributed`` world (NCCL on card
    ``LOCAL_RANK``, gloo on the CPU); otherwise, or when no cluster is
    found, ``sim_ranks`` sim ranks on the card (or on the CPU when
    ``device="cpu"``).  ``mesh_shape`` / ``hybrid_mesh`` lay the ranks
    over a named mesh.  A card asked for and not visible raises
    :class:`~tpu_perf_torch.world.NoDeviceError` first."""
    from tpu_perf_torch.parallel import (
        initialize_distributed, make_hybrid_mesh, make_mesh,
    )
    from tpu_perf_torch.world import dist_world

    device = resolve_device(opts.device)
    if opts.distributed and initialize_distributed(device=device.type):
        import torch.distributed as dist

        n = dist.get_world_size()
        mesh = (make_hybrid_mesh() if opts.hybrid_mesh
                else make_mesh(opts.mesh_shape, opts.mesh_axes, n=n))
        return dist_world(device, mesh)
    n = opts.sim_ranks
    mesh = None
    if opts.hybrid_mesh:
        mesh = make_hybrid_mesh(n=n, per_node=n)
    elif opts.mesh_shape:
        mesh = make_mesh(opts.mesh_shape, opts.mesh_axes, n=n)
    return SimWorld(n, device, mesh)


def trace_align(world):
    """The trace fence's meeting of the ranks (``TraceRunner``'s
    ``align``): a multi-process world's rendezvous, None in one
    process."""
    return world.rendezvous() if is_dist(world) else None


def max_over_ranks(world, samples: list[float | None]
                   ) -> list[float | None]:
    """A point's run times, each its maximum over the ranks of a
    multi-process world (one ``all_reduce(MAX)``, after the point's last
    fence); the sim world's, as they are."""
    return world.max_over_ranks(samples) if is_dist(world) else list(samples)


@dataclasses.dataclass(frozen=True)
class SweepPointResult:
    """All measured runs of one (op, nbytes) point."""

    op: str
    nbytes: int
    iters: int
    n_devices: int
    times: RunTimes
    dtype: str = "float32"
    mode: str = "oneshot"  # "oneshot" | "daemon"
    #: the adaptive verdict (``--ci-rel``): the budget a fixed schedule
    #: would burn and the achieved relative CI (0: a fixed-budget point);
    #: ``adaptive`` the controller's summary
    runs_requested: int = 0
    ci_rel: float = 0.0
    adaptive: dict | None = None
    algo: str = "native"   # arena decomposition; rows render "" for native
    imbalance: int = 1     # per-rank payload ratio; rows render it above 1

    def rows(self, job_id: str, backend: str) -> list[ResultRow]:
        no_payload = is_latency_only(self.op, self.n_devices)
        round_trip = self.op in _ROUND_TRIP_OPS
        # the v-ops whose moved volume shrinks with imbalance at a fixed
        # row nbytes report wire bytes in busbw, not buffer bytes
        vol_scale = imbalance_volume_scale(self.op, self.imbalance,
                                           self.n_devices)
        out = []
        for run_id, t in enumerate(self.times.samples, start=1):
            per_op = t / self.iters
            if round_trip:
                # one iteration moves nbytes each way in t: bandwidth is
                # per direction, over the one-way time of the halved lat_us
                per_op = per_op / 2
            out.append(ResultRow(
                timestamp=timestamp_now(),
                job_id=job_id,
                backend=backend,
                op=self.op,
                nbytes=self.nbytes,
                iters=self.iters,
                run_id=run_id,
                n_devices=self.n_devices,
                lat_us=latency_us(t, self.iters, round_trip=round_trip),
                algbw_gbps=0.0 if no_payload
                else alg_bandwidth_gbps(self.nbytes, per_op),
                busbw_gbps=vol_scale * bus_bandwidth_gbps(
                    self.op, self.nbytes, per_op, self.n_devices),
                time_ms=t * 1e3,
                dtype=self.dtype,
                mode=self.mode,
                overhead_us=self.times.overhead_s * 1e6,
                runs_requested=self.runs_requested,
                runs_taken=run_id if self.runs_requested else 0,
                ci_rel=self.ci_rel if self.runs_requested else 0.0,
                algo="" if self.algo == "native" else self.algo,
                imbalance=self.imbalance,
            ))
        return out


def fused_plan_for(opts: Options, *, budget: int | None = None,
                   min_runs: int | None = None) -> tuple[int, ...]:
    """The fused fence's chunk plan for one job: ``budget`` defaults to
    the -r budget (a daemon visit is one run).  ``min_runs`` is passed only
    when an adaptive controller will run, and makes the automatic chunk
    count ``ceil(budget / min_runs)``, so the stop vote fires once a chunk
    and first after min_runs runs; otherwise ``--fused-chunks`` 0 is one
    dispatch a point.  An explicit ``--fused-chunks`` overrides both."""
    if budget is None:
        budget = 1 if opts.infinite else opts.num_runs
    chunks = opts.fused_chunks
    if chunks < 1:
        chunks = 1 if min_runs is None else max(
            1, -(-budget // max(1, min_runs)))
    return fused_chunk_plan(budget, chunks)


def build_fused_point(built: BuiltOp, plan: tuple[int, ...]) -> FusedPoint:
    """One point's fused programs (ops.build_fused_step), one per
    distinct chunk size in ``plan``."""
    return FusedPoint(op=built.name, plan=tuple(plan), programs={
        reps: build_fused_step(built, reps) for reps in sorted(set(plan))})


def build_point_pair(opts: Options, world: SimWorld, op: str, nbytes: int,
                     *, fused_plan: tuple[int, ...] | None = None,
                     algo: str = "native", imbalance: int = 1
                     ) -> tuple[BuiltOp, BuiltOp | FusedPoint | None]:
    """One point's (lo, hi) op pair for the configured fence: hi is the
    same op at ``iters * SLOPE_ITERS_FACTOR`` executions under slope/trace
    (sharing lo's example buffer), the point's :class:`FusedPoint` under
    fused (``fused_plan``, default the options' fixed-budget plan), else
    None.  ``algo`` selects an arena decomposition (for the ``scenario``
    op, the scenario's label, built by the composition layer);
    ``imbalance`` is the point's per-rank payload ratio."""

    def build(n_iters: int, reuse=None) -> BuiltOp:
        if op == "scenario":
            from tpu_perf_torch.scenarios.compose import (
                build_scenario_op, spec_for_label, split_scenario_label,
            )

            _, inner = split_scenario_label(algo)
            return build_scenario_op(
                spec_for_label(opts.scenario, algo), world, nbytes, n_iters,
                dtype=opts.dtype, imbalance=imbalance, inner=inner,
                reuse_input=reuse)
        return build_op(op, world, nbytes, n_iters, dtype=opts.dtype,
                        window=opts.window, reuse_input=reuse, algo=algo,
                        imbalance=imbalance)

    built = build(opts.iters)
    if opts.fence == "fused":
        return built, build_fused_point(
            built, fused_plan if fused_plan is not None
            else fused_plan_for(opts))
    built_hi = None
    if opts.fence in ("slope", "trace"):
        built_hi = build(opts.iters * SLOPE_ITERS_FACTOR,
                         reuse=built.example_input)
    return built, built_hi


def point_controller(config, world):
    """A point's adaptive controller (``tpu_perf_torch.adaptive``) in
    ``world``: in a multi-process world its stop votes are all-reduced over
    the ranks; the sim world's one process votes alone."""
    from tpu_perf_torch.adaptive import PointController

    return PointController(config, n_hosts=world.n if is_dist(world) else 1)


def without_p50(config, err=None):
    """``config`` with the mean statistic where it asked for p50: a fused
    chunk observes its mean only, and a median of means is not the run
    median.  Said on ``err`` (stderr by default), never silently."""
    if config is None or config.statistic != "p50":
        return config
    import sys

    print("[tpu-perf-torch] --ci-statistic p50 is not available under "
          "--fence fused (a captured chunk observes its mean only, and a "
          "median of means is not the run median): using the mean "
          "statistic", file=err if err is not None else sys.stderr)
    return dataclasses.replace(config, statistic="mean")


def run_point_fused(opts: Options, built: BuiltOp, fp: FusedPoint, *,
                    perf_clock: Callable[[], float] = time.perf_counter,
                    controller=None, phases=None, tracer=None,
                    starts: list | None = None) -> RunTimes:
    """One finite point under the fused fence: warm (capture), then one
    measured dispatch per chunk (one by default), the measured window kept
    as a trace under --profile-dir.  With an adaptive ``controller`` each
    chunk's mean is one observation, and the stop vote fires after each
    chunk.  The point's graphs are freed before it returns, so the next
    point's fit beside nothing of this one.  ``tracer`` records the
    warm-up, each chunk's measure and the stop votes; ``starts`` gets each
    chunk's (host start, reps), from which the caller lays out the runs'
    spans."""
    from tpu_perf_torch.compilepipe import PhaseTimer
    from tpu_perf_torch.spans import NULL_TRACER

    phases = phases if phases is not None else PhaseTimer(perf_clock)
    tracer = tracer if tracer is not None else NULL_TRACER
    runner = FusedRunner(fp, built, perf_clock=perf_clock)
    try:
        with phases.phase("compile"), tracer.span(
                "warmup", op=built.name, nbytes=built.nbytes, fused=True):
            runner.warm()
        samples: list[float] = []
        with profile_window(opts.profile_dir, f"{built.name}-{built.nbytes}",
                            built.example_input.device):
            for reps in fp.plan:
                with phases.phase("measure"), tracer.span(
                        "measure", op=built.name, nbytes=built.nbytes,
                        reps=reps):
                    t0 = perf_clock()
                    chunk = runner.chunk(reps)
                if starts is not None:
                    starts.append((t0, reps))
                samples.extend(chunk)
                if controller is not None:
                    controller.observe_chunk(sum(chunk) / reps, reps)
                    if controller.should_stop(len(samples), tracer=tracer):
                        break
    finally:
        runner.close()
    return RunTimes(samples=samples, warmup_s=runner.warmup_s)


def _adaptive_run_times(opts: Options, built: BuiltOp,
                        built_hi: BuiltOp | None, controller,
                        keep_lost: bool = False) -> RunTimes:
    """The adaptive loop of block / readback / slope: one fenced run a
    round, warmed and fenced as time_step / time_slope do, stopped by the
    controller (its vote after each run's fence, outside the window).
    Samples are whole runs, per execution under slope; ``keep_lost`` keeps
    a lost slope sample as None (time_slope's)."""
    from tpu_perf_torch.timing import fence, measure_overhead, slope_sample

    x = built.example_input
    slope = built_hi is not None
    fmode = "readback" if slope else opts.fence
    t0 = time.perf_counter()
    for _ in range(max(1, opts.warmup_runs)):
        fence(built.step(x), fmode)
        if slope:
            fence(built_hi.step(x), fmode)
    warmup_s = time.perf_counter() - t0
    overhead_s = 0.0
    if opts.measure_dispatch and not slope:
        overhead_s = measure_overhead(x, fence_mode=fmode)
    samples: list[float] = []
    runs = 0
    while True:
        runs += 1
        if slope:
            t = slope_sample(built.step, built_hi.step, x, x,
                             built_hi.iters - built.iters)
        else:
            t0 = time.perf_counter()
            fence(built.step(x), fmode)
            t = time.perf_counter() - t0
        controller.observe(t)
        if t is not None or keep_lost:
            samples.append(t)
        if controller.should_stop(runs):
            break
    if slope and not samples:
        from tpu_perf_torch.timing import DegenerateSlopeError

        raise DegenerateSlopeError(
            "slope timing produced no valid samples (t_hi never exceeded "
            "t_lo) — the measured kernel is lost in timing noise; raise "
            "iters or use more runs")
    return RunTimes(samples=samples, warmup_s=warmup_s,
                    overhead_s=overhead_s)


def run_point(opts: Options, world: SimWorld | DistWorld, nbytes: int, *,
              op: str | None = None, phases=None,
              adaptive=None, algo: str = "native",
              imbalance: int = 1) -> SweepPointResult:
    """Measure one sweep point: ``opts.num_runs`` runs of ``opts.iters``
    chained executions each.  ``phases`` (a compilepipe.PhaseTimer) takes
    the point's compile / measure split.  ``adaptive`` (an
    adaptive.AdaptiveConfig) early-stops the block, readback, slope and
    fused fences (its max_runs the budget); the trace fence keeps its
    fixed budget (its pairs' graphs are captured once for the budget)."""
    from tpu_perf_torch.compilepipe import PhaseTimer

    phases = phases if phases is not None else PhaseTimer()
    if opts.fence == "auto":
        opts = dataclasses.replace(
            opts, fence=resolve_fence(opts.fence, world.device))
    op = op or op_for_options(opts)
    if op == "extern":
        raise ValueError(
            "extern mode is print-only and runs through "
            "tpu_perf_torch.driver.Driver")
    if opts.fence == "trace":
        adaptive = None
    elif opts.fence == "fused":
        adaptive = without_p50(adaptive)
    plan = None
    if opts.fence == "fused" and adaptive is not None:
        plan = fused_plan_for(opts, budget=adaptive.max_runs,
                              min_runs=adaptive.min_runs)
    with phases.phase("compile"):
        built, built_hi = build_point_pair(opts, world, op, nbytes,
                                           fused_plan=plan, algo=algo,
                                           imbalance=imbalance)
    x = built.example_input
    controller = (point_controller(adaptive, world) if adaptive is not None
                  else None)
    if opts.fence == "fused":
        times = run_point_fused(opts, built, built_hi, controller=controller,
                                phases=phases)
    elif controller is not None:
        with phases.phase("measure"):
            times = _adaptive_run_times(opts, built, built_hi, controller,
                                        keep_lost=is_dist(world))
        if built_hi is not None:  # slope samples are per execution
            times = dataclasses.replace(
                times, samples=[None if t is None else t * built.iters
                                for t in times.samples])
    elif opts.fence == "trace":
        with phases.phase("measure"):
            per_exec = time_trace(built.step, built_hi.step, x, built.iters,
                                  built_hi.iters, opts.num_runs,
                                  warmup_runs=opts.warmup_runs,
                                  align=trace_align(world))
        times = RunTimes(samples=[t * built.iters for t in per_exec.samples],
                         warmup_s=per_exec.warmup_s)
    elif opts.fence == "slope":
        # across processes a lost sample stays None until the ranks'
        # maximum below: a rank that dropped it alone would reduce a list
        # of another length than its peers'
        with phases.phase("measure"):
            per_exec = time_slope(built.step, built_hi.step, x, built.iters,
                                  built_hi.iters, opts.num_runs,
                                  warmup_runs=opts.warmup_runs,
                                  keep_lost=is_dist(world))
        times = RunTimes(samples=[None if t is None else t * built.iters
                                  for t in per_exec.samples],
                         warmup_s=per_exec.warmup_s)
    else:
        with phases.phase("measure"):
            times = time_step(built.step, x, opts.num_runs,
                              warmup_runs=opts.warmup_runs,
                              fence_mode=opts.fence,
                              measure_dispatch=opts.measure_dispatch)
    if is_dist(world):
        samples = [t for t in max_over_ranks(world, times.samples)
                   if t is not None]
        if not samples:
            from tpu_perf_torch.timing import DegenerateSlopeError

            raise DegenerateSlopeError(
                "slope timing produced no valid samples on any rank — the "
                "measured kernel is lost in timing noise; raise iters or "
                "use more runs")
        times = dataclasses.replace(times, samples=samples)
    kw = {}
    if controller is not None:
        summary = controller.summary()
        kw = dict(runs_requested=summary["requested"],
                  ci_rel=summary["ci_rel"] or 0.0, adaptive=summary)
    return SweepPointResult(op=op, nbytes=built.nbytes, iters=built.iters,
                            n_devices=built.n_devices, times=times,
                            dtype=opts.dtype, algo=built.algo,
                            imbalance=built.imbalance, **kw)


def sizes_for(opts: Options, op: str | None = None) -> list[int]:
    """The sweep (or single buff_sz) for ``opts``, dtype-aligned; one
    point for the fixed-payload ops (their builders clamp the payload, so
    more sizes would time the identical kernel).  ``op`` overrides the
    options' own kernel selection."""
    if opts.sweep:
        sizes = parse_sweep(opts.sweep, align=DTYPES[opts.dtype].itemsize)
    else:
        sizes = [opts.buff_sz]
    if (op or op_for_options(opts)) in FIXED_PAYLOAD_OPS:
        sizes = sizes[:1]
    return sizes


def run_sweep(opts: Options, world: SimWorld) -> Iterator[SweepPointResult]:
    """Run every point of the configured sweep (or the single buff_sz)."""
    op = op_for_options(opts)
    for nbytes in sizes_for(opts, op):
        yield run_point(opts, world, nbytes, op=op)
