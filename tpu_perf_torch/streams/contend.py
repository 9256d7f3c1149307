"""The contention race: a victim op measured under a concurrent load (port
of ``tpu_perf/streams/contend.py``).

Two shapes of load ride the :class:`~tpu_perf_torch.streams.engine.StreamEngine`:

* a compute load (``--load mxu_gemm|hbm_stream``): the victim raced
  against the roofline instruments, reused as load generators;
* a sibling op (``--load <any ported op>``): a second op at once, on the
  same mesh axis as the victim (the two share the fabric) or, on a
  multi-axis mesh, on another one (``--load-axis``), in the sim world
  (two ops sharing the card's memory system) or across the ranks of a
  multi-process world.

Every point runs twice: an idle baseline (the victim alone on its lane;
rows with an empty ``load`` column and ``stream`` 0) and the loaded run
(rows carrying ``load`` and the victim's 1-based lane, 1).  Both sides
dispatch and fence the victim through the same lane, so they differ by
the load alone.  The report's
interference matrix divides the two.  The plan is a pure function of the
options: sizes in order, idle then loaded, fixed run counts, dispatch
order load then victim (the load is in flight before the victim starts),
fence order victim then load (the victim's wall is the measurement), so
every rank of a multi-process world walks it alike.  There each lane's
collectives ride process groups of the lane's own, one a (lane, axis),
made in the same order on every rank, so two communicators in flight at
once never meet in different orders; each row's time is its maximum
over the ranks, taken after the point's last fence.

Under ``--synthetic`` no step is built or run: the samples are the fault
injector's seeded series, a loaded sample the idle series' times
:data:`SYNTHETIC_CONTENTION` (a documented, modeled slowdown, the JAX
package's), so a gate can assert "slowdown > 1" byte-stably.

Not ported yet (ROADMAP): the split-channel shape (``--split K``), which
needs the linkmap planner, and the arena's ``--algo``.
"""

from __future__ import annotations

import dataclasses
import time

from tpu_perf_torch.config import Options
from tpu_perf_torch.schema import ResultRow, decorate_op
from tpu_perf_torch.streams.engine import StreamEngine
from tpu_perf_torch.world import DistWorld, SimWorld, is_dist

#: the compute-kernel load generators (bench's roofline bodies)
COMPUTE_LOADS = ("mxu_gemm", "hbm_stream")

#: the synthetic timing source's modeled contention factor: a loaded
#: victim's seeded sample is the idle series times this (modeled, not
#: measured)
SYNTHETIC_CONTENTION = 1.6

#: fences a concurrent race can use: per run, tolerant of other lanes in
#: flight (the paired and captured fences assume a quiet card)
CONTEND_FENCES = ("block", "readback")


def _rows_for(samples, *, opts: Options, op: str, nbytes: int, iters: int,
              n_devices: int, backend: str, load: str, stream: int,
              warmup_s: float) -> list[ResultRow]:
    """Rows for one (point, load) group through the one row factory
    (runner.SweepPointResult.rows), stamped with the contention
    coordinates."""
    from tpu_perf_torch.runner import SweepPointResult
    from tpu_perf_torch.timing import RunTimes

    point = SweepPointResult(
        op=op, nbytes=nbytes, iters=iters, n_devices=n_devices,
        times=RunTimes(samples=list(samples), warmup_s=warmup_s),
        dtype=opts.dtype, mode="oneshot")
    return [dataclasses.replace(r, load=load, stream=stream)
            for r in point.rows(opts.uuid, backend=backend)]


def run_contend(opts: Options, *, world: SimWorld | DistWorld | None = None,
                axis: str | None = None, load_axis: str | None = None,
                n_devices: int | None = None, tracer=None, err=None,
                perf_clock=time.perf_counter) -> list[ResultRow]:
    """Run the contention plan on ``world`` (default: the options' world);
    returns every row, idle and loaded.  ``axis`` and ``load_axis`` pick
    the victim's and the load's mesh axes (None: every axis, the
    shared-fabric default; naming two different axes of a multi-axis mesh
    races the disjoint-axis shape).  Under ``--synthetic`` no world is
    made: ``n_devices`` states the rank count.  ``tracer`` records the
    engine's dispatch and fence spans."""
    from tpu_perf_torch.ops.collectives import known_ops
    from tpu_perf_torch.runner import max_over_ranks, sizes_for, world_for

    load = opts.load
    if not load:
        raise ValueError(
            "contend needs a load selection (--load OP or --split K)")
    if "," in opts.op:
        raise ValueError(
            f"contend races a single victim op, got family {opts.op!r}")
    if opts.fence not in CONTEND_FENCES:
        raise ValueError(
            f"contend needs a per-run fence that tolerates concurrent lanes "
            f"({'|'.join(CONTEND_FENCES)}), got {opts.fence!r}")
    if opts.infinite:
        raise ValueError("contend is a finite measurement (-r N)")
    if load.startswith("split:"):
        raise NotImplementedError(
            "split-channel contention (--split K) is not yet ported: it "
            "needs the linkmap planner's link-disjoint schedules; see "
            "ROADMAP")
    injector = None
    if opts.synthetic_s is not None or opts.faults:
        from tpu_perf_torch.faults import FaultInjector

        injector = FaultInjector(
            list(opts.faults or ()), seed=opts.fault_seed,
            stats_every=opts.stats_every, synthetic_s=opts.synthetic_s,
            err=err)
    synthetic = injector is not None and injector.synthetic
    if synthetic:
        if n_devices is None:
            raise ValueError("synthetic contend needs an explicit n_devices")
        n_dev, backend = int(n_devices), (
            "torch-sim" if n_devices > 1 else "torch")
    else:
        if load not in known_ops():
            raise ValueError(
                f"unknown load op {load!r}; known: {sorted(known_ops())}")
        world = world if world is not None else world_for(opts)
        load_world = _lane_world(world)
        n_dev, backend = world.n, world.backend
    rows: list[ResultRow] = []
    for nbytes in sizes_for(opts, opts.op):
        if synthetic:
            idle = [injector.synthetic_sample(decorate_op(opts.op), nbytes)
                    for _ in range(opts.num_runs)]
            loaded = [injector.synthetic_sample(
                decorate_op(opts.op, load=load), nbytes)
                * SYNTHETIC_CONTENTION for _ in range(opts.num_runs)]
            idle_warm = loaded_warm = 0.0
            actual = nbytes
        else:
            idle, loaded, idle_warm, loaded_warm, actual = _measure_race(
                opts, world, load_world, nbytes, load, axis=axis,
                load_axis=load_axis, tracer=tracer, perf_clock=perf_clock)
            # each run's time its maximum over the ranks, after the
            # point's last fence
            idle = max_over_ranks(world, idle)
            loaded = max_over_ranks(world, loaded)
        common = dict(opts=opts, op=opts.op, nbytes=actual,
                      iters=opts.iters, n_devices=n_dev, backend=backend)
        rows.extend(_rows_for(idle, load="", stream=0, warmup_s=idle_warm,
                              **common))
        # the victim rides lane 0; rows carry the 1-based lane
        rows.extend(_rows_for(loaded, load=load, stream=1,
                              warmup_s=loaded_warm, **common))
    return rows


def _lane_world(world):
    """The load lane's world: in a multi-process world a process group of
    its own over every rank (and axis groups of its own, made when the
    load is built), so the load's collectives never share a communicator
    with the victim's; the sim world's lanes share it."""
    if not is_dist(world):
        return world
    import torch.distributed as dist

    return dataclasses.replace(world, group=dist.new_group(list(
        range(world.n))), _axis_groups={})


def _measure_race(opts: Options, world, load_world, nbytes: int, load: str,
                  *, axis, load_axis, tracer, perf_clock):
    """The victim on lane 0 raced against the load on lane 1.  Returns
    (idle samples, loaded samples, idle and loaded warm-up seconds,
    victim nbytes).  The loaded warm-up is one unrecorded race, so the
    lanes' first-dispatch costs (a lane's stream, a kernel's device
    counters on it) stay out of the samples."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.timing import fence

    victim = build_op(opts.op, world, nbytes, opts.iters, dtype=opts.dtype,
                      axis=axis)
    load_built = build_op(load, load_world, nbytes, opts.iters,
                          dtype=opts.dtype, axis=load_axis)
    engine = StreamEngine(2, fence_mode=opts.fence, tracer=tracer,
                          perf_clock=perf_clock)
    x, lx = victim.example_input, load_built.example_input
    t0 = perf_clock()
    for _ in range(max(1, opts.warmup_runs)):
        fence(victim.step(x), opts.fence)
        fence(load_built.step(lx), opts.fence)
    warm = perf_clock() - t0

    def alone() -> float:
        # the victim alone on its lane, fenced as the race fences it, so
        # idle and loaded samples differ by the load and nothing else (a
        # lane's event is not the whole card's synchronize)
        engine.dispatch(0, victim.step, x, label=opts.op)
        return engine.fence(0)

    alone()
    idle = [alone() for _ in range(opts.num_runs)]

    def race() -> float:
        engine.dispatch(1, load_built.step, lx, label=load)
        engine.dispatch(0, victim.step, x, label=opts.op)
        t = engine.fence(0)
        engine.fence(1)
        return t

    t0 = perf_clock()
    race()
    loaded_warm = perf_clock() - t0
    loaded = [race() for _ in range(opts.num_runs)]
    return idle, loaded, warm, loaded_warm, victim.nbytes
