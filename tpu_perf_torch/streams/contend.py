"""The contention race: a victim op measured under a concurrent load (port
of ``tpu_perf/streams/contend.py``).

Three shapes of load ride the :class:`~tpu_perf_torch.streams.engine.StreamEngine`:

* a compute load (``--load mxu_gemm|hbm_stream``): the victim raced
  against the roofline instruments, reused as load generators;
* a sibling op (``--load <any ported op>``): a second op at once, on the
  same mesh axis as the victim (the two share the fabric) or, on a
  multi-axis mesh, on another one (``--load-axis``), in the sim world
  (two ops sharing the card's memory system) or across the ranks of a
  multi-process world;
* split-channel (``--split K``, op ``ppermute``): the payload cut into K
  slices, each moved by its own concurrent ppermute lane along one of
  the linkmap planner's link-disjoint ring shifts
  (:func:`tpu_perf_torch.linkmap.plan.plan_mesh_links`), so the lanes
  never contend with one another while K is at most the schedule count.
  Its idle baseline is the single-channel full-payload ``ppermute``; a
  loaded sample is the whole K-lane wave's wall, first dispatch to last
  fence (rows with ``load=split:K`` and no single lane, ``stream`` 0).

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

``--algo`` races the victim's arena decompositions (native first), each
idle and under the load; rows carry the algorithm.
"""

from __future__ import annotations

import dataclasses
import time

from tpu_perf_torch.config import Options
from tpu_perf_torch.schema import ResultRow, decorate_op
from tpu_perf_torch.streams.engine import StreamEngine
from tpu_perf_torch.streams.plans import lane_schedules, split_slices
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


def _split_k(load: str) -> int:
    """K of a ``split:K`` load spelling; 0 for every other load."""
    if not load.startswith("split:"):
        return 0
    tail = load.split(":", 1)[1]
    if not tail.isdigit() or int(tail) < 2:
        raise ValueError(
            f"split-channel load must be 'split:K' with K >= 2, got "
            f"{load!r}")
    return int(tail)


def _flat(world):
    """``world`` as one flat axis ``x`` over its ranks in row-major order
    (plan indices are ranks): the sim world's rows, or this rank of a
    multi-process world on its own group's ranks."""
    from tpu_perf_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n=world.n)
    if is_dist(world):
        return dataclasses.replace(world, mesh=mesh, _axis_groups={})
    return SimWorld(world.n, world.device, mesh)


def build_split_steps(world, nbytes: int, iters: int, k: int, *,
                      dtype: str = "float32", schedules=None,
                      lane_worlds=None):
    """Build the K split-channel ppermute lanes.

    Returns ``[(step, example, slice_nbytes, sched_name), ...]``: lane
    ``i`` moves slice ``i`` of the payload (:func:`split_slices`) along
    schedule ``i``'s permutation (:func:`lane_schedules` over the linkmap
    planner's link-disjoint rounds; pass ``schedules`` to pin them — the
    parity check races K lanes of the SAME schedule against the
    single-channel full-payload spelling), ``iters`` chained ppermutes an
    execution (:meth:`tpu_perf_torch.arena.spmd.Ranks.ppermute`).  The
    example is the make_fill input of the slice in the arena's stacked
    view: ``(n, elems)`` sim rows, or this rank's ``(1, elems)``.
    ``lane_worlds`` gives lane i its own world (a process group of its
    own across processes); default: ``world`` for every lane."""
    from tpu_perf_torch.arena.spmd import Ranks
    from tpu_perf_torch.linkmap.plan import plan_mesh_links
    from tpu_perf_torch.ops.collectives import DTYPES, example_input

    n = world.n
    if schedules is None:
        schedules = plan_mesh_links((n,), ("x",), wrap=True)
    lanes = lane_schedules(schedules, k)
    itemsize = DTYPES[dtype].itemsize
    sizes = split_slices(nbytes, k, itemsize=itemsize)
    out = []
    for i, (sched, slice_nbytes) in enumerate(zip(lanes, sizes)):
        lane_world = _flat(world if lane_worlds is None
                           else lane_worlds[i])
        ranks = Ranks(lane_world)
        perm = sched.perm()

        def step(x, _perm=perm, _ranks=ranks):
            for _ in range(iters):
                x = _ranks.ppermute(x, "x", _perm)
            return x

        example = example_input(lane_world, slice_nbytes // itemsize,
                                dtype).view(ranks.rows, -1)
        out.append((step, example, slice_nbytes, sched.name))
    return out


def _rows_for(samples, *, opts: Options, op: str, nbytes: int, iters: int,
              n_devices: int, backend: str, load: str, stream: int,
              warmup_s: float, algo: str = "native") -> list[ResultRow]:
    """Rows for one (point, load) group through the one row factory
    (runner.SweepPointResult.rows), stamped with the contention
    coordinates."""
    from tpu_perf_torch.runner import SweepPointResult
    from tpu_perf_torch.timing import RunTimes

    point = SweepPointResult(
        op=op, nbytes=nbytes, iters=iters, n_devices=n_devices,
        times=RunTimes(samples=list(samples), warmup_s=warmup_s),
        dtype=opts.dtype, mode="oneshot", algo=algo)
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
    from tpu_perf_torch.runner import (
        algos_for_options, max_over_ranks, sizes_for, world_for,
    )

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
    split_k = _split_k(load)
    if split_k and opts.op != "ppermute":
        raise ValueError(
            f"split-channel contention slices a ppermute payload; got "
            f"op={opts.op!r}")
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
        if not split_k and load not in known_ops():
            raise ValueError(
                f"unknown load op {load!r}; known: {sorted(known_ops())} "
                f"(or split:K)")
        world = world if world is not None else world_for(opts)
        load_world = None if split_k else _lane_world(world)
        n_dev, backend = world.n, world.backend
    rows: list[ResultRow] = []
    # --algo races the victim's decompositions, each under the load (the
    # best algorithm under load is not always the idle winner)
    for algo in algos_for_options(opts, opts.op, n_dev, err=err):
        for nbytes in sizes_for(opts, opts.op):
            if synthetic:
                idle = [injector.synthetic_sample(
                    decorate_op(opts.op, algo), nbytes)
                    for _ in range(opts.num_runs)]
                loaded = [injector.synthetic_sample(
                    decorate_op(opts.op, algo, load=load), nbytes)
                    * SYNTHETIC_CONTENTION for _ in range(opts.num_runs)]
                idle_warm = loaded_warm = 0.0
                actual = nbytes
            elif split_k:
                idle, loaded, idle_warm, loaded_warm, actual = \
                    _measure_split(opts, world, nbytes, split_k,
                                   tracer=tracer, perf_clock=perf_clock)
                idle = max_over_ranks(world, idle)
                loaded = max_over_ranks(world, loaded)
            else:
                idle, loaded, idle_warm, loaded_warm, actual = \
                    _measure_race(opts, world, load_world, nbytes, load,
                                  axis=axis, load_axis=load_axis,
                                  tracer=tracer, perf_clock=perf_clock,
                                  algo=algo)
                # each run's time its maximum over the ranks, after the
                # point's last fence
                idle = max_over_ranks(world, idle)
                loaded = max_over_ranks(world, loaded)
            common = dict(opts=opts, op=opts.op, nbytes=actual,
                          iters=opts.iters, n_devices=n_dev,
                          backend=backend, algo=algo)
            rows.extend(_rows_for(idle, load="", stream=0,
                                  warmup_s=idle_warm, **common))
            # the victim rides lane 0; rows carry the 1-based lane.
            # Split-channel rows aggregate the whole K-lane wave, so they
            # carry no single lane (stream 0)
            rows.extend(_rows_for(loaded, load=load,
                                  stream=0 if split_k else 1,
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
                  *, axis, load_axis, tracer, perf_clock,
                  algo: str = "native"):
    """The victim on lane 0 raced against the load on lane 1.  Returns
    (idle samples, loaded samples, idle and loaded warm-up seconds,
    victim nbytes).  The loaded warm-up is one unrecorded race, so the
    lanes' first-dispatch costs (a lane's stream, a kernel's device
    counters on it) stay out of the samples."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.timing import fence

    victim = build_op(opts.op, world, nbytes, opts.iters, dtype=opts.dtype,
                      axis=axis, algo=algo)
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


def _measure_split(opts: Options, world, nbytes: int, k: int, *, tracer,
                   perf_clock):
    """The split-channel shape: the single-channel full-payload ppermute
    (the idle baseline) against K concurrent slice lanes on link-disjoint
    schedules.  The loaded sample is the whole wave's wall, first
    dispatch to last fence: the time the split spelling takes to move the
    same payload.  Across processes lane i > 0 rides a process group of
    its own (:func:`_lane_world`)."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.timing import fence

    single = build_op(opts.op, world, nbytes, opts.iters, dtype=opts.dtype)
    lane_worlds = [world] + [_lane_world(world) for _ in range(k - 1)]
    lanes = build_split_steps(world, nbytes, opts.iters, k,
                              dtype=opts.dtype, lane_worlds=lane_worlds)
    engine = StreamEngine(k, fence_mode=opts.fence, tracer=tracer,
                          perf_clock=perf_clock)
    x = single.example_input
    t0 = perf_clock()
    for _ in range(max(1, opts.warmup_runs)):
        fence(single.step(x), opts.fence)
        for step, example, _, _ in lanes:
            fence(step(example), opts.fence)
    warm = perf_clock() - t0
    idle = []
    for _ in range(opts.num_runs):
        t0 = perf_clock()
        fence(single.step(x), opts.fence)
        idle.append(perf_clock() - t0)

    def wave() -> float:
        t0 = perf_clock()
        for lane, (step, example, _, name) in enumerate(lanes):
            engine.dispatch(lane, step, example, label=f"split[{name}]")
        engine.fence_all()
        return perf_clock() - t0

    # one unrecorded wave: each lane's first dispatch makes its stream
    loaded_warm = wave()
    loaded = [wave() for _ in range(opts.num_runs)]
    return idle, loaded, warm, loaded_warm, single.nbytes
