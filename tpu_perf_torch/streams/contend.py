"""The contention race: a victim op measured under a concurrent load (port
of ``tpu_perf/streams/contend.py``).

Two shapes of load ride the :class:`~tpu_perf_torch.streams.engine.StreamEngine`:

* a compute load (``--load mxu_gemm|hbm_stream``): the victim raced
  against the roofline instruments, reused as load generators;
* a sibling op (``--load <any ported op>``): a second op on the same sim
  world, so two kernels share the card's memory system at once.

Every point runs twice: an idle baseline (the victim alone on its lane;
rows with an empty ``load`` column and ``stream`` 0) and the loaded run
(rows carrying ``load`` and the victim's 1-based lane, 1).  Both sides
dispatch and fence the victim through the same lane, so they differ by
the load alone.  The report's
interference matrix divides the two.  The plan is a pure function of the
options: sizes in order, idle then loaded, fixed run counts, dispatch
order load then victim (the load is in flight before the victim starts),
fence order victim then load (the victim's wall is the measurement).

Not ported yet (ROADMAP): the split-channel shape (``--split K``), which
needs the linkmap planner; the axis flags, which need the multi-card
world; ``--synthetic``, which needs the fault injector; and the arena's
``--algo``.
"""

from __future__ import annotations

import dataclasses
import time

from tpu_perf_torch.config import Options
from tpu_perf_torch.schema import ResultRow
from tpu_perf_torch.streams.engine import StreamEngine
from tpu_perf_torch.world import SimWorld

#: the compute-kernel load generators (bench's roofline bodies)
COMPUTE_LOADS = ("mxu_gemm", "hbm_stream")

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


def run_contend(opts: Options, *, world: SimWorld | None = None,
                perf_clock=time.perf_counter) -> list[ResultRow]:
    """Run the contention plan on ``world`` (default: the options' sim
    world); returns every row, idle and loaded."""
    from tpu_perf_torch.ops.collectives import known_ops
    from tpu_perf_torch.runner import sizes_for, world_for

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
    if load not in known_ops():
        raise ValueError(
            f"unknown load op {load!r}; known: {sorted(known_ops())}")
    world = world if world is not None else world_for(opts)
    rows: list[ResultRow] = []
    for nbytes in sizes_for(opts, opts.op):
        idle, loaded, idle_warm, loaded_warm, actual = _measure_race(
            opts, world, nbytes, load, perf_clock=perf_clock)
        common = dict(opts=opts, op=opts.op, nbytes=actual,
                      iters=opts.iters, n_devices=world.n,
                      backend=world.backend)
        rows.extend(_rows_for(idle, load="", stream=0, warmup_s=idle_warm,
                              **common))
        # the victim rides lane 0; rows carry the 1-based lane
        rows.extend(_rows_for(loaded, load=load, stream=1,
                              warmup_s=loaded_warm, **common))
    return rows


def _measure_race(opts: Options, world: SimWorld, nbytes: int, load: str,
                  *, perf_clock):
    """The victim on lane 0 raced against the load on lane 1.  Returns
    (idle samples, loaded samples, idle and loaded warm-up seconds,
    victim nbytes).  The loaded warm-up is one unrecorded race, so the
    lanes' first-dispatch costs (a lane's stream, a kernel's device
    counters on it) stay out of the samples."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.timing import fence

    victim = build_op(opts.op, world, nbytes, opts.iters, dtype=opts.dtype)
    load_built = build_op(load, world, nbytes, opts.iters, dtype=opts.dtype)
    engine = StreamEngine(2, fence_mode=opts.fence, perf_clock=perf_clock)
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
