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
* ``trace``    — the device's own clock: each leg of the (lo, hi) pair is
  one device program, a CUDA graph captured once with its start and end
  events inside it (:class:`TraceRunner`), slope-disciplined like
  ``slope``.  A replay launches the leg's kernels with no host gap, so
  no host time enters either leg: the counterpart of the JAX package's
  per-leg module durations read from the ``jax.profiler`` device lane;
* ``fused``    — a point's whole run budget in one device dispatch: the
  runs are captured once into a CUDA graph (one graph per distinct chunk
  size of :func:`fused_chunk_plan`) and the graph is replayed, so no host
  launch lands between runs.  Per-run device times come from CUDA events
  recorded between the runs inside the graph (``external=True`` events,
  which a replay records on the device clock): the counterpart of the JAX
  package's per-run device-lane durations of one fused program;
* ``auto``     — resolved once, by the device: ``trace`` on a card,
  ``slope`` on the CPU (:func:`resolve_fence`).

On a CPU tensor ``block`` and ``readback`` are host-clock timings of the
plain PyTorch versions, and ``fused`` runs each chunk eagerly and spreads
its host wall evenly over the chunk's runs (chunk means); ``trace`` needs
a card.
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
#: the trace fence's lead-in before each leg's start event, in clock
#: cycles (about 50 us at an H100's 1.98 GHz boost)
LEAD_IN_CYCLES = 100_000
#: how long the trace gate holds the card for the host's flag before it
#: opens anyway (and counts the miss), nanoseconds
GATE_TIMEOUT_NS = 1_000_000_000
#: whether a fused graph starts behind a :class:`TraceGate`
#: (:class:`FusedRunner`); False times the graphs as they were before the
#: gate (``tools.soak_spikes``'s ``fused0``)
FUSED_GATE = True


class TraceGate:
    """The trace pair's gate (``csrc/trace_gate.cu``): a one-thread kernel
    captured as the first node of the lo leg's graph, which holds the card
    until the host raises its flag (pinned host memory) by one.  The host
    raises it after it has replayed both legs, so every kernel of the pair
    is on the card's queue before the first one runs: a host thread
    preempted halfway through submitting a graph can no longer stall a
    leg between two of its kernels.  ``missed`` counts the gates that
    timed out (GATE_TIMEOUT_NS) instead of seeing the flag."""

    def __init__(self, device: torch.device):
        self.flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        self.seen = torch.zeros(1, dtype=torch.int32, device=device)
        self.missed = torch.zeros(1, dtype=torch.int32, device=device)

    def wait(self) -> None:
        """Launch the gate on the current stream (under capture: a node)."""
        from tpu_perf_torch.kernels import _build

        stream = torch.cuda.current_stream(self.seen.device)
        err = _build.entry("trace_gate")(
            self.flag.data_ptr(), self.seen.data_ptr(),
            self.missed.data_ptr(), GATE_TIMEOUT_NS, stream.cuda_stream)
        _build.check("trace_gate", err)

    def open(self) -> None:
        """Raise the host's flag by one: the next waiting gate opens."""
        self.flag += 1


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


def trace_fence_available(device: torch.device) -> bool:
    """Whether the trace fence can run on ``device``: CUDA events time
    the device's own clock on a card and nowhere else.  The JAX package
    decides by probing its runtime; here the device decides."""
    return device.type == "cuda"


def resolve_fence(fence_mode: str, device: torch.device) -> str:
    """Resolve ``auto`` to ``trace`` on a card and ``slope`` on the CPU;
    other modes pass through.  Callers resolve once, up front."""
    if fence_mode != "auto":
        return fence_mode
    return "trace" if trace_fence_available(device) else "slope"


def measure_overhead(x: torch.Tensor, *, reps: int = 10,
                     fence_mode: str = "block") -> float:
    """Median wall time of one fenced launch of a trivial device op (a
    one-element copy) on ``x``'s device, under the timed window's own
    fence: the launch-and-fence floor below every block / readback
    sample.  Rows record raw times; subtracting is the reader's choice."""
    def trivial():
        return x.reshape(-1)[:1].clone()

    fence(trivial(), fence_mode)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fence(trivial(), fence_mode)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


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
    overhead_s: float = 0.0  # measured launch floor, 0.0 if not measured


def time_step(
    step: Callable,
    x,
    num_runs: int,
    *,
    warmup_runs: int = 1,
    fence_mode: str = "block",
    measure_dispatch: bool = False,
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
    overhead_s = (measure_overhead(x, fence_mode=fence_mode)
                  if measure_dispatch else 0.0)
    samples = []
    for _ in range(num_runs):
        t0 = time.perf_counter()
        fence(step(x), fence_mode)
        samples.append(time.perf_counter() - t0)
    return RunTimes(samples=samples, warmup_s=warmup_s,
                    overhead_s=overhead_s)


def time_slope(
    step_lo: Callable,
    step_hi: Callable,
    x,
    iters_lo: int,
    iters_hi: int,
    num_runs: int,
    *,
    warmup_runs: int = 1,
    keep_lost: bool = False,
) -> RunTimes:
    """Per-execution time via the two-point slope, readback-fenced.
    Samples are *per single execution*; callers multiply by their iters
    for whole-run times.  ``keep_lost`` keeps a lost sample as None and
    raises nothing: a multi-process world reduces the runs over its ranks
    first, so that every rank keeps the same ones."""
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
        if s is not None or keep_lost:
            samples.append(s)
    if not samples:
        raise DegenerateSlopeError(
            "slope timing produced no valid samples (t_hi never exceeded "
            "t_lo) — the measured kernel is lost in timing noise; raise "
            "iters or use more runs"
        )
    return RunTimes(samples=samples, warmup_s=warmup_s)


class TraceRunner:
    """One sweep point's trace pair, each leg one device program.

    ``warm()`` runs each leg once eagerly on a side stream (this builds
    the kernels and allocates that stream's device counters: nothing of
    that may happen under capture), then captures each leg, on the same
    stream, as a CUDA graph that runs its head (:meth:`head`: the lo leg's
    :class:`TraceGate`, then a short device spin, :meth:`lead_in`),
    records its own start event, runs the leg's ``iters`` executions and
    records its end event.  Both graphs share one memory pool: they replay
    in the order they were captured and never at once, and nothing reads
    their outputs.  ``pair()`` replays lo, then hi, opens the gate, fences
    once and returns the two legs' device durations: the events ride the
    replays, so a host stall before, between or after the replays lands
    in neither leg; the gate keeps the card from starting lo before both
    replays are submitted, so a stall in the middle of a submission lands
    in neither leg either; and the slope ``(d_hi - d_lo) / (iters_hi -
    iters_lo)`` cancels a replay's constant cost.  ``graph_bytes`` is what
    the captures added to the card's reserved memory (the pool), held
    until ``close()``.

    ``replay(leg)`` is the one host call a leg makes in a measured pair;
    a caller that wants a stall around a leg wraps it.

    ``align``, in a multi-process world, meets the ranks on the device
    (:meth:`~tpu_perf_torch.world.DistWorld.rendezvous`): each leg's head
    runs it before the lead-in, so a leg's window opens once every rank
    has arrived.  Without it the lo leg of a rank whose replay started
    first holds its wait for the last rank, and its hi leg, which starts
    in step with the peers, holds none: the pair can come out
    non-positive."""

    def __init__(self, step_lo: Callable, step_hi: Callable, x,
                 iters_lo: int, iters_hi: int, *,
                 align: Callable[[], None] | None = None):
        if not x.is_cuda:
            raise ValueError(
                "the trace fence times with CUDA events and needs a CUDA "
                "device")
        if iters_hi <= iters_lo:
            raise ValueError(
                f"need iters_hi > iters_lo, got {iters_lo}, {iters_hi}")
        self.steps = {"lo": step_lo, "hi": step_hi}
        self.x = x
        self.align = align
        self.d_iters = iters_hi - iters_lo
        self.warmup_s = 0.0
        self.graph_bytes = 0
        self.pairs = 0
        self._graphs: dict[str, tuple] = {}
        self.gate: TraceGate | None = None

    def warm(self, replays: int = 1) -> None:
        """Eager run, captures, then ``replays`` unrecorded pairs (at
        least one)."""
        t0 = time.perf_counter()
        dev = self.x.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for step in self.steps.values():
                step(self.x)
            if self.align is not None:
                self.align()
        self.gate = TraceGate(dev)
        # the gate's first launch, eager and open, loads its module
        self.gate.open()
        with torch.cuda.stream(side):
            self.gate.wait()
        torch.cuda.synchronize(dev)
        # a capture empties the allocator's cache first: empty it here, so
        # that the reserved memory's growth is the graphs' pool alone
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        for leg, step in self.steps.items():
            events = (torch.cuda.Event(enable_timing=True, external=True),
                      torch.cuda.Event(enable_timing=True, external=True))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side):
                self.head(leg)
                events[0].record()
                step(self.x)
                events[1].record()
            self._graphs[leg] = (graph, events)
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        for _ in range(max(1, replays)):
            self._replay_pair()
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0

    def head(self, leg: str) -> None:
        """What a leg's graph runs before its start event: the lo leg's
        gate, the ranks' meeting (``align``), then the lead-in."""
        if leg == "lo":
            self.gate.wait()
        if self.align is not None:
            self.align()
        self.lead_in(leg)

    def lead_in(self, leg: str) -> None:
        """Device work a leg's graph runs before its start event: a spin
        of :data:`LEAD_IN_CYCLES` clock cycles.  A replay's first node
        waits for the launch to start up, now and then for 0.1-0.7 ms
        (more often once the profiler has traced the process); with the
        start event first, that wait entered the lo leg and made a pair
        non-positive, 1 in 2000 visits of a 4 KiB daemon.  Behind the
        spin it lands before the start event."""
        torch.cuda._sleep(LEAD_IN_CYCLES)

    def replay(self, leg: str) -> None:
        self._graphs[leg][0].replay()

    def _replay_pair(self) -> None:
        """Both legs' replays, then the gate's opening: the host's calls of
        one pair, in order."""
        self.replay("lo")
        self.replay("hi")
        self.gate.open()

    def pair(self) -> tuple[float, float]:
        """One measured (lo, hi) pair: the legs' device seconds."""
        if not self._graphs:
            self.warm()
        self._replay_pair()
        torch.cuda.synchronize(self.x.device)
        self.pairs += 1
        return tuple(ev[0].elapsed_time(ev[1]) * 1e-3
                     for _, ev in (self._graphs["lo"], self._graphs["hi"]))

    def missed(self) -> int:
        """Gates that opened on their timeout, not on the host's flag."""
        return int(self.gate.missed.item()) if self.gate is not None else 0

    def sample(self) -> float:
        """One pair's slope: device seconds per execution.  On the device
        clock a longer leg cannot be faster: a non-positive pair raises."""
        d_lo, d_hi = self.pair()
        if d_hi <= d_lo:
            raise RuntimeError(
                f"device-time slope pair {self.pairs - 1} is non-positive "
                f"({d_lo:.6f} -> {d_hi:.6f} s)")
        return (d_hi - d_lo) / self.d_iters

    def close(self) -> None:
        """Free the graphs and their memory pool."""
        self._graphs.clear()
        self.gate = None


def time_trace(
    step_lo: Callable,
    step_hi: Callable,
    x,
    iters_lo: int,
    iters_hi: int,
    num_runs: int,
    *,
    warmup_runs: int = 1,
    align: Callable[[], None] | None = None,
) -> RunTimes:
    """Per-execution time via the two-point slope on the DEVICE clock:
    ``num_runs`` pairs of a :class:`TraceRunner` (each leg one graph
    replay, behind ``align`` across processes) after ``warmup_runs``
    unrecorded ones; its graphs are freed before it returns.  Samples are
    per single execution, like :func:`time_slope`."""
    if num_runs <= 0:
        raise ValueError(f"num_runs must be positive, got {num_runs}")
    runner = TraceRunner(step_lo, step_hi, x, iters_lo, iters_hi,
                         align=align)
    try:
        runner.warm(warmup_runs)
        samples = [runner.sample() for _ in range(num_runs)]
    finally:
        runner.close()
    return RunTimes(samples=samples, warmup_s=runner.warmup_s)


def fused_chunk_plan(num_runs: int, chunks: int = 1) -> tuple[int, ...]:
    """Split a point's run budget into per-dispatch chunk sizes: ``chunks``
    = 1 is the whole budget in one dispatch; sizes differ by at most one,
    so a point captures at most two distinct graphs."""
    if num_runs <= 0:
        raise ValueError(f"num_runs must be positive, got {num_runs}")
    k = max(1, min(chunks, num_runs))
    base, rem = divmod(num_runs, k)
    return tuple([base + 1] * rem + [base] * (k - rem))


@dataclasses.dataclass(frozen=True)
class FusedPoint:
    """One sweep point's fused build (runner.build_fused_point): the
    measured chunk plan and one program per distinct chunk size
    (ops.build_fused_step).  Holds no device buffer: the runner copies the
    example input into a private working buffer."""

    op: str
    plan: tuple[int, ...]  # measured runs per chunk dispatch
    programs: dict         # reps -> fused program


class FusedRunner:
    """Drives one sweep point's fused measurement loop.

    ``warm()`` copies the example input into a private working buffer
    (the example input stays intact), runs the first chunk's program once
    eagerly on it on a side stream (this builds the kernels, compiles the
    Triton JIT, allocates the kernels' device counters of that stream and
    asks the occupancy queries: nothing of that may happen under
    capture), and on a card captures one CUDA graph per distinct chunk
    size on the same stream and replays the first once, unrecorded.
    ``chunk(reps)`` is one measured dispatch of ``reps`` whole runs and
    returns their per-run times (``wall(reps)`` the same dispatch's host
    wall, no event read):

    * on a card, one replay of the chunk's graph.  The graph records a
      CUDA event before the first run and after each run, so every run's
      time is device time between two events, no host time in it.  The
      graph ends by copying its last output into the working buffer, so
      the next replay carries on from it; the copy lies outside every
      run's events;
    * on the CPU, the chunk's program run eagerly; its fenced host wall
      is spread evenly over its runs (chunk means).

    Every dispatch is block-fenced.  ``dispatches`` counts measured
    dispatches only.  ``close()`` frees the graphs and their memory
    pools; a finite sweep closes each point's runner before it builds the
    next.
    """

    def __init__(self, point: FusedPoint, built, *,
                 perf_clock: Callable[[], float] = time.perf_counter):
        self.point = point
        self.built = built
        self.perf_clock = perf_clock
        self.dispatches = 0
        self.warmup_s = 0.0
        self._x: torch.Tensor | None = None
        self._side = None  # the warm run's and the captures' stream
        self._graphs: dict[int, tuple[torch.cuda.CUDAGraph, list]] = {}
        self.gate: TraceGate | None = None

    @property
    def buffer(self) -> torch.Tensor | None:
        """The private working buffer the runs carry (None before warm)."""
        return self._x

    def _capture(self, reps: int) -> None:
        events = [torch.cuda.Event(enable_timing=True, external=True)
                  for _ in range(reps + 1)]
        graph = torch.cuda.CUDAGraph()
        x = self._x
        # captured on the stream the eager run warmed: the kernels' device
        # counters are per stream, and the warm run made this one's
        with torch.cuda.graph(graph, stream=self._side):
            if self.gate is not None:
                self.gate.wait()
            events[0].record()
            y = self.point.programs[reps](
                x, on_run=lambda i: events[i + 1].record())
            if y is not x:
                x.copy_(y)
            del y
        self._graphs[reps] = (graph, events)

    def warm(self) -> None:
        t0 = self.perf_clock()
        first = self.point.plan[0]
        self._x = self.built.example_input.clone()
        if self._x.is_cuda:
            # the eager run on a side stream, as capture asks; the graphs
            # are captured on the same stream
            side = self._side = torch.cuda.Stream(self._x.device)
            side.wait_stream(torch.cuda.current_stream(self._x.device))
            with torch.cuda.stream(side):
                self._x.copy_(self.point.programs[first](self._x))
            if FUSED_GATE:
                # the gate's first launch, eager and open, loads its module
                self.gate = TraceGate(self._x.device)
                self.gate.open()
                with torch.cuda.stream(side):
                    self.gate.wait()
            torch.cuda.current_stream(self._x.device).wait_stream(side)
            torch.cuda.synchronize(self._x.device)
            for reps in sorted(set(self.point.plan)):
                self._capture(reps)
            self._replay(first)
        else:
            self._x = self.point.programs[first](self._x)
        fence(self._x)
        self.warmup_s = self.perf_clock() - t0

    def wall(self, reps: int) -> float:
        """One measured dispatch of ``reps`` whole runs, block-fenced;
        returns its host wall in seconds (no event is read)."""
        if self._x is None:
            self.warm()
        self.dispatches += 1
        t0 = self.perf_clock()
        if self._x.is_cuda:
            self._replay(reps)
        else:
            self._x = self.point.programs[reps](self._x)
        fence(self._x)
        return self.perf_clock() - t0

    def _replay(self, reps: int) -> None:
        """The chunk's replay, then the gate's opening."""
        self._graphs[reps][0].replay()
        if self.gate is not None:
            self.gate.open()

    def missed(self) -> int:
        """Gates that opened on their timeout, not on the host's flag."""
        return int(self.gate.missed.item()) if self.gate is not None else 0

    def chunk(self, reps: int) -> list[float]:
        """One measured dispatch of ``reps`` whole runs; returns the runs'
        times in seconds."""
        wall = self.wall(reps)
        if self._x.is_cuda:
            # the events of a replay are complete once the fence returns
            events = self._graphs[reps][1]
            return [events[i].elapsed_time(events[i + 1]) * 1e-3
                    for i in range(reps)]
        return [wall / reps] * reps

    def close(self) -> None:
        """Free the graphs (and their private memory pools) and the
        working buffer."""
        self._graphs.clear()
        self._x = None
        self.gate = None
