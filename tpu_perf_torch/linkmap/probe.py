"""Link prober: drive probe schedules, fill the N×N link matrix (port of
``tpu_perf/linkmap/probe.py``).

Each :class:`~tpu_perf_torch.linkmap.plan.LinkProbe` becomes a tiny
step — ``iters`` chained ``ppermute`` executions of just that ``(src,
dst)`` pair over the world's ranks in flat row-major order (so plan
indices are ranks) — timed through the ``block`` / ``readback`` fences
of :mod:`tpu_perf_torch.timing`.  The ``ppermute`` is the arena's
(:mod:`tpu_perf_torch.arena.spmd`):

* in the sim world, a row permutation of the ``(n, elems)`` rows, ``out
  [dst] = x[src]``, every row no pair addresses zero-filled as JAX's
  ``ppermute`` fills it.  One card has no link, so a sim probe measures
  a zero fill and an index copy of the rows: a memory pass, alike for
  every link;
* in a multi-process world (:class:`~tpu_perf_torch.world.DistWorld`),
  one ``batch_isend_irecv`` of the permutation
  (``ops.collectives._ppermute``), posted only by the ranks in a pair:
  across cards, one NVLink direction.

The per-probe statistic is the MEAN of the surviving samples, not the
median: a sick link often shows as intermittent stalls, which a mean
keeps visible and a median hides; robustness against honest noise lives
one layer up, in the grader's cross-link MAD.

Across processes a sample is the maximum over the ranks of that run's
fenced time (the port's convention for a multi-rank row: a transfer
takes as long as its slower end), reduced once a probe's runs are done,
outside every timed window.  Every rank then passes the same reduced
samples through the fault injector, so every rank grades the same
numbers; the caller writes records on rank 0 only.

Two knobs make the prober CI- and chaos-able, both riding the fault
subsystem (:mod:`tpu_perf_torch.faults`):

* ``injector`` with ``synthetic_s`` replaces every measured sample with
  the seeded per-point series (``FaultInjector.synthetic_sample`` keyed
  on the probe's op name): a deterministic linkmap anywhere, no device
  touched;
* every sample (real or synthetic) then passes through
  ``FaultInjector.apply`` with the probe's op name and OWNING RANK (the
  src's), so a fault schedule can target one link
  (``op="link:(1,2)>(1,3)"``) on one rank — the localization gate's
  injection point.

``concurrent=True`` drives each schedule as ONE ppermute (its probes
in flight at once; the planner guarantees they never share a directed
link) and attributes the batch time to every probe in it: a fast sweep
whose per-link values are upper bounds.  :meth:`LinkProber.bisect_flagged`
buys back exact attribution: every link the grader flags is re-probed
serially before the final grading pass.

``precompile=N`` keeps the JAX walk order with a worker thread N probe
programs ahead.  A probe here has no compile step, so the worker builds
only the host half (the permutation and the row permutation's index
table, on the host: :class:`ProbeProgram`); the device side is made on
the main thread, at the probe's turn.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import Callable

import torch

from tpu_perf_torch.linkmap.plan import LinkProbe, Schedule
from tpu_perf_torch.schema import JsonlRecord


class LinkmapRecord(JsonlRecord):
    """One ``linkmap-*.log`` JSONL line.  Record types share the stream
    via the ``record`` discriminator: ``meta`` (one per sweep), ``probe``
    (one per measured link), ``verdict`` (one per graded link)."""

    __slots__ = ()
    FAMILY = "linkmap"


@dataclasses.dataclass
class ProbeResult:
    """One directed link's measured samples plus attribution."""

    probe: LinkProbe
    rank: int        # owning rank = the src's rank
    host: str
    samples: list[float]  # surviving whole-run seconds (iters messages)
    dropped: int
    first_run: int   # global run ids of this probe's samples (the
    last_run: int    # fault-window / health-event clock)
    iters: int
    nbytes: int
    span_id: str = ""  # enclosing probe_schedule span (--spans); the
    #                    record carries it only when tracing was on

    @property
    def mean_s(self) -> float | None:
        """Mean per-message seconds; None when every sample was lost."""
        if not self.samples:
            return None
        return sum(self.samples) / len(self.samples) / max(1, self.iters)

    @property
    def bw_gbps(self) -> float | None:
        t = self.mean_s
        if t is None or t <= 0:
            return None
        return self.nbytes / t / 1e9

    def to_record(self) -> LinkmapRecord:
        t = self.mean_s
        return LinkmapRecord(
            record="probe", op=self.probe.op,
            src=self.probe.src, dst=self.probe.dst,
            src_coords=list(self.probe.src_coords),
            dst_coords=list(self.probe.dst_coords),
            axis=self.probe.axis, shift=self.probe.shift,
            rank=self.rank, host=self.host,
            samples=len(self.samples), dropped=self.dropped,
            first_run=self.first_run, last_run=self.last_run,
            lat_us=None if t is None else t * 1e6,
            bw_gbps=self.bw_gbps,
            # only traced sweeps carry the join key: untraced records
            # keep their pre-span shape byte for byte
            **({"span_id": self.span_id} if self.span_id else {}),
        )


@dataclasses.dataclass
class LinkMapResult:
    """One probe sweep's measurements — the grader's and renderer's input."""

    n: int
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    nbytes: int
    iters: int
    runs: int
    fence: str
    concurrent: bool
    synthetic: bool
    probes: list[ProbeResult]

    def latency_matrix(self) -> list[list[float | None]]:
        """N×N per-message seconds; ``None`` = link not probed (or all
        samples lost — the grader tells those apart via the probe)."""
        m: list[list[float | None]] = [[None] * self.n for _ in range(self.n)]
        for r in self.probes:
            m[r.probe.src][r.probe.dst] = r.mean_s
        return m

    def bandwidth_matrix(self) -> list[list[float | None]]:
        m: list[list[float | None]] = [[None] * self.n for _ in range(self.n)]
        for r in self.probes:
            m[r.probe.src][r.probe.dst] = r.bw_gbps
        return m


#: fences the prober accepts: one timed call per sample (the slope/trace
#: pair machinery is a per-point protocol the per-link sweep does not
#: need — a probe's constant overheads are shared by every link, so the
#: grader's cross-link comparison cancels them the way a slope would)
PROBE_FENCES = ("block", "readback")


def _itemsize(dtype: str, *, probed: bool) -> int:
    """The element width: a probed dtype must be one the ops carry; a
    synthetic sweep (no device) takes any numpy dtype, as JAX's does."""
    from tpu_perf_torch.ops.collectives import DTYPES

    if dtype in DTYPES:
        return DTYPES[dtype].itemsize
    if not probed:
        import numpy as np

        try:
            return np.dtype(dtype).itemsize
        except TypeError:
            pass
    raise ValueError(f"unsupported dtype {dtype!r}; supported: "
                     f"{sorted(DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ProbeProgram:
    """One probe program's host half: the permutation, and the sim
    world's row permutation as an index table on the host.  Touches no
    device, so the precompile worker may build it."""

    perm: tuple[tuple[int, int], ...]
    src: torch.Tensor
    dst: torch.Tensor

    @classmethod
    def build(cls, perm) -> "ProbeProgram":
        perm = tuple((int(s), int(d)) for s, d in perm)
        return cls(perm=perm,
                   src=torch.tensor([s for s, _ in perm], dtype=torch.long),
                   dst=torch.tensor([d for _, d in perm], dtype=torch.long))


#: untimed runs of each probe before its samples: a new step's first
#: exchanges carry the channel's ramp (gloo and NCCL set up a pair's
#: buffers over its first few sends; in a gloo world of 3 the first three
#: samples after one warm-up ran 2-13x the rest), which the mean of a few
#: samples would otherwise carry into the grade.  JAX warms up once, for
#: its compile; a probe's ramp on a TPU ends there.
PROBE_WARMUP_RUNS = 3


class LinkProber:
    """Drive a plan's schedules; collect per-link samples."""

    def __init__(
        self,
        world=None,
        *,
        nbytes: int,
        iters: int = 1,
        runs: int = 5,
        fence: str = "block",
        dtype: str = "float32",
        warmup_runs: int = PROBE_WARMUP_RUNS,
        injector=None,   # tpu_perf_torch.faults.FaultInjector or None
        n_devices: int | None = None,  # synthetic mode (world is None)
        perf_clock: Callable[[], float] = time.perf_counter,
        precompile: int = 0,  # build this many upcoming probe programs'
        #                       host halves on a worker thread while the
        #                       current probe measures (0 = inline); the
        #                       walk order, warm-ups and sample stream
        #                       are unchanged
        tracer=None,  # spans.SpanTracer: each schedule walk becomes a
        #               probe_schedule span
        err=None,
    ):
        if world is None and not (injector is not None and injector.synthetic):
            raise ValueError(
                "a world is required unless a synthetic injector supplies "
                "the timing source"
            )
        if world is None and n_devices is None:
            raise ValueError("synthetic mode needs an explicit n_devices")
        if fence not in PROBE_FENCES:
            raise ValueError(
                f"linkmap fence must be one of {PROBE_FENCES}, got "
                f"{fence!r} (per-link probes are single timed calls; the "
                "slope/trace pair protocol does not apply)"
            )
        if runs < 1:
            raise ValueError(f"runs must be >= 1, got {runs}")
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if precompile < 0:
            raise ValueError(
                f"precompile must be >= 0 (0 = inline), got {precompile}"
            )
        self.world = world
        # round the message size up to the dtype grid ONCE: the fault
        # matcher, the synthetic series key and the durable records must
        # all see the SAME nbytes, or a fault spec built from the records
        # never fires
        itemsize = _itemsize(dtype, probed=world is not None)
        self.elems = max(1, -(-nbytes // itemsize))
        self.nbytes = self.elems * itemsize
        self.iters = iters
        self.runs = runs
        self.fence = fence
        self.dtype = dtype
        self.warmup_runs = max(0, warmup_runs)
        self.injector = injector
        self.perf_clock = perf_clock
        self.precompile = precompile
        if tracer is None:
            from tpu_perf_torch.spans import NULL_TRACER

            tracer = NULL_TRACER
        self.tracer = tracer
        self.err = err
        self.n = world.n if world is not None else int(n_devices)
        self._run_id = 0
        self._example: torch.Tensor | None = None

    # -- attribution ---------------------------------------------------

    @property
    def _dist(self) -> bool:
        from tpu_perf_torch.world import is_dist

        return self.world is not None and is_dist(self.world)

    def _device_ranks(self) -> list[int]:
        """Each flat index's owning rank: its own in a multi-process
        world (the mesh lays ranks out row-major), 0 for every sim rank
        (one process holds them all) and in synthetic mode."""
        return list(range(self.n)) if self._dist else [0] * self.n

    def _host_of(self, rank: int) -> str:
        if not self._dist or rank == self.world.rank:
            return socket.gethostname()
        return f"rank{rank}"

    # -- device-side plumbing (never touched in synthetic mode) --------

    def example_input(self) -> torch.Tensor:
        """The make_fill input of ``elems`` a rank, made once on the main
        thread: the sim world's ``(n, elems)`` rows, or this rank's
        ``(elems,)``."""
        if self._example is None:
            from tpu_perf_torch.ops.collectives import example_input

            self._example = example_input(self.world, self.elems, self.dtype)
        return self._example

    def _bind(self, program: ProbeProgram) -> Callable[[torch.Tensor],
                                                       torch.Tensor]:
        """The device half of a probe program, on the main thread: the
        step that runs ``iters`` chained ppermutes of its permutation."""
        iters = self.iters
        if self._dist:
            from tpu_perf_torch.ops.collectives import _ppermute

            world, perm = self.world, list(program.perm)

            def step(x):
                for _ in range(iters):
                    x = _ppermute(world, x, perm)
                return x

            return step
        device = self.world.device
        src, dst = program.src.to(device), program.dst.to(device)

        def step(x):
            for _ in range(iters):
                out = torch.zeros_like(x)
                out[dst] = x[src]
                x = out
            return x

        return step

    def step(self, perm) -> Callable[[torch.Tensor], torch.Tensor]:
        """The probe step of one permutation (host and device halves built
        here): ``iters`` chained ppermutes of :meth:`example_input`."""
        return self._bind(ProbeProgram.build(perm))

    def _step_for(self, perm, pipe, unit: int):
        if pipe is None:
            return self.step(perm)
        return self._bind(pipe.get(unit))

    # -- measurement ---------------------------------------------------

    def _timed(self, step) -> float:
        from tpu_perf_torch.timing import fence as fence_fn

        x = self.example_input()
        t0 = self.perf_clock()
        fence_fn(step(x), self.fence)
        return self.perf_clock() - t0

    def _measure(self, step) -> list[float]:
        """``runs`` fenced samples of one step after its warm-up runs
        (which absorb a pair's lazily made channel), each the maximum
        over the ranks, reduced after the last run."""
        for _ in range(self.warmup_runs):
            self._timed(step)
        raw = [self._timed(step) for _ in range(self.runs)]
        if self._dist:
            raw = self.world.max_over_ranks(raw)
        return raw

    def _inject(self, op: str, run_id: int, t: float | None,
                rank: int) -> float | None:
        if self.injector is None:
            return t
        return self.injector.apply(op, self.nbytes, run_id, t, rank=rank)

    def probe(self, schedules: list[Schedule], *,
              concurrent: bool = False) -> LinkMapResult:
        """Run the plan; returns the filled matrix model."""
        from tpu_perf_torch.compilepipe import CompilePipeline

        ranks = self._device_ranks()
        results: list[ProbeResult] = []
        synthetic = self.injector is not None and self.injector.synthetic
        # a synthetic sweep has no shared batch to time, so it is always
        # the exact serial measurement — and its records must SAY so
        concurrent = concurrent and not synthetic
        pipe = None
        if not synthetic and self.precompile > 0:
            perms = ([sched.perm() for sched in schedules] if concurrent
                     else [[(p.src, p.dst)]
                           for sched in schedules for p in sched.probes])
            pipe = CompilePipeline(
                lambda i: ProbeProgram.build(perms[i]),
                list(range(len(perms))), depth=self.precompile,
                tracer=self.tracer, err=self.err,
            )
        unit = 0  # walk-order index into the build plan
        try:
            for si, sched in enumerate(schedules):
                # one span per schedule walk: the sweep's unit of
                # progress, and the join key its probe records carry
                with self.tracer.span("probe_schedule", index=si,
                                      probes=len(sched.probes)) as sid:
                    if concurrent:
                        step = self._step_for(sched.perm(), pipe, unit)
                        unit += 1
                        results.extend(self._probe_concurrent(
                            sched, ranks, step, span_id=sid))
                        continue
                    for probe in sched.probes:
                        rank = ranks[probe.src]
                        first = self._run_id + 1
                        if synthetic:
                            raw = [self.injector.synthetic_sample(
                                probe.op, self.nbytes)
                                for _ in range(self.runs)]
                        else:
                            step = self._step_for([(probe.src, probe.dst)],
                                                  pipe, unit)
                            unit += 1
                            raw = self._measure(step)
                        samples, dropped = [], 0
                        for t in raw:
                            self._run_id += 1
                            t = self._inject(probe.op, self._run_id, t, rank)
                            if t is None:
                                dropped += 1
                            else:
                                samples.append(t)
                        results.append(ProbeResult(
                            probe=probe, rank=rank, host=self._host_of(rank),
                            samples=samples, dropped=dropped,
                            first_run=first, last_run=self._run_id,
                            iters=self.iters, nbytes=self.nbytes,
                            span_id=sid,
                        ))
        finally:
            if pipe is not None:
                pipe.close()
        shape, axes = self._plan_shape(schedules)
        return LinkMapResult(
            n=self.n, shape=shape, axes=axes,
            nbytes=self.nbytes, iters=self.iters, runs=self.runs,
            fence=self.fence, concurrent=concurrent, synthetic=synthetic,
            probes=results,
        )

    def _probe_concurrent(self, sched: Schedule, ranks: list[int],
                          step, span_id: str = "") -> list[ProbeResult]:
        """One ppermute drives the whole schedule; the batch time is
        attributed to every probe in it (upper bound per link)."""
        raw = self._measure(step)
        acc = {p: ([], 0) for p in sched.probes}  # samples, dropped
        first = self._run_id + 1
        for t in raw:
            self._run_id += 1
            for p in sched.probes:
                tp = self._inject(p.op, self._run_id, t, ranks[p.src])
                samples, dropped = acc[p]
                if tp is None:
                    acc[p] = (samples, dropped + 1)
                else:
                    samples.append(tp)
        return [
            ProbeResult(
                probe=p, rank=ranks[p.src], host=self._host_of(ranks[p.src]),
                samples=samples, dropped=dropped,
                first_run=first, last_run=self._run_id,
                iters=self.iters, nbytes=self.nbytes, span_id=span_id,
            )
            for p, (samples, dropped) in acc.items()
        ]

    def bisect_flagged(self, result: LinkMapResult,
                       config=None) -> tuple[LinkMapResult, int]:
        """Concurrent-mode auto-bisection: re-probe every flagged link
        serially, with its grading peers, then let the caller grade the
        merged result.

        A concurrent sweep attributes each schedule's BATCH wall to every
        probe in it, so one sick link drags its whole schedule.  Grade
        the concurrent result, take every non-ok link, and re-measure
        just those, and the row/col peers each is graded against, as
        one-probe serial schedules — O(flagged × peers), not O(links).
        The peers go with it because a batch wall is no serial time: in
        the sim world and across gloo or NCCL processes a batch moves its
        links one after another on shared engines, so it takes several
        times one link's serial time, more on a loaded host, and a serial
        sample graded against batch bounds looks faster than it is (a
        100x link graded ``slow``, not ``dead``).  Returns ``(merged
        result, flagged count)``; the merged result keeps
        ``concurrent=True`` (the links not re-probed are still batch
        bounds) while the re-probed links carry exact serial samples.
        No-op (count 0) for serial/synthetic results and for sweeps
        grading clean.  Every rank grades the same reduced samples, so
        every rank re-probes the same links in the same order.
        """
        if not result.concurrent:
            return result, 0
        from tpu_perf_torch.linkmap.grade import grade, peer_links

        flagged = {(v.src, v.dst) for v in grade(result, config)
                   if v.verdict != "ok"}
        if not flagged:
            return result, 0
        again = flagged | peer_links(result, flagged, config)
        merged: list[ProbeResult] = []
        for r in result.probes:
            if (r.probe.src, r.probe.dst) not in again:
                merged.append(r)
                continue
            sub = self.probe(
                [Schedule(name=f"bisect[{r.probe.axis}]",
                          probes=(r.probe,))],
                concurrent=False,
            )
            merged.extend(sub.probes)
        return dataclasses.replace(result, probes=merged), len(flagged)

    @staticmethod
    def _plan_shape(schedules: list[Schedule]):
        """Recover (shape, axes) labels from the plan for the meta
        record: neighbor plans carry coords; all-pairs plans are flat."""
        axes, dims = [], []
        for s in schedules:
            for p in s.probes:
                if p.axis not in axes:
                    axes.append(p.axis)
                for c_list in (p.src_coords, p.dst_coords):
                    while len(dims) < len(c_list):
                        dims.append(0)
                    for i, c in enumerate(c_list):
                        dims[i] = max(dims[i], c + 1)
        return tuple(dims), tuple(axes)
