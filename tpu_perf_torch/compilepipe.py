"""Compile pipeline: the host half of each point's build on a worker
thread, and the harness' own phase split (port of
``tpu_perf/compilepipe.py``).

A wide sweep spends part of its wall time building, not measuring.  On
the card "compile" is the host work of a build: the first-use ``nvcc``
build of a kernel source (``kernels/_build.py``), Triton's JIT, and host
constants (``mxu_gemm``'s orthogonal matrix), then the op's closures and
its example input.  Three pieces:

* :class:`CompilePipeline` walks the sweep plan ahead of the measurement
  loop on ONE worker thread, running a build callable on each upcoming
  point's :class:`CompileSpec`, at most ``depth`` points ahead.  The
  driver's callable (:func:`prepare`) touches no CUDA API: it runs
  ``nvcc`` for the op's sources and computes host constants.  Everything
  that launches a kernel or allocates on the card (the example input's
  fill, warm-up runs, CUDA-graph captures) stays on the main thread, in
  plan order, so execution order, and a multi-process world's collective
  order, is the serial engine's, and no capture on the main thread can
  meet a CUDA call from the worker.
* :class:`PhaseTimer` accumulates ``compile`` / ``measure`` / ``log``
  seconds from any thread (the worker adds its builds to ``compile``, so
  under pipelining ``compile_s + measure_s`` can exceed the wall clock:
  that excess is the overlap won).  The totals ride the JSON heartbeat,
  the ``phase-<job>-<rank>.json`` sidecar, ``report`` and ``bench``.
* :func:`enable_compile_cache` points the kernel build directory and
  Triton's cache at one directory, so a second process builds nothing.

Keying: a point's build is identified by its full :class:`CompileSpec`;
equal specs are built once and served to every consumer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time
from collections import Counter
from typing import Callable, Hashable, Iterable


@dataclasses.dataclass(frozen=True)
class CompileSpec:
    """The full build identity of one sweep point: two points build the
    same step iff every field matches.  ``axis`` is normalized to a tuple
    (or None) so the str / tuple spellings of one axis hash alike.  The
    fields are the JAX package's; ``world`` adds what the port's builds
    also depend on (the world's rank count, backend and device).
    """

    op: str
    nbytes: int
    iters: int
    dtype: str = "float32"
    axis: tuple[str, ...] | None = None
    window: int = 1
    #: the fused fence's chunk-size set (sorted distinct reps values of
    #: the point's chunk plan; () = not a fused build).  Load-bearing
    #: like every other field: each distinct reps value is its own XLA
    #: program (a different outer trip count), so two jobs whose plans
    #: differ must never share a cache entry.
    fused: tuple[int, ...] = ()
    #: the collective decomposition (tpu_perf.arena; "native" = the XLA
    #: lowering).  Load-bearing: an arena step is a DIFFERENT program
    #: at the same (op, nbytes, iters) — two algorithms racing the same
    #: point must never share a precompiled pair.  Scenario points
    #: carry the scenario label here under op="scenario".
    algo: str = "native"
    #: the v-variant/scenario per-rank payload ratio (tpu_perf.
    #: scenarios, --imbalance; 1 = balanced).  Load-bearing: the counts
    #: are baked into the schedule, so two ratios at one (op, nbytes)
    #: are two different programs.
    imbalance: int = 1
    #: contention-role coordinates (tpu_perf.streams.contend).  The
    #: ordinary overlapped sweep leaves both at their defaults — a lane
    #: runs the SAME program the serial sweep would, so stream must NOT
    #: split the cache there.  The contend runner sets them: a victim
    #: and a load generator that happen to share (op, nbytes) are
    #: different build identities (``load`` names the race; ``stream``
    #: separates K split-channel siblings whose ppermute schedules
    #: differ per lane).
    stream: int = 0
    load: str = ""
    #: the world a step is built in, ``kind/ranks/device`` ("sim/8/cuda",
    #: "dist/4/cuda"): the
    #: kernels, the rows' rank count and the example input's layout
    #: depend on it
    world: str = ""

    @staticmethod
    def normalize_axis(axis) -> tuple[str, ...] | None:
        if axis is None:
            return None
        if isinstance(axis, str):
            return (axis,)
        return tuple(axis)

    @classmethod
    def make(cls, op: str, nbytes: int, iters: int, *, dtype: str = "float32",
             axis=None, window: int = 1,
             fused: tuple[int, ...] = (),
             algo: str = "native",
             imbalance: int = 1,
             stream: int = 0,
             load: str = "",
             world: str = "") -> "CompileSpec":
        return cls(op=op, nbytes=nbytes, iters=iters, dtype=dtype,
                   axis=cls.normalize_axis(axis), window=window,
                   fused=tuple(sorted(set(fused))), algo=algo,
                   imbalance=imbalance, stream=stream, load=load,
                   world=world)


class PhaseTimer:
    """Accumulates per-phase wall time: where does the harness spend it?

    Phases are ``compile`` (kernel builds, the op's closures and example
    input, warm-up runs and graph captures -- everything a point needs
    before its first timed sample), ``measure``
    (the timed windows themselves), and ``log`` (rotation, row emission,
    heartbeats, health/injection bookkeeping).  ``add`` is thread-safe:
    the precompile worker contributes its build durations to ``compile``
    from its own thread, so the total is compile WORK done, not
    main-thread time -- under pipelining ``compile_s`` can exceed its
    share of the wall clock, which is the overlap made visible.
    """

    PHASES = ("compile", "measure", "log")

    def __init__(self, perf_clock: Callable[[], float] = time.perf_counter):
        self._clock = perf_clock
        self._lock = threading.Lock()
        self._totals = {name: 0.0 for name in self.PHASES}
        self._started: float | None = None
        self._wall = 0.0

    def start(self) -> None:
        """Open the wall-clock window (idempotent while open)."""
        if self._started is None:
            self._started = self._clock()

    def stop(self) -> None:
        if self._started is not None:
            self._wall += self._clock() - self._started
            self._started = None

    @property
    def wall_s(self) -> float:
        extra = 0.0 if self._started is None else self._clock() - self._started
        return self._wall + extra

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(name, self._clock() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + seconds

    def snapshot(self) -> dict[str, float]:
        """``{"compile_s": ..., "measure_s": ..., "log_s": ...}`` -- the
        shape the heartbeat, bench payload, and sidecar all carry."""
        with self._lock:
            return {f"{k}_s": round(v, 6) for k, v in self._totals.items()}


class CompilePipeline:
    """A background build thread over an ordered build plan.

    ``build(key)`` runs on ONE worker thread, at most ``depth`` plan
    entries ahead of what :meth:`get` has consumed (the look-ahead bound
    that caps resident example-buffer memory).  Equal keys build once:
    later occurrences are cache hits.  Build exceptions are captured and
    re-raised at the consumer's ``get`` -- the point that would have
    failed serially fails at the same place pipelined, and earlier
    points are unaffected.

    The worker must touch no CUDA API: ``build`` is host work only.
    Allocation, warm-up and capture belong to the consumer, on the main
    thread, in plan order, so execution order is the serial engine's.
    """

    def __init__(
        self,
        build: Callable[[Hashable], object],
        plan: Iterable[Hashable],
        *,
        depth: int = 2,
        phases: PhaseTimer | None = None,
        tracer=None,  # spans.SpanTracer: each worker build is a "build"
        #               span on the worker track
        err=None,
    ):
        if depth < 1:
            raise ValueError(f"look-ahead depth must be >= 1, got {depth}")
        self._build = build
        self._plan = list(plan)
        if tracer is None:
            from tpu_perf_torch.spans import NULL_TRACER

            tracer = NULL_TRACER
        self._tracer = tracer
        if not self._plan:
            raise ValueError("empty build plan")
        self._pending = Counter(self._plan)  # tpuperf: guarded-by(_cond)
        self._depth = depth  # tpuperf: guarded-by(_cond)
        self._phases = phases
        self._err = err if err is not None else sys.stderr
        self._cond = threading.Condition()
        # worker / consumer shared state: every touch outside __init__
        # holds _cond (`lint` rule R5 proves it at parse time)
        self._results: dict = {}  # tpuperf: guarded-by(_cond)
        self._consumed = 0  # tpuperf: guarded-by(_cond)
        self._closed = False  # tpuperf: guarded-by(_cond)
        self._done = False  # tpuperf: guarded-by(_cond)
        #: distinct keys actually built (equal specs hit, never rebuild)
        self.builds = 0  # tpuperf: guarded-by(_cond)
        #: the threads each build ran on (a CUDA-free worker's own)
        self.build_threads: set[int] = set()
        self._thread = threading.Thread(
            target=self._worker, name="tpu-perf-torch-precompile",
            daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        # worker-local dedup: _results is NOT a record of what was built
        # (get() prunes fully-consumed entries), so inferring "already
        # built" from it races the consumer — a pruned duplicate would
        # be rebuilt, breaking the build-once guarantee and leaking the
        # rebuilt artifact's buffers until close()
        built_keys: set = set()
        try:
            for i, key in enumerate(self._plan):
                with self._cond:
                    while (i - self._consumed >= self._depth
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        return
                if key in built_keys:
                    continue  # equal spec: cache hit, nothing rebuilt
                built_keys.add(key)
                ctx = (self._phases.phase("compile")
                       if self._phases is not None else contextlib.nullcontext())
                art, exc = None, None
                with ctx, self._span(key):
                    try:
                        art = self._build(key)
                    except BaseException as e:  # noqa: BLE001 -- surfaces
                        # at the consumer's get(), like a serial failure
                        exc = e
                with self._cond:
                    self.builds += 1
                    self.build_threads.add(threading.get_ident())
                    self._results[key] = (art, exc)
                    self._cond.notify_all()
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def _span(self, key):
        """The worker build's span; a CompileSpec-like key labels it
        (op, nbytes), anything else is carried as its repr."""
        op, nbytes = getattr(key, "op", None), getattr(key, "nbytes", None)
        if op is not None:
            return self._tracer.span("build", op=op, nbytes=nbytes)
        return self._tracer.span("build", key=repr(key))

    @property
    def depth(self) -> int:
        """Current look-ahead bound (live-tunable, see set_depth)."""
        with self._cond:
            return self._depth

    def set_depth(self, depth: int) -> None:
        """Re-bound the look-ahead mid-run (``--precompile auto``: the
        tuner grows / shrinks the window as the measured compile / measure
        ratio evolves).  Thread-safe; growing wakes a waiting worker
        immediately, shrinking only throttles FUTURE builds — artifacts
        already built stay resident until consumed (memory ratchets
        down one consume at a time, never by discarding work)."""
        if depth < 1:
            raise ValueError(f"look-ahead depth must be >= 1, got {depth}")
        with self._cond:
            self._depth = depth
            self._cond.notify_all()

    def get(self, key):
        """Block until ``key``'s artifact is ready; re-raises its build
        exception.  Consuming releases one look-ahead credit.  Artifacts
        are dropped once every plan occurrence of the key has been
        consumed, so the window's memory stays bounded."""
        with self._cond:
            if self._pending.get(key, 0) <= 0:
                raise KeyError(
                    f"{key!r} is not in the pipeline's plan (or already "
                    "fully consumed)"
                )
            while key not in self._results:
                if self._done or self._closed:
                    raise RuntimeError(
                        f"precompile worker exited before building {key!r}"
                    )
                self._cond.wait()
            art, exc = self._results[key]
            self._consumed += 1
            self._pending[key] -= 1
            if self._pending[key] <= 0 and exc is None:
                del self._results[key]  # free the look-ahead slot's memory
            self._cond.notify_all()
        if exc is not None:
            raise exc
        return art

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker (it finishes any in-flight build first)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            print("[tpu-perf-torch] precompile worker still busy at close "
                  "(daemon thread, will not block exit)", file=self._err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def enable_compile_cache(path: str) -> str:
    """Point the port's kernel build directory (``kernels._build``) and
    Triton's cache (``TRITON_CACHE_DIR``) at ``path`` (created if missing),
    so a second process finds every kernel built: a library is rebuilt
    only when it is older than its sources.  Must run before the first
    kernel builds (the Driver calls it first); both settings are
    process-wide, the precompile worker's builds included.  Returns
    ``path``."""
    from pathlib import Path

    from tpu_perf_torch.kernels import _build

    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path).resolve()
    os.environ["TRITON_CACHE_DIR"] = os.path.join(_build.BUILD_DIR, "triton")
    return path


def prepare(spec: CompileSpec) -> CompileSpec:
    """The host half of one point's build, the driver's pipeline callable:
    ``nvcc`` for the CUDA sources the op launches on its world's path
    (:func:`tpu_perf_torch.ops.pallas_ring.sources_for`; the stale ones,
    all started together) and the op's host constants.  It touches no
    CUDA API: no library is loaded, nothing is allocated or launched."""
    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.collectives import host_constants
    from tpu_perf_torch.ops.pallas_ring import sources_for

    kind, n, device = spec.world.split("/")
    if device == "cuda":
        _build.compile_sources(sources_for(spec.op, kind == "dist"))
    host_constants(spec.op, spec.nbytes, spec.dtype, int(n))
    return spec
