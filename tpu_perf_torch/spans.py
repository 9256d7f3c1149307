"""Span-based harness tracing (port of ``tpu_perf/spans.py``): what the
harness did, when, on which thread.

The record families (rows, health events, chaos ledger, phase sidecars)
say what was measured; spans say what the harness itself was doing
around each sample:

* ``job`` -> ``sweep`` -> ``point`` -> ``run`` mirror the driver's loop;
  every result row, health event and chaos ledger entry joins its
  enclosing ``run`` span exactly (:mod:`tpu_perf_torch.trace`);
* ``build`` (the compile pipeline's worker builds, on the worker thread,
  or inline on the main one), ``warmup``, ``measure`` and ``fence`` (the
  timed window and its fence wait), ``stop_vote`` (the adaptive
  engine's collective), ``rotate`` and ``ingest_hook`` (log rotations
  and the hook they fire), ``inject`` (fault injections that fired),
  ``heartbeat`` (the stats boundary, a barrier across ranks) and
  ``dispatch`` / ``stream_fence`` (the stream engine's lanes).

Spans carry ``(job_id, span_id, parent_id, rank, thread, t_start_ns,
dur_ns, kind, attrs)`` and stream to the ``spans-*.log`` family
(schema.SPANS_PREFIX): JSONL, lazy ``.open``, swept by the ingest pass.
The record bytes are the JAX package's, so its readers and this
package's read either package's spans.

Determinism: span IDs come from per-(rank, thread-lane) counters (``m<N>``
main thread, ``w<N>`` precompile worker, ``r<N>`` run spans, ``s<id>.<N>``
stream lanes), never from the clock.  The tracer enters no collective and
writes no other family, so rows and chaos ledgers are byte-identical with
tracing on or off.  Off, the driver holds :data:`NULL_TRACER`: no clock
reads, no allocation, no bytes.

One difference from the JAX tracer, in when a record is written and never
in what it holds: a span opened with ``defer=True`` (the block fence's
wait, the stream engine's dispatch and fence) closes inside a host-timed
window, so its record is queued and written by :meth:`SpanTracer.flush`,
which the caller runs after the window's end clock read.  A JSONL write
is microseconds, and a 4 KiB run on the card is tens of them.
"""

from __future__ import annotations

import contextlib
import threading
import time

from tpu_perf_torch.schema import JsonlRecord


class SpanRecord(JsonlRecord):
    """One ``spans-*.log`` JSONL line (schema.JsonlRecord: duck-typed
    row, lazy-family mechanics shared with the health/chaos/linkmap
    families).  One record type, ``record="span"``, written when the
    span CLOSES (dur_ns is known then); a killed run's open spans are
    simply absent, never torn mid-schema."""

    __slots__ = ()
    FAMILY = "spans"


#: the compile pipeline's worker thread name (compilepipe.CompilePipeline)
WORKER_THREAD_NAME = "tpu-perf-torch-precompile"

#: kinds the daemon sampling policy (--spans-sample N) never drops:
#: ``run`` spans anchor the cross-family joins (a sampled-out run whose
#: row pointed at an unwritten span would fail the join check),
#: rotations / ingest passes / fired injections are exactly the sparse
#: events the span family exists to correlate against, and
#: ``heartbeat`` spans are the clock-alignment anchors (one per
#: stats_every runs — sampling them out would leave a soak's timeline
#: unalignable).  Error spans are likewise always kept regardless of
#: kind.
SAMPLE_KEEP_KINDS = frozenset(("run", "rotate", "ingest_hook", "inject",
                               "heartbeat"))


def _default_perf_ns() -> int:
    # tpuperf: allow-clock(injectable default only — every determinism consumer passes perf_ns; span IDs come from lane counters, never this clock)
    return time.perf_counter_ns()


class _NullContext:
    """Reusable no-op context yielding ``""`` (the null span id)."""

    __slots__ = ()

    def __enter__(self) -> str:
        return ""

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullContext()


class NullTracer:
    """The tracing-off stand-in: every operation is a no-op.  The driver
    holds one of these instead of ``None`` so the hot path never
    branches on tracer presence — and never reads a clock, allocates a
    span, or writes a byte while tracing is off."""

    enabled = False
    records = None

    def span(self, kind: str, *, defer: bool = False, **attrs):
        return _NULL_CTX

    def run_span(self, run_id: int, **attrs):
        return _NULL_CTX

    def stream_span(self, stream_id: int, kind: str, *,
                    defer: bool = False, **attrs):
        return _NULL_CTX

    def emit_run(self, run_id: int, t_start_ns: int, dur_ns: int,
                 **attrs) -> str:
        return ""

    def now(self) -> int:
        return 0

    def emit(self, kind: str, t_start_ns: int, dur_ns: int, **attrs) -> None:
        pass

    def set_anchor(self, span_id: str | None) -> None:
        pass

    def wrap_hook(self, hook):
        return hook

    def flush(self) -> None:
        pass

    def maybe_rotate(self) -> None:
        pass

    def close(self) -> None:
        pass


#: the shared inert tracer (stateless, so one instance serves every user)
NULL_TRACER = NullTracer()


class SpanTracer:
    """Per-process span recorder.

    ``log`` is a RotatingCsvLog (``prefix=schema.SPANS_PREFIX``,
    ``lazy=True``) or None; ``retain=True`` additionally keeps every
    record dict in :attr:`records` (finite runs / tests — a daemon must
    not grow without bound).  ``perf_ns`` is injectable so tests drive
    a deterministic clock and the timeline golden is byte-stable.

    Parentage is a per-thread span stack; spans opened on a thread with
    an empty stack (the precompile worker) parent to the *anchor* — the
    sweep span the driver registers — so worker builds nest under the
    sweep they serve.  IDs come from per-thread-lane counters (``m``
    main, ``w`` worker, ``t<n>`` others) plus a dedicated ``r`` lane
    for run spans: deterministic per lane regardless of cross-thread
    interleaving, unique per (job_id, rank) by construction.
    """

    enabled = True

    def __init__(
        self,
        job_id: str,
        rank: int = 0,
        *,
        log=None,
        retain: bool = False,
        perf_ns=None,
        sample: int = 1,
    ):
        if sample < 1:
            raise ValueError(f"sample must be >= 1, got {sample}")
        self.job_id = job_id
        self.rank = rank
        self.log = log
        self.records: list[dict] | None = [] if retain else None
        self._perf_ns = perf_ns if perf_ns is not None else _default_perf_ns
        self._lock = threading.Lock()
        self._local = threading.local()
        self._lanes: dict[str, int] = {}
        self._run_seq = 0
        self._anchor: str | None = None
        self._foreign_lanes = 0
        # records of deferred spans (span(defer=True)) awaiting flush()
        self._deferred: list[tuple] = []
        #: --spans-sample N: keep every Nth run's full span tree; the
        #: other runs keep their run span (the join anchor) while child
        #: spans are suppressed — SAMPLE_KEEP_KINDS and error spans
        #: always survive.  1 = keep everything.
        self.sample = sample

    # -- identity -------------------------------------------------------

    def _lane(self) -> str:
        t = threading.current_thread()
        if t is threading.main_thread():
            return "m"
        if t.name == WORKER_THREAD_NAME:
            return "w"
        lane = getattr(self._local, "lane", None)
        if lane is None:
            with self._lock:
                self._foreign_lanes += 1
                lane = self._local.lane = f"t{self._foreign_lanes}"
        return lane

    def _thread_label(self) -> str:
        lane = self._lane()
        return {"m": "main", "w": "worker"}.get(lane, lane)

    def _next_id(self, lane: str) -> str:
        with self._lock:
            n = self._lanes.get(lane, 0) + 1
            self._lanes[lane] = n
        return f"{lane}{n}"

    # -- the span surface ----------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def now(self) -> int:
        return self._perf_ns()

    def set_anchor(self, span_id: str | None) -> None:
        """Default parent for spans opened on a stack-less thread (the
        precompile worker's builds nest under the sweep span)."""
        self._anchor = span_id

    @contextlib.contextmanager
    def span(self, kind: str, *, span_id: str | None = None,
             defer: bool = False, **attrs):
        """Open a nested span; yields its id, emits the record on close
        (exceptions still close — and mark — the span).  ``defer=True``
        queues the record at the close instead, for :meth:`flush` to
        write once the caller's timed window has ended; the record is
        the one an undeferred span would write."""
        sid = span_id if span_id is not None else self._next_id(self._lane())
        stack = self._stack()
        parent = stack[-1] if stack else self._anchor
        thread = self._thread_label()
        t0 = self._perf_ns()
        stack.append(sid)
        error = False
        try:
            yield sid
        except BaseException:
            error = True
            raise
        finally:
            stack.pop()
            if error:
                attrs = dict(attrs, error=True)
            rec = (sid, parent, kind, thread, t0, self._perf_ns() - t0,
                   attrs)
            if not defer:
                self._write(*rec)
            elif self._kept(kind, attrs):
                # judged at the close: flush() may run outside the run
                # span whose sampling decided it
                self._deferred.append(rec)

    def _next_run_id(self) -> str:
        with self._lock:
            self._run_seq += 1
            return f"r{self._run_seq}"

    @contextlib.contextmanager
    def run_span(self, run_id: int, **attrs):
        """One measured run's span.  IDs ride a dedicated ``r`` lane (a
        finite sweep restarts ``run_id`` per point, so the lane counter
        — not the run_id — keeps them unique); the record's ``run_id``
        attr is the join key the row/event/ledger streams share.

        Under the daemon sampling policy (``sample`` > 1) only every
        Nth run keeps its child spans (measure/fence/stop_vote); the
        run span itself and SAMPLE_KEEP_KINDS/error spans are always
        written."""
        sid = self._next_run_id()
        sampled_out = self.sample > 1 and (run_id - 1) % self.sample != 0
        with self.span("run", span_id=sid, run_id=run_id, **attrs) as s:
            prev = getattr(self._local, "suppress", False)
            self._local.suppress = prev or sampled_out
            try:
                yield s
            finally:
                self._local.suppress = prev

    def stream_span(self, stream_id: int, kind: str, *,
                    defer: bool = False, **attrs):
        """A span on a dispatch-stream lane (tpu_perf_torch.streams): IDs
        ride a per-stream ``s<id>.`` counter lane — ``s0.1``, ``s1.3``
        — deterministic per stream regardless of how K in-flight lanes
        interleave on the dispatching thread, and unambiguous against
        the ``m``/``w``/``t<n>``/``r`` lanes (the ``.`` separator keeps
        ``s1`` lane 1's counter from colliding with a hypothetical
        ``s11`` lane).  The record carries ``stream`` so the trace
        export can give each lane its own track."""
        return self.span(kind, span_id=self._next_id(f"s{stream_id}."),
                         defer=defer, stream=stream_id, **attrs)

    def emit_run(self, run_id: int, t_start_ns: int, dur_ns: int,
                 **attrs) -> str:
        """Record one run span retroactively with explicit geometry —
        the batched-capture fences (fused, trace) learn per-run
        durations only AFTER the dispatch, so their run spans are laid
        out from the extractor's times instead of wrapping a per-run
        host window (which would be near-zero for every batched run).
        Returns the span id for row/event stamping; parent is the
        current stack top (the enclosing point span)."""
        sid = self._next_run_id()
        stack = self._stack()
        parent = stack[-1] if stack else self._anchor
        self._write(sid, parent, "run", self._thread_label(),
                    t_start_ns, dur_ns, dict(attrs, run_id=run_id))
        return sid

    def emit(self, kind: str, t_start_ns: int, dur_ns: int, **attrs) -> None:
        """Record a span retroactively (the caller timed it itself —
        rotations and injections are only spans when they actually
        happened).  Parent is the current stack top."""
        stack = self._stack()
        parent = stack[-1] if stack else self._anchor
        self._write(self._next_id(self._lane()), parent, kind,
                    self._thread_label(), t_start_ns, dur_ns, dict(attrs))

    def wrap_hook(self, hook):
        """Trace the rotation ingest hook (the driver wires this
        OUTSIDE the chaos wrapper, so injected hook failures are spans
        too, marked ``error``)."""
        if hook is None:
            return None

        def traced_hook():
            t0 = self._perf_ns()
            try:
                hook()
            except BaseException:
                self.emit("ingest_hook", t0, self._perf_ns() - t0,
                          error=True)
                raise
            self.emit("ingest_hook", t0, self._perf_ns() - t0)

        return traced_hook

    # -- persistence ----------------------------------------------------

    def _kept(self, kind: str, attrs: dict) -> bool:
        """False for a sampled-out run's child span: volume control for
        week-long soaks (--spans-sample).  Anchors (run spans), the
        always-keep kinds and error spans are always kept."""
        return (not getattr(self._local, "suppress", False)
                or kind in SAMPLE_KEEP_KINDS or bool(attrs.get("error")))

    def _write(self, span_id: str, parent: str | None, kind: str,
               thread: str, t_start_ns: int, dur_ns: int,
               attrs: dict) -> None:
        if self._kept(kind, attrs):
            self._persist(span_id, parent, kind, thread, t_start_ns,
                          dur_ns, attrs)

    def _persist(self, span_id: str, parent: str | None, kind: str,
                 thread: str, t_start_ns: int, dur_ns: int,
                 attrs: dict) -> None:
        rec = {
            "record": "span",
            "job_id": self.job_id,
            "span_id": span_id,
            "parent_id": parent,
            "rank": self.rank,
            "thread": thread,
            "t_start_ns": int(t_start_ns),
            "dur_ns": int(dur_ns),
            "kind": kind,
            "attrs": attrs,
        }
        with self._lock:
            if self.records is not None:
                self.records.append(rec)
            if self.log is not None:
                self.log.write_row(SpanRecord(**rec))

    def flush(self) -> None:
        """Write the deferred spans' records, in the order they closed."""
        while self._deferred:
            self._persist(*self._deferred.pop(0))

    def maybe_rotate(self) -> None:
        if self.log is not None:
            with self._lock:
                self.log.maybe_rotate()

    def close(self) -> None:
        self.flush()
        if self.log is not None:
            with self._lock:
                self.log.close()


def read_span_records(paths, *, err=None) -> list[dict]:
    """Parse ``spans-*.log`` files into span dicts (the torn-final-line
    policy is the shared JSONL one — health.events.read_jsonl)."""
    from tpu_perf_torch.health.events import read_jsonl

    recs = read_jsonl(paths, SpanRecord.from_json, err=err)
    return [r.data for r in recs if r.data.get("record") == "span"]
