"""The push plane's core (port of ``tpu_perf/push/plane.py``): bounded
tee queue + background sender.

Design constraints, in priority order:

1. **The measurement loop never blocks.**  ``tee`` is a non-blocking
   ``put_nowait`` into a bounded queue; when the queue is full the
   record is DROPPED — counted in a gauge and noted on stderr, never
   silent, and never a stall (the reference forks its uploader for the
   same reason, mpi_perf.c:363-364).
2. **Off means provably off.**  With ``--push`` absent the driver holds
   :data:`NULL_PUSHER` — no thread, no clock reads, no allocation, no
   bytes — the NULL_TRACER stance.  The chaos ledger is never teed even
   when the plane is on (sinks.TEE_FREE_FAMILIES), so ledger
   byte-identity holds with the plane in either state.
3. **Delivery is at-least-once, loss is always counted.**  The sender
   batches per family, retries failures with jittered exponential
   backoff, dead-letters exhausted batches to the on-disk spool
   (tpu_perf_torch.push.spool — requeue/replay via the ingest quarantine
   tooling), and closes by flushing-then-spooling so a finished soak
   never holds undelivered records only in memory.
4. **The plane observes itself.**  Cumulative sent/dropped/retried/
   spooled/replayed counters plus queue/spool/backoff gauges surface in
   the JSON heartbeat, the phase sidecar, the health exporter's
   textfile, and the plane's own live textfile sink; each delivery
   attempt is a ``push`` span in the harness trace when ``--spans`` is
   on.
"""

from __future__ import annotations

import os
import queue
import random
import sys
import threading
import time

from tpu_perf_torch.push import spool as _spool
from tpu_perf_torch.push.sinks import TEE_FREE_FAMILIES
from tpu_perf_torch.spans import NULL_TRACER

#: the sender thread's name — its spans land on their own foreign lane
#: (the span tracer assigns t<N> lanes to non-main, non-worker threads)
PUSH_THREAD_NAME = "tpu-perf-torch-push"

#: default tee-queue bound (records).  A heartbeat window's worth of
#: rows plus events plus spans fits comfortably; a sink outage longer
#: than the backoff window spools rather than growing memory.
DEFAULT_QUEUE = 10000


class NullPusher:
    """The push-plane-off stand-in: every operation a no-op, shared by
    every caller (the NULL_TRACER precedent — the hot path never
    branches on plane presence, and never pays a clock read or an
    allocation while the plane is off)."""

    enabled = False

    def tee_for(self, family: str):
        return None

    def tee(self, family: str, line: str) -> None:
        pass

    def totals(self) -> dict | None:
        return None

    def close(self) -> None:
        pass


#: the shared inert plane (stateless, one instance serves every user)
NULL_PUSHER = NullPusher()


class PushPlane:
    """One process's live telemetry push plane.

    ``sinks`` is the delivery list (usually one :class:`HttpSink`; an
    empty list with a ``textfile`` makes the plane a pure live-meter
    surface).  ``spool_dir`` (normally the logfolder) enables the
    dead-letter spool; without it, exhausted batches are dropped —
    counted, with a note.  ``clock``/``jitter`` are injectable so the
    backoff schedule is testable deterministically; ``start=False``
    skips the background thread for tests that drive :meth:`_cycle`
    by hand.
    """

    enabled = True

    def __init__(
        self,
        sinks,
        *,
        job_id: str,
        rank: int = 0,
        spool_dir: str | None = None,
        maxlen: int = DEFAULT_QUEUE,
        textfile=None,            # sinks.TextfileSink or None
        tracer=None,              # SpanTracer; settable after ctor
        err=None,                 # late-bound stderr
        clock=time.monotonic,
        jitter=random.random,
        flush_every: float = 0.25,
        max_attempts: int = 5,
        backoff_base: float = 0.25,
        backoff_max: float = 30.0,
        drop_note_every: int = 1000,
        replay_every: float = 5.0,
        start: bool = True,
    ):
        if maxlen < 1:
            raise ValueError(f"push queue bound must be >= 1, got {maxlen}")
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        self.sinks = list(sinks)
        self.job_id = job_id
        self.rank = rank
        self.spool_dir = spool_dir
        self.textfile = textfile
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.err = err
        self.clock = clock
        self.jitter = jitter
        self.flush_every = flush_every
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.drop_note_every = max(1, drop_note_every)
        self.replay_every = replay_every
        self._q: queue.Queue = queue.Queue(maxsize=maxlen)
        self._maxlen = maxlen
        self._lock = threading.Lock()          # meters + pending sizes
        self._cycle_lock = threading.Lock()    # sender vs close()
        self._meters = {"sent": 0, "dropped": 0, "retried": 0,
                        "spooled": 0, "replayed": 0}
        self._sent_by_family: dict[str, int] = {}
        self._pending: dict[str, list[str]] = {}
        self._attempts = 0       # consecutive failed flush cycles
        self._next_try = 0.0     # clock() before which no send happens
        self._seq = 0            # spool-file sequence, per plane
        self._last_replay: float | None = None
        self._replay_skip: set[str] = set()  # delivered, undeletable
        self._depth_cache: tuple[float, int] | None = None
        self._last_err_note = 0  # retried count at the last stderr note
        self._closed = False
        self._stop = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._run, name=PUSH_THREAD_NAME, daemon=True)
            self._thread.start()

    # -- the tee surface (measurement thread) ---------------------------

    def tee_for(self, family: str):
        """A bound tee callable for one family's RotatingCsvLog — or
        None for a tee-free family, so a mis-wired caller cannot tee
        the chaos ledger even by asking.  A sink-less plane
        (``--push-textfile`` alone) also tees nothing: it is a pure
        live-meter surface, and consuming records it can never deliver
        would inflate ``sent`` into a claim an operator might trust."""
        if not self.sinks or family in TEE_FREE_FAMILIES:
            return None
        return lambda line: self.tee(family, line)

    def tee(self, family: str, line: str) -> None:
        """Non-blocking enqueue; overflow drops are counted and noted,
        never silent, never a stall."""
        if not self.sinks or family in TEE_FREE_FAMILIES or self._closed:
            return
        try:
            self._q.put_nowait((family, line))
        except queue.Full:
            with self._lock:
                self._meters["dropped"] += 1
                n = self._meters["dropped"]
            if n == 1 or n % self.drop_note_every == 0:
                print(f"[tpu-perf-torch push] tee queue full: {n} record(s) "
                      "dropped so far (counted in "
                      "tpu_perf_push_dropped_total; raise --push-queue "
                      "or revive the sink)", file=self._stream(),
                      flush=True)

    # -- self-observation ----------------------------------------------

    def totals(self) -> dict:
        """The cumulative meter snapshot every surface renders (JSON
        heartbeat, phase sidecar, exporter gauges, report table)."""
        with self._lock:
            m = dict(self._meters)
            pending = sum(len(v) for v in self._pending.values())
        m["queued"] = self._q.qsize() + pending
        m["backoff"] = 1 if self.clock() < self._next_try else 0
        m["spool_depth"] = self._spool_depth()
        return m

    def _spool_depth(self) -> int:
        """The spool-depth gauge, cached: totals() runs every sender
        cycle AND every heartbeat, and a full listdir of a week-long
        soak's log folder 4x a second is exactly the overhead the
        plane's bench pins as noise-floor.  The cache invalidates on
        the plane's own spool/replay transitions (it owns every one),
        so depth changes it CAUSES are exact; a rescan every
        ``replay_every`` picks up foreign ones (an operator's requeue)."""
        cached = self._depth_cache
        now = self.clock()
        if cached is not None and now - cached[0] < self.replay_every:
            return cached[1]
        depth = _spool.spool_depth(self.spool_dir)
        self._depth_cache = (now, depth)
        return depth

    # -- the sender (background thread) --------------------------------

    def _stream(self):
        return self.err if self.err is not None else sys.stderr

    def _run(self) -> None:
        deadline = None  # end of the current batching window
        while True:
            timeout = (self.flush_every if deadline is None
                       else deadline - self.clock())
            try:
                item = self._q.get(timeout=max(0.0, timeout))
            except queue.Empty:
                item = None
            if item is not None:
                self._absorb(item)
                # batch the flush window out: the first record of a
                # window opens a flush_every deadline, the backlog is
                # absorbed in one slice, and later records pile into
                # the same per-family batches — so steady state sends
                # a few POSTs per window, never one per record (and a
                # tee burst never saws the GIL against the measurement
                # thread with per-record flush cycles)
                self._drain_queue()
                if deadline is None:
                    deadline = self.clock() + self.flush_every
                if not self._stop.is_set() and self.clock() < deadline:
                    continue
            self._cycle()
            deadline = None
            if self._stop.is_set() and self._q.empty() \
                    and not self._pending:
                return

    def _absorb(self, item) -> None:
        family, line = item
        with self._lock:
            self._pending.setdefault(family, []).append(line)

    def _drain_queue(self) -> None:
        while True:
            try:
                self._absorb(self._q.get_nowait())
            except queue.Empty:
                return

    def _cycle(self) -> None:
        """One sender cycle: drain the queue into per-family pending
        batches, flush when not backing off, replay spool when healthy,
        refresh the live textfile.  Callable synchronously in tests
        (``start=False``) with an injected clock."""
        with self._cycle_lock:
            self._drain_queue()
            now = self.clock()
            if self._pending:
                if now >= self._next_try:
                    self._flush()
                else:
                    with self._lock:
                        over = sum(len(v) for v in
                                   self._pending.values()) > self._maxlen
                    if over:
                        # an outage longer than the backoff covers must
                        # not grow memory without bound: dead-letter the
                        # backlog now rather than hold it
                        self._spool_pending()
            if self._attempts == 0 and not self._pending:
                # replay whenever the plane is healthy — including right
                # after a successful flush, so a busy daemon (records in
                # every window) still drains a requeued spool instead of
                # starving it until the soak's first idle cycle
                self._maybe_replay(now)
            self._write_textfile()

    def _flush(self) -> None:
        ok_all = True
        for family in sorted(self._pending):
            lines = self._pending[family]
            if self._send(family, lines):
                with self._lock:
                    self._meters["sent"] += len(lines)
                    self._sent_by_family[family] = \
                        self._sent_by_family.get(family, 0) + len(lines)
                    del self._pending[family]
            else:
                ok_all = False
                with self._lock:
                    self._meters["retried"] += 1
        if ok_all:
            self._attempts = 0
            self._next_try = 0.0
            return
        self._attempts += 1
        delay = min(self.backoff_max,
                    self.backoff_base * (2 ** (self._attempts - 1)))
        delay *= 0.5 + self.jitter()  # jitter: a fleet of senders must
        #                               not re-converge on a recovering
        #                               sink in lockstep
        self._next_try = self.clock() + delay
        if self._attempts >= self.max_attempts:
            self._spool_pending()
            self._attempts = 0

    def _send(self, family: str, lines: list[str]) -> bool:
        """Deliver one family batch through every sink; all must accept
        (delivery is at-least-once — a partial success is re-sent, and
        collectors key on the records' identity columns)."""
        t0 = self.tracer.now() if self.tracer.enabled else 0
        err_msg = None
        for sink in self.sinks:
            try:
                sink.send(family, lines)
            except Exception as e:  # noqa: BLE001 — every sink failure
                # is one retryable delivery failure; the sender owns
                # the policy
                err_msg = str(e)
                break
        if self.tracer.enabled:
            attrs = {"family": family, "lines": len(lines)}
            if err_msg:
                attrs["error"] = True
            self.tracer.emit("push", t0, self.tracer.now() - t0, **attrs)
        if err_msg is not None:
            with self._lock:
                retried = self._meters["retried"]
            if retried == self._last_err_note or \
                    retried - self._last_err_note >= 20:
                self._last_err_note = retried
                print(f"[tpu-perf-torch push] delivery failed for {len(lines)} "
                      f"{family} record(s): {err_msg} (retrying with "
                      "backoff; exhausted batches spool to disk)",
                      file=self._stream(), flush=True)
            return False
        return True

    def _spool_pending(self) -> None:
        """Dead-letter every pending batch (or drop, counted, when no
        spool dir exists — a push job without a logfolder has nowhere
        durable to put them)."""
        with self._lock:
            # snapshot under the meters lock: totals() iterates
            # _pending.values() from the measurement thread, and an
            # unlocked pop here would change the dict mid-iteration
            batches = [(f, self._pending.pop(f))
                       for f in sorted(self._pending)]
        for family, lines in batches:
            if not lines:
                continue
            if self.spool_dir is None:
                with self._lock:
                    self._meters["dropped"] += len(lines)
                print(f"[tpu-perf-torch push] no spool dir (push without a "
                      f"logfolder): {len(lines)} {family} record(s) "
                      "dropped after exhausted retries (counted)",
                      file=self._stream(), flush=True)
                continue
            self._seq += 1
            try:
                path = _spool.write_spool(
                    self.spool_dir, family, self.job_id, self.rank,
                    lines, seq=self._seq)
            except OSError as e:
                with self._lock:
                    self._meters["dropped"] += len(lines)
                print(f"[tpu-perf-torch push] spool write failed: {e} — "
                      f"{len(lines)} {family} record(s) dropped "
                      "(counted)", file=self._stream(), flush=True)
                continue
            self._depth_cache = None  # a file landed: re-gauge exactly
            with self._lock:
                self._meters["spooled"] += len(lines)
            print(f"[tpu-perf-torch push] dead-lettered {len(lines)} {family} "
                  f"record(s) to {path} (requeue with `tpu-perf-torch ingest "
                  "--requeue`, replay with `tpu-perf-torch push replay`)",
                  file=self._stream(), flush=True)

    def _maybe_replay(self, now: float) -> None:
        """Replay ONE live spool file per interval while healthy — a
        requeued dead letter flows back out without a dedicated tool,
        and one file per cycle keeps replay from starving live
        records."""
        if self.spool_dir is None or not self.sinks:
            return
        if self._last_replay is not None \
                and now - self._last_replay < self.replay_every:
            return
        self._last_replay = now
        files = [pf for pf in _spool.live_spool_files(self.spool_dir)
                 if pf[0] not in self._replay_skip]
        if not files:
            return
        path, family = files[0]
        try:
            lines = _spool.read_spool(path)
        except OSError:
            return  # raced another replayer; the next scan re-resolves
        if lines and not self._send(family, lines):
            with self._lock:
                self._meters["retried"] += 1
            return
        self._depth_cache = None  # a file leaves (or sticks): re-gauge
        try:
            os.remove(path)  # delete only after successful delivery
        except OSError as e:
            # the batch WAS delivered; a file that cannot be deleted
            # must not be replayed (and re-counted) every interval —
            # skip it for this plane's lifetime and tell the operator
            self._replay_skip.add(path)
            print(f"[tpu-perf-torch push] replayed spool {path} but could "
                  f"not delete it: {e} — remove it manually, or the "
                  "next plane will replay it again (at-least-once)",
                  file=self._stream(), flush=True)
        with self._lock:
            self._meters["replayed"] += len(lines)
            self._meters["sent"] += len(lines)
            self._sent_by_family[family] = \
                self._sent_by_family.get(family, 0) + len(lines)
        print(f"[tpu-perf-torch push] replayed {len(lines)} spooled {family} "
              f"record(s) from {path}", file=self._stream(), flush=True)

    def _write_textfile(self) -> None:
        if self.textfile is not None:
            with self._lock:
                by_family = dict(self._sent_by_family)
            self.textfile.write(by_family, self.totals())

    # -- teardown -------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Flush-then-spool teardown: stop the sender, attempt one
        final delivery of everything still queued, and dead-letter the
        remainder — a finished soak never holds undelivered records
        only in memory.  Never raises (the ingest-hook stance)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        with self._cycle_lock:
            self._drain_queue()
            if self._pending:
                self._next_try = 0.0  # the final attempt ignores backoff
                self._flush()
            if self._pending:
                self._spool_pending()
            self._write_textfile()
