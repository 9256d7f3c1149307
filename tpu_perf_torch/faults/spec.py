"""Fault-schedule format (port of ``tpu_perf/faults/spec.py``): what to
break, where, and when.

A chaos run is driven by a list of :class:`FaultSpec` entries — loaded
from JSON (``tpu-perf-torch chaos --faults spec.json``) or spelled inline
(``--fault kind:op:nbytes:start-end:magnitude``).  Each entry keys on
``(op, nbytes, run-window)`` in the daemon's GLOBAL run-id space: the
round-robin visit order is deterministic, so a window plus a point
filter names an exact set of measured runs, and the same spec + seed
always perturbs the same ones.

Fault kinds, and the detector each one must trip (the conformance
contract, :data:`EXPECTED_EVENT`):

====== =============================================================
kind    meaning -> expected detection
====== =============================================================
``delay``     every matching run slowed by ``magnitude`` relative
              (0.5 = +50%) -> ``regression`` health event
``jitter``    seeded multiplicative noise of amplitude ``magnitude``
              (``shape``: bounded ``uniform``, or heavy-tailed
              ``lognormal``/``pareto`` for realistic tail noise)
              -> nothing: detectors must NOT alert on noise (jitter
              entries are judged n/a, never missed)
``spike``     ONE matching run (the window's first) multiplied by
              ``magnitude`` -> ``spike`` health event
``flatline``  matching runs pinned to the window's first sample
              -> ``flatline`` health event
``drop_run``  matching runs dropped before recording (capture loss)
              -> ``capture_loss`` health event
``hook_fail`` the rotation ingest hook raises while the window is
              active (a rotation is forced at the window's first run
              so the failure is deterministic) -> ``hook_fail`` event
``corrupt``   one exponent bit of the op's selftest payload flipped
              -> a FAIL verdict from ``selftest``'s rx validation
``skew``      every matching run's ENTRY into the collective staggered
              by a seeded per-(rank, run) arrival delay of scale
              ``magnitude`` MICROSECONDS (``shape``: ``uniform`` =
              arrival anywhere in [0, magnitude); ``lognormal``/
              ``pareto`` reuse the heavy-tailed machinery for
              straggler tails).  Unlike ``delay`` — which perturbs the
              measured value after the fact — skew staggers the
              DISPATCH, so the collective observes imbalanced arrival
              (arXiv 1804.05349); on the synthetic timing source the
              victim's arrival-wait cost (modeled worst arrival minus
              own arrival) is folded into the sample so CI soaks see
              the same latency coupling real victims do
              -> ``regression`` health event on the VICTIM's rows
====== =============================================================

The injection ledger rides a fourth rotating-log family,
``chaos-*.log`` (schema.CHAOS_PREFIX): JSON lines like the health
events, lazy + ``.open`` suffixed like them, swept by the same ingest
pass.  Ledger records carry NO wall-clock timestamps — run_id is the
clock — so the acceptance contract "same seed + spec => identical
ledger" holds byte-for-byte across real runs.
"""

from __future__ import annotations

import dataclasses
import json

from tpu_perf_torch.schema import JsonlRecord

#: every fault kind the injector implements
FAULT_KINDS = (
    "delay", "jitter", "spike", "flatline", "drop_run", "hook_fail",
    "corrupt", "skew",
)

#: fault kind -> the health-event kind (or "selftest") that proves the
#: fault was caught; None = injected noise no detector should fire on.
#: The conformance harness (faults.conformance) judges against this map.
EXPECTED_EVENT = {
    "delay": "regression",
    "jitter": None,
    "spike": "spike",
    "flatline": "flatline",
    "drop_run": "capture_loss",
    "hook_fail": "hook_fail",
    "corrupt": "selftest",
    # skew is latency-coupled: the straggler's late entry inflates the
    # VICTIM ranks' samples, so the regression detector is the judge —
    # and the conformance join attributes detection to any rank's
    # events, not just the skewed rank's (a rank-filtered skew degrades
    # everyone ELSE's observed collective)
    "skew": "regression",
}

#: per-kind magnitude defaults (kinds absent here take no magnitude).
#: skew's magnitude is the arrival-spread scale in MICROSECONDS (the
#: repo's latency unit — lat_us, skew_us); 1000 = a 1 ms straggler.
DEFAULT_MAGNITUDE = {"delay": 1.0, "jitter": 0.2, "spike": 20.0,
                     "skew": 1000.0}

#: jitter noise shapes: ``uniform`` is the bounded multiplicative noise;
#: ``lognormal``/``pareto`` are the heavy-tailed models (seeded, like
#: everything else, and median-preserving — noise, not a level shift)
#: that exercise the zero-false-alarm gates and the linkmap MAD
#: thresholds against realistic tail noise instead of bounded noise — a
#: detector tuned only on uniform noise has never seen the
#: one-in-a-thousand 3x sample a real fabric produces.  Lognormal at
#: modest sigma (0.1) is the zero-false-alarm-gate shape;
#: pareto's power-law tail intentionally produces isolated multi-x
#: samples that ARE spikes semantically — the spike detector firing on
#: them is correct behavior, so pareto belongs in threshold-tuning
#: soaks, not in gates that allow no alarms.
JITTER_SHAPES = ("uniform", "lognormal", "pareto")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``op == "*"`` matches every op; ``nbytes == 0`` matches every size
    (the same wildcard conventions the health events use).  ``rank``
    restricts the fault to ONE process/host (None = every rank): a
    multi-host chaos run can degrade a single host and assert the
    emitted event's ``rank`` column names it, and the linkmap
    localization gate targets one link's owning rank the same way.
    The run window is inclusive on both ends; ``end is None`` leaves it
    open.  ``shape`` selects the noise model (jitter) or the arrival
    distribution (skew); other kinds take ``uniform`` only.
    ``critical`` marks faults whose MISS fails ``tpu-perf chaos verify``
    (exit 5) — the CI conformance gate's teeth.
    """

    kind: str
    op: str = "*"
    nbytes: int = 0
    start: int = 1
    end: int | None = None
    magnitude: float | None = None
    critical: bool = True
    rank: int | None = None
    shape: str = "uniform"

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
            )
        if self.magnitude is None:
            object.__setattr__(
                self, "magnitude", DEFAULT_MAGNITUDE.get(self.kind, 0.0)
            )
        if self.start < 1:
            raise ValueError(f"fault start must be >= 1, got {self.start}")
        if self.end is not None and self.end < self.start:
            raise ValueError(
                f"fault window [{self.start}, {self.end}] is empty"
            )
        if self.nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {self.nbytes}")
        if self.kind in ("delay", "spike", "skew") and self.magnitude <= 0:
            raise ValueError(
                f"{self.kind} needs a positive magnitude, got {self.magnitude}"
            )
        if self.kind == "jitter" and not 0.0 < self.magnitude < 1.0:
            # amplitude >= 1 would drive samples to zero or negative
            raise ValueError(
                f"jitter magnitude must be in (0, 1), got {self.magnitude}"
            )
        if self.kind == "corrupt" and self.op == "*":
            # the corrupt pass runs a selftest per named op at driver
            # exit; a wildcard would mean "selftest everything", which
            # is a different (and unbounded) job
            raise ValueError("corrupt faults must name a concrete op")
        if self.rank is not None and self.rank < 0:
            raise ValueError(f"rank filter must be >= 0, got {self.rank}")
        if self.kind == "hook_fail" and self.rank not in (None, 0):
            # the rotation ingest hook exists on the rank-0 process only
            # (mpi_perf.c:359-362; Driver wires hook = on_rotate iff
            # rank == 0), so a hook_fail pinned to any other rank could
            # never fire — and would deterministically fail `chaos
            # verify` as a missed critical no detector can catch
            raise ValueError(
                f"hook_fail rank filter must be 0 (the only rank with an "
                f"ingest hook), got {self.rank}"
            )
        if self.shape not in JITTER_SHAPES:
            raise ValueError(
                f"unknown jitter shape {self.shape!r}; known: {JITTER_SHAPES}"
            )
        if self.shape != "uniform" and self.kind not in ("jitter", "skew"):
            raise ValueError(
                f"shape={self.shape!r} only applies to jitter and skew "
                f"faults, not {self.kind!r}"
            )

    def in_window(self, run_id: int) -> bool:
        return run_id >= self.start and (self.end is None or run_id <= self.end)

    def matches_rank(self, rank: int) -> bool:
        return self.rank is None or self.rank == rank

    def matches(self, op: str, nbytes: int, run_id: int,
                rank: int = 0) -> bool:
        return (
            (self.op == "*" or self.op == op)
            and (self.nbytes == 0 or self.nbytes == nbytes)
            and self.in_window(run_id)
            and self.matches_rank(rank)
        )


def parse_spec(data) -> list[FaultSpec]:
    """Build the schedule from decoded JSON: a list of entries, or an
    object with a ``faults`` list.  Unknown keys fail loudly — a typo'd
    ``magntiude`` silently defaulting would make a chaos run test
    nothing."""
    if isinstance(data, dict):
        if set(data) != {"faults"}:
            raise ValueError(
                f"fault spec object must have exactly a 'faults' list, "
                f"got keys {sorted(data)}"
            )
        data = data["faults"]
    if not isinstance(data, list):
        raise ValueError(f"fault spec must be a list, got {type(data).__name__}")
    known = {f.name for f in dataclasses.fields(FaultSpec)}
    out = []
    for i, entry in enumerate(data):
        if not isinstance(entry, dict):
            raise ValueError(f"fault spec entry {i} is not an object: {entry!r}")
        unknown = set(entry) - known
        if unknown:
            raise ValueError(
                f"fault spec entry {i} has unknown key(s) {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        if isinstance(entry.get("nbytes"), str):
            from tpu_perf_torch.sweep import parse_size

            entry = dict(entry, nbytes=parse_size(entry["nbytes"]))
        out.append(FaultSpec(**entry))
    return out


def load_spec(path: str) -> list[FaultSpec]:
    """Parse a JSON fault-schedule file."""
    with open(path) as fh:
        try:
            data = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"bad fault spec {path}: {e}") from None
    return parse_spec(data)


def parse_fault_arg(arg: str) -> FaultSpec:
    """One CLI-spelled fault: ``kind[:op[:nbytes[:start-end[:magnitude]]]]``.

    Sizes take the sweep suffixes (``64K``); the window takes ``A-B``,
    ``A-`` (open end), or ``A`` (a single run).  Examples::

        delay:ring:32:100-400:2.0
        drop_run:*:0:60-100
        hook_fail::0:110-115
        spike:link:(1,2)>(1,3):0:1-:30

    Linkmap probe ops carry a colon of their own (``link:(1,2)>(1,3)``);
    the parser re-joins that one split so the localization targets are
    spellable inline, not only in a JSON spec.
    """
    parts = arg.split(":")
    if not parts or not parts[0]:
        raise ValueError(f"empty fault argument {arg!r}")
    if len(parts) > 2 and parts[1] == "link" and parts[2].startswith("("):
        # a linkmap op name split on its own colon: stitch it back
        parts[1:3] = [f"{parts[1]}:{parts[2]}"]
    entry: dict = {"kind": parts[0]}
    if len(parts) > 1 and parts[1]:
        entry["op"] = parts[1]
    if len(parts) > 2 and parts[2]:
        from tpu_perf_torch.sweep import parse_size

        entry["nbytes"] = parse_size(parts[2])
    if len(parts) > 3 and parts[3]:
        lo, sep, hi = parts[3].partition("-")
        entry["start"] = int(lo)
        if sep and hi:
            entry["end"] = int(hi)
        elif not sep:
            entry["end"] = int(lo)
    if len(parts) > 4 and parts[4]:
        entry["magnitude"] = float(parts[4])
    if len(parts) > 5:
        raise ValueError(f"too many ':' fields in fault argument {arg!r}")
    return FaultSpec(**entry)


class ChaosRecord(JsonlRecord):
    """One injection-ledger line (schema.JsonlRecord: duck-typed row,
    lazy-family mechanics shared with the health events and linkmap
    records).  Three record types share the stream, discriminated by
    the ``record`` field: ``meta`` (one per log: seed, stats_every, the
    full spec), ``fault`` (one per fired injection), ``selftest``
    (corrupt-pass verdicts)."""

    __slots__ = ()
    FAMILY = "chaos"
