"""Seeded fault injection at the driver/op boundary (port of
``tpu_perf/faults/injector.py``).

The :class:`FaultInjector` sits between ``Driver._measure`` and
``Driver._record_run``: every run's wall time passes through
:meth:`apply`, which perturbs (or drops) it according to the schedule
and writes one ledger record per fired injection.  Because injection
wraps the MEASURED VALUE — not the kernel, the fence, or the backend —
it behaves identically under ``block``/``readback``/``slope``/``trace``
and for both one-shot and daemon loops.

Determinism contract: all randomness is derived by hashing
``(seed, spec-index, run_id)`` (and, for synthetic samples,
``(seed, op, nbytes, visit-count)``) into a fresh ``random.Random`` —
no shared RNG stream whose consumption order could drift.  Same seed +
same spec + same run sequence => the same perturbation stream and a
byte-identical injection ledger (records carry no wall-clock fields).

``synthetic_s`` replaces the measured sample entirely with a seeded
series around a base latency (tiny relative noise, never bit-identical)
— the knob that makes the CI conformance and false-alarm gates
deterministic on shared machines, where real CPU timing outliers would
make a zero-false-alarm assertion flaky.
"""

from __future__ import annotations

import dataclasses
import math
import random
import sys

import numpy as np

from tpu_perf_torch.faults.spec import ChaosRecord, FaultSpec
from tpu_perf_torch.schema import window_index

#: relative amplitude of the synthetic series' seeded noise: big enough
#: that samples never repeat (no false flatline), small enough that a
#: spike fault's z-score clears any sane threshold
SYNTHETIC_NOISE = 1e-3

#: the smallest arrival-skew world: skew needs at least two parties, so
#: a single-process soak models a two-rank world (rank 0 = this process,
#: rank 1 = the phantom straggler) — otherwise max(arrivals) == own
#: arrival and the victim cost would be identically zero, making every
#: single-host conformance gate vacuous
MIN_SKEW_WORLD = 2


def skew_world(n_ranks: int, rank: int = 0) -> range:
    """The modeled arrival world: every real rank, padded to at least
    :data:`MIN_SKEW_WORLD` (and to include ``rank``) — one spelling for
    the fault kind and the driver, so the padding semantics cannot
    drift between them."""
    return range(max(MIN_SKEW_WORLD, n_ranks, rank + 1))


def reduce_arrivals(totals: dict[int, float],
                    rank: int) -> tuple[float, float]:
    """The (own_stagger_s, victim_cost_s) reduction over one run's
    per-rank arrival totals in µs: this rank delays its dispatch by its
    own arrival, and waits — from its seat inside the collective — for
    the worst arrival in the world.  Shared by every skew source for
    the same reason as :func:`skew_world`."""
    own = totals[rank]
    return own * 1e-6, (max(totals.values()) - own) * 1e-6


def _arrival_mult(shape: str, rnd: random.Random) -> float:
    """One rank's arrival draw as a fraction of the skew scale.

    ``uniform`` models arrival anywhere in ``[0, scale)`` — the paper's
    bounded imbalanced-arrival window (arXiv 1804.05349).  The heavy-
    tailed shapes reuse the jitter machinery's median-1 normalization
    so ``scale`` stays the TYPICAL stagger while the tail produces the
    occasional multi-x straggler: ``lognormal`` at sigma 0.5,
    ``pareto`` at tail index 3 divided by its median 2**(1/3)."""
    if shape == "lognormal":
        return math.exp(0.5 * rnd.gauss(0.0, 1.0))
    if shape == "pareto":
        return rnd.paretovariate(3.0) / 2.0 ** (1.0 / 3.0)
    return rnd.random()


class InjectedHookFailure(RuntimeError):
    """Raised by the chaos-wrapped ingest hook while a ``hook_fail``
    fault window is active — a distinct type so logs attribute the
    failure to injection, not a real telemetry outage."""


class FaultInjector:
    """One per Driver (``--faults`` / ``--synthetic``); shared by the
    run loop (:meth:`apply`, :meth:`synthetic_sample`), the rotation
    hook (:meth:`wrap_hook`), and the selftest corrupt pass
    (:meth:`corrupt_payload`)."""

    def __init__(
        self,
        faults: list[FaultSpec],
        *,
        seed: int = 0,
        stats_every: int = 1000,
        ledger=None,   # RotatingCsvLog(prefix="chaos", lazy=True) or None
        synthetic_s: float | None = None,
        rank: int = 0,  # this process's rank, judged against FaultSpec.rank
        #               # (a rank-filtered fault fires on ONE host of a
        #               # multi-host soak; the linkmap prober overrides it
        #               # per probe with the link's owning rank)
        err=None,
    ):
        self.faults = list(faults)
        self.seed = seed
        self.stats_every = max(1, stats_every)
        self.ledger = ledger
        self.synthetic_s = synthetic_s
        self.rank = rank
        self.err = err
        self._fired_once: set[int] = set()    # spike/hook_fail: one-shot
        self._flat_pin: dict[int, float] = {}  # flatline: pinned sample
        self._syn_count: dict[tuple[str, int], int] = {}
        self._current_run = 0
        self._force_rotation = False
        #: cumulative run-time injections fired (ledger records written
        #: or suppressed alike) — the driver samples the delta around
        #: each apply() to emit an ``inject`` trace span only for runs a
        #: fault actually touched, without adding any ledger field
        self.fired_total = 0

    # -- ledger ---------------------------------------------------------

    def write_meta(self) -> None:
        """The ledger's header record: everything conformance needs to
        re-derive the schedule (and everything reproduction needs to
        re-run it).  Written eagerly at driver start so even a chaos
        soak whose faults never fire leaves a ledger behind — a
        fault-free soak's conformance pass must know it was fault-free,
        not fileless."""
        self._write(ChaosRecord(
            record="meta",
            seed=self.seed,
            stats_every=self.stats_every,
            synthetic_s=self.synthetic_s,
            faults=[dataclasses.asdict(f) for f in self.faults],
        ))

    def _write(self, rec: ChaosRecord) -> None:
        if self.ledger is not None:
            self.ledger.write_row(rec)

    def _fault_record(self, idx: int, f: FaultSpec, run_id: int,
                      op: str, nbytes: int, **extra) -> None:
        self.fired_total += 1
        self._write(ChaosRecord(
            record="fault", spec=idx, kind=f.kind, op=op, nbytes=nbytes,
            run_id=run_id,
            window=window_index(run_id, self.stats_every), **extra,
        ))

    def maybe_rotate(self) -> None:
        if self.ledger is not None:
            self.ledger.maybe_rotate()

    def close(self) -> None:
        if self.ledger is not None:
            self.ledger.close()

    # -- deterministic randomness --------------------------------------

    def _rng(self, idx: int, run_id: int) -> random.Random:
        """THE seeded stream for (seed, spec-index, run_id) — one key
        spelling, so the byte-identical-ledger contract cannot desync
        between the uniform and shaped jitter paths."""
        return random.Random(f"{self.seed}:{idx}:{run_id}")

    def _rand(self, idx: int, run_id: int) -> float:
        """U(0, 1) from the per-(seed, spec, run) stream — stateless, so
        the stream cannot drift with evaluation order."""
        return self._rng(idx, run_id).random()

    def _jitter_multiplier(self, f: FaultSpec, idx: int, run_id: int) -> float:
        """The seeded noise multiplier for one jitter sample.

        ``uniform`` is the bounded 1 + magnitude * U(-1, 1).  The heavy-
        tailed shapes are MEDIAN-PRESERVING around 1 with a real right
        tail — noise, not a level shift, because the jitter contract is
        that detectors must NOT alert (a sustained shift is what the
        regression detector exists to catch, and would turn every
        shaped-jitter soak into a false-alarm factory): ``lognormal``
        uses magnitude as log-sigma (exp(sigma * N(0,1)), median 1);
        ``pareto`` draws a Pareto of tail index 1/magnitude and divides
        out its median 2**magnitude (magnitude 0.2 => alpha 5: bulk ~1,
        occasionally several-x).  Each sample's draw is a fresh
        (seed, spec, run) Random, so shapes stay exactly as
        reproducible as the uniform stream."""
        rnd = self._rng(idx, run_id)
        if f.shape == "lognormal":
            return math.exp(f.magnitude * rnd.gauss(0.0, 1.0))
        if f.shape == "pareto":
            return rnd.paretovariate(1.0 / f.magnitude) / 2.0 ** f.magnitude
        return 1.0 + f.magnitude * (2.0 * rnd.random() - 1.0)

    # -- synthetic timing source ---------------------------------------

    @property
    def synthetic(self) -> bool:
        return self.synthetic_s is not None

    def synthetic_sample(self, op: str, nbytes: int) -> float:
        """The next sample of this point's seeded series (replaces
        ``Driver._measure`` entirely in synthetic mode)."""
        key = (op, nbytes)
        n = self._syn_count[key] = self._syn_count.get(key, 0) + 1
        u = random.Random(f"{self.seed}:syn:{op}:{nbytes}:{n}").random()
        return self.synthetic_s * (1.0 + SYNTHETIC_NOISE * (u - 0.5))

    # -- the pre-dispatch injection point (arrival skew) ---------------

    def _skew_stagger_us(self, idx: int, f: FaultSpec, rank: int,
                         run_id: int) -> float:
        """One rank's drawn arrival stagger for one skew spec, in µs —
        a stateless (seed, spec, rank, run) hash, so every rank can
        reconstruct every other rank's arrival without communication
        (lockstep without a wire exchange)."""
        rnd = random.Random(f"{self.seed}:{idx}:skew:{rank}:{run_id}")
        return f.magnitude * _arrival_mult(f.shape, rnd)

    def entry_skew(self, op: str, nbytes: int, run_id: int, *,
                   n_ranks: int = 1) -> tuple[float, float]:
        """Scheduled arrival skew for one run: ``(own_stagger_s,
        victim_cost_s)`` summed over the matching skew specs.

        Called at the ENTRY boundary — before the dispatch — unlike
        :meth:`apply`, which perturbs the measured value afterwards:
        the driver sleeps ``own_stagger_s`` so the collective really
        observes imbalanced arrival, and (synthetic mode only) adds
        ``victim_cost_s`` — the modeled worst arrival minus this
        rank's own, per spec — to the sample, because a single
        synthetic process has no peers to physically wait for.  A
        rank-filtered spec staggers only the named rank; every other
        rank is a victim (cost > 0, stagger 0).  One ledger record per
        matching spec per run, on EVERY in-window rank — victims
        included, stagger_us 0 — so the conformance join sees the
        fault on the rows it degrades, and the per-rank ledgers stay
        byte-reproducible (no wall-clock fields; the stagger is a
        drawn value, not a clock read).

        :meth:`skew_fault_world` and :meth:`skew_arrivals_us` do the
        work; the driver calls this at each run's entry."""
        totals = self.skew_arrivals_us(
            op, nbytes, run_id,
            world=self.skew_fault_world(n_ranks, op, nbytes, run_id))
        if totals is None:
            return 0.0, 0.0
        return reduce_arrivals(totals, self.rank)

    def skew_fault_world(self, n_ranks: int, op: str | None = None,
                         nbytes: int = 0, run_id: int = 0):
        """The ONE definition of the skew faults' modeled arrival
        world: the synthetic source models phantom stragglers (padded
        to every rank a matching spec names, and to MIN_SKEW_WORLD),
        so single-host conformance soaks stay meaningful; real timing
        can only observe a straggler that actually sleeps, so its
        world is EXACTLY the real ranks — a phantom-only spec neither
        fires nor ledgers there (and the driver rejects it up front).
        Shared by :meth:`entry_skew` and the driver's entry boundary,
        so the two spellings cannot drift."""
        if self.synthetic:
            return skew_world(
                self.skew_world_size(n_ranks, op, nbytes, run_id),
                self.rank)
        return range(n_ranks)

    def _skew_matches(self, f: FaultSpec, op: str, nbytes: int,
                      run_id: int) -> bool:
        """One definition of "this skew spec covers this run" — shared
        by the world sizing and the arrival draws, so the two can never
        disagree about which specs shape a run's modeled world."""
        return (f.kind == "skew"
                and (f.op == "*" or f.op == op)
                and (f.nbytes == 0 or f.nbytes == nbytes)
                and f.in_window(run_id))

    def skew_world_size(self, n_ranks: int, op: str | None = None,
                        nbytes: int = 0, run_id: int = 0) -> int:
        """The rank count the modeled arrival world must cover: every
        real rank PLUS every rank a skew spec names — a multi-host spec
        (``rank: 3``) reproduced on fewer hosts still models the named
        straggler (phantom, like the MIN_SKEW_WORLD pad), so the
        victims' cost, the detectors' signal, and the conformance
        verdict stay meaningful instead of silently zero.  With
        (op, nbytes, run_id) given, only specs MATCHING that run pad
        the world — an unrelated op's (or an expired window's) named
        straggler must not inflate this run's victim statistics."""
        return max([n_ranks] + [
            f.rank + 1 for f in self.faults
            if f.kind == "skew" and f.rank is not None
            and (op is None or self._skew_matches(f, op, nbytes, run_id))
        ])

    def skew_arrivals_us(self, op: str, nbytes: int, run_id: int, *,
                         world) -> dict[int, float] | None:
        """Every rank's summed skew-fault arrival for one run, in µs —
        or None when no spec matches (no ledger record either: a run a
        skew schedule never touched stays ledger-silent).  Summed
        ACROSS specs per rank before any reduction: two overlapping
        skew sources' worst arrivals can land on different ranks, so
        per-spec costs do not add — combined arrivals do.  Ledger side
        effect: one record per matching spec, carrying this rank's own
        drawn stagger for it."""
        totals: dict[int, float] | None = None
        for idx, f in enumerate(self.faults):
            if not self._skew_matches(f, op, nbytes, run_id):
                continue
            if not any(f.matches_rank(r) for r in world):
                # the named straggler is outside the modeled world:
                # nothing was staggered anywhere, so nothing is
                # ledgered either — a "fired" record for a no-op
                # injection would let a coincidental event pass
                # conformance for a fault that never injected.
                # (skew_world_size pads the world to cover spec ranks,
                # so this guards only callers passing their own world.)
                continue
            if totals is None:
                totals = {r: 0.0 for r in world}
            draws = {
                r: (self._skew_stagger_us(idx, f, r, run_id)
                    if f.matches_rank(r) else 0.0)
                for r in world
            }
            for r in world:
                totals[r] += draws[r]
            self._fault_record(idx, f, run_id, op, nbytes,
                               stagger_us=round(draws[self.rank], 3))
        return totals

    def has_skew(self) -> bool:
        """True when the schedule holds any skew spec (the driver's
        entry-boundary hook is armed only then — zero overhead, and
        zero ledger drift, for every pre-skew schedule)."""
        return any(f.kind == "skew" for f in self.faults)

    # -- the per-run injection point -----------------------------------

    def apply(self, op: str, nbytes: int, run_id: int,
              t: float | None, *, rank: int | None = None) -> float | None:
        """Perturb one run's measured time per the schedule; ``None``
        drops the run (capture loss).  Faults apply in spec order;
        ``drop_run`` short-circuits (there is nothing left to perturb).
        ``rank`` overrides the injector's own rank for this sample (the
        linkmap prober attributes each probe to the link's owning rank);
        rank-filtered specs fire only on a matching rank.  Also advances
        the injector's run cursor, which arms the wrapped ingest hook
        and schedules the ``hook_fail`` forced rotation."""
        r = self.rank if rank is None else rank
        self._current_run = run_id
        for idx, f in enumerate(self.faults):
            if f.kind in ("corrupt", "skew"):
                # corrupt is selftest-time (corrupt_payload); skew is
                # ENTRY-time (entry_skew, before the dispatch) — neither
                # perturbs the measured value here
                continue
            if f.kind == "hook_fail":
                # keyed to the rotation, not to a point: fires once per
                # window, at the window's first run, by forcing a
                # rotation there — a 900 s refresh would otherwise make
                # the failure's run position wall-clock dependent and
                # the ledger non-reproducible.  Rank-filtered: only the
                # named host's ingest hook fails.
                if f.in_window(run_id) and f.matches_rank(self.rank) \
                        and idx not in self._fired_once:
                    self._fired_once.add(idx)
                    self._force_rotation = True
                    self._fault_record(idx, f, run_id, op="", nbytes=0)
                continue
            if not f.matches(op, nbytes, run_id, rank=r):
                continue
            if f.kind == "drop_run":
                self._fault_record(idx, f, run_id, op, nbytes)
                return None
            if t is None:
                continue  # naturally dropped run: nothing to perturb
            if f.kind == "delay":
                t *= 1.0 + f.magnitude
                self._fault_record(idx, f, run_id, op, nbytes)
            elif f.kind == "jitter":
                m = self._jitter_multiplier(f, idx, run_id)
                t *= m
                self._fault_record(idx, f, run_id, op, nbytes,
                                   m=round(m, 9))
            elif f.kind == "spike":
                if idx not in self._fired_once:
                    self._fired_once.add(idx)
                    t *= f.magnitude
                    self._fault_record(idx, f, run_id, op, nbytes)
            elif f.kind == "flatline":
                pin = self._flat_pin.get(idx)
                if pin is None:
                    pin = self._flat_pin[idx] = t
                t = pin
                self._fault_record(idx, f, run_id, op, nbytes)
        return t

    # -- rotation / ingest-hook faults ---------------------------------

    def hook_armed(self) -> bool:
        """True while any hook_fail window (for this rank) covers the
        current run."""
        return any(
            f.kind == "hook_fail" and f.in_window(self._current_run)
            and f.matches_rank(self.rank)
            for f in self.faults
        )

    def wrap_hook(self, hook):
        """The chaos ingest hook: raises while a hook_fail window is
        active (exercising the daemon's never-fatal contract and the
        health subsystem's ``hook_fail`` event), else delegates."""

        def chaos_hook():
            if self.hook_armed():
                raise InjectedHookFailure(
                    f"injected ingest-hook failure (chaos run "
                    f"{self._current_run})"
                )
            if hook is not None:
                hook()

        return chaos_hook

    def take_forced_rotation(self) -> bool:
        """One-shot flag the driver polls after :meth:`apply`: True
        exactly once per hook_fail window, at its first run."""
        fired, self._force_rotation = self._force_rotation, False
        return fired

    # -- payload corruption (selftest rx validation) -------------------

    def corrupt_ops(self) -> list[str]:
        return sorted({
            f.op for f in self.faults
            if f.kind == "corrupt" and f.matches_rank(self.rank)
        })

    def corrupt_payload(self, op: str, out: np.ndarray) -> np.ndarray:
        """Flip one high exponent bit of a deterministic element of the
        op's selftest output — guaranteed far outside any rtol, so an
        rx-validation pass that misses it is broken, not lenient."""
        hit = [
            (idx, f) for idx, f in enumerate(self.faults)
            if f.kind == "corrupt" and f.op == op
            and f.matches_rank(self.rank)
        ]
        if not hit:
            return out
        out = np.array(out, dtype=np.float64, copy=True).reshape(-1)
        for idx, f in hit:
            i = int(self._rand(idx, 0) * out.size) % out.size
            view = out[i:i + 1].view(np.uint64)
            view[:] = view ^ (np.uint64(1) << np.uint64(62))
            self._fault_record(idx, f, 0, op, 0, index=i, bit=62)
        return out

    def record_selftest(self, results) -> None:
        """Ledger the corrupt pass's verdicts (selftest.SelftestResult
        rows) so conformance can judge corrupt faults offline."""
        for r in results:
            self._write(ChaosRecord(
                record="selftest", op=r.op, status=r.status, detail=r.detail,
            ))

    def report(self, msg: str) -> None:
        print(msg, file=self.err if self.err is not None else sys.stderr,
              flush=True)
