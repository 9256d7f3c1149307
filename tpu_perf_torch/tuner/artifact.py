"""Crossover auto-tuner: the durable selection artifact and its lookup
(port of ``tpu_perf/tuner/artifact.py``).

The arena (report.compare_arena) measures which decomposition wins per
(op, nbytes, dtype, skew, imbalance, load).  This module closes the
measure→select loop the way pMR does for transports (arXiv
1701.08521): ``tpu-perf-torch tune`` folds arena rows into a versioned **selection artifact** — a winner table keyed on
the full crossover coordinate, with p50s, margins, sample counts, and a
fingerprint of the mesh/card it was measured on — and ``--algo auto``
resolves every sweep point against it at PLAN time.

Lockstep by construction: the artifact is loaded once, staleness and
mesh-foreignness are judged ONCE at load (with an injected ``now`` —
this module is a deterministic zone and never reads a clock), and
:meth:`LoadedSelection.resolve` is a pure function of (artifact, point,
threshold).  Two ranks holding the same artifact bytes produce the same
plan; nothing here may branch on rank-local or timing state.

The fallback ladder (every rung LOUD, never silent — the inert-knob
precedent):

1. stale artifact (age > --tune-max-age, judged at load) → native, all points
2. foreign fingerprint (card name / rank count mismatch) → native, all points
3. no measured entry for the point's (op, dtype, skew, imbalance, load)
   group → native for that point
4. nearest size bucket by log-distance (ties to the smaller bucket) —
   the interpolation rule, applied within the matched group
5. low-margin entry (best-vs-runner-up ratio < --tune-margin, or a
   one-sided slot that never raced a runner-up) → native for that point
6. a winner the current mesh cannot build (validated by the caller,
   runner.algos_for_options) → native for that point

The artifact's JSON is the JAX package's: the same schema version, keys
and order, so either package reads the other's.  The fingerprint's
``device_kind`` is the card's ``torch.cuda.get_device_name()``, "" when
no card is visible.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

from tpu_perf_torch.schema import JsonlRecord

#: artifact schema version: bumped whenever the entry/fingerprint shape
#: changes; a loader refuses a version it does not speak (a versioned
#: artifact silently misread would select algorithms off garbage)
TUNER_SCHEMA_VERSION = 1

#: the sorted entry-field order the JSON artifact serializes (pinned so
#: two tunes over the same rows are byte-identical)
_ENTRY_FIELDS = (
    "op", "nbytes", "dtype", "skew_us", "imbalance", "load",
    "winner", "winner_p50_us", "runner_up", "runner_up_p50_us",
    "margin", "native_p50_us", "native_vs_best", "n_devices", "mesh",
    "samples", "algos",
)


class TuneRecord(JsonlRecord):
    """One JSONL record of the eighth rotating family (``tune-*.log``):
    the selection artifact flattened for the ingest pass — a
    ``tune_fingerprint`` record per artifact plus one ``tune_entry``
    per winner-table row, sharing the stream via the ``record``
    discriminator like every other JSONL family."""

    __slots__ = ()
    FAMILY = "tune"


@dataclasses.dataclass(frozen=True)
class SelectionEntry:
    """One winner-table row: the measured verdict at one crossover
    coordinate.  ``margin`` is the best-vs-runner-up p50 ratio (>= 1;
    0.0 marks a one-sided slot that never raced a runner-up — treated
    as low-confidence by every consumer).  ``samples`` is the winner
    curve's recorded run count; ``algos`` every decomposition raced."""

    op: str
    nbytes: int
    dtype: str
    skew_us: int
    imbalance: int
    load: str
    winner: str
    winner_p50_us: float
    runner_up: str
    runner_up_p50_us: float
    margin: float
    native_p50_us: float
    native_vs_best: float
    n_devices: int
    mesh: str
    samples: int
    algos: tuple[str, ...]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["algos"] = list(self.algos)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SelectionEntry":
        kw = {k: d[k] for k in _ENTRY_FIELDS}
        kw["algos"] = tuple(kw["algos"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class SelectionArtifact:
    """The versioned selection artifact: every winner-table entry plus
    the fingerprint of the mesh/card the verdicts were measured on.
    ``generated``/``generated_unix`` are INJECTED by the caller (this
    module never reads a clock); ``source`` records where the rows came
    from, for the human reading the JSON."""

    version: int
    generated: str
    generated_unix: float
    fingerprint: dict
    entries: tuple[SelectionEntry, ...]
    source: str = ""

    def to_json(self) -> str:
        payload = {
            "version": self.version,
            "generated": self.generated,
            "generated_unix": self.generated_unix,
            "fingerprint": dict(self.fingerprint),
            "source": self.source,
            "entries": [e.to_dict() for e in self.entries],
        }
        return json.dumps(payload, sort_keys=True, indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "SelectionArtifact":
        data = json.loads(text)
        if not isinstance(data, dict) or "version" not in data:
            raise ValueError("not a tuner selection artifact (no version)")
        version = data["version"]
        if version != TUNER_SCHEMA_VERSION:
            raise ValueError(
                f"selection artifact version {version!r} is not the "
                f"supported {TUNER_SCHEMA_VERSION} — re-run `tpu-perf-torch "
                f"tune` against this tree's rows"
            )
        return cls(
            version=version,
            generated=data.get("generated", ""),
            generated_unix=float(data.get("generated_unix", 0.0)),
            fingerprint=dict(data.get("fingerprint", {})),
            entries=tuple(SelectionEntry.from_dict(e)
                          for e in data.get("entries", ())),
            source=data.get("source", ""),
        )

    def to_records(self, job_id: str) -> list[TuneRecord]:
        """The artifact flattened into the eighth rotating family's
        records: one fingerprint record, then one per entry."""
        recs = [TuneRecord(
            record="tune_fingerprint", job_id=job_id,
            version=self.version, generated=self.generated,
            generated_unix=self.generated_unix, source=self.source,
            **{f"fp_{k}": v for k, v in sorted(self.fingerprint.items())},
        )]
        for e in self.entries:
            recs.append(TuneRecord(record="tune_entry", job_id=job_id,
                                   **e.to_dict()))
        return recs


def _margin_of(lats: list[float]) -> float:
    """Best-vs-runner-up p50 ratio; 0.0 for a one-sided slot (no
    runner-up ever raced — an unverified winner must read as
    low-confidence, not infinitely confident)."""
    if len(lats) < 2 or not lats[0]:
        return 0.0
    ordered = sorted(lats)
    return round(ordered[1] / ordered[0], 6)


def build_selection(points, *, generated: str, generated_unix: float,
                    device_kind: str = "", source: str = "",
                    ) -> SelectionArtifact:
    """Fold aggregated curve points into the selection artifact via the
    arena's own pivot (report.compare_arena — ONE verdict definition, so
    tune and the report table can never disagree on a winner).  Keys
    with no arena row are dropped exactly as the crossover table drops
    them: a native-only sweep carries no verdict worth persisting."""
    from tpu_perf_torch.report import compare_arena

    entries: list[SelectionEntry] = []
    n_devices_seen = 0
    for c in compare_arena(points):
        algo, best = c.best
        lats = [p.lat_us["p50"] for p in c.entries.values()]
        ordered = sorted(c.entries.items(),
                         key=lambda kv: kv[1].lat_us["p50"])
        runner_up, runner_lat = ("", 0.0)
        if len(ordered) >= 2:
            runner_up = ordered[1][0]
            runner_lat = ordered[1][1].lat_us["p50"]
        native = c.entries.get("native")
        entries.append(SelectionEntry(
            op=c.op, nbytes=c.nbytes, dtype=c.dtype, skew_us=c.skew_us,
            imbalance=c.imbalance, load=c.load, winner=algo,
            winner_p50_us=round(best.lat_us["p50"], 3),
            runner_up=runner_up,
            runner_up_p50_us=round(runner_lat, 3),
            margin=_margin_of(lats),
            native_p50_us=round(native.lat_us["p50"], 3) if native else 0.0,
            native_vs_best=round(c.native_vs_best, 6)
            if c.native_vs_best else 0.0,
            n_devices=best.n_devices,
            mesh=c.mesh,
            samples=best.runs,
            algos=tuple(sorted(c.entries)),
        ))
        n_devices_seen = max(n_devices_seen, best.n_devices)
    fingerprint = {
        "tuner_schema": TUNER_SCHEMA_VERSION,
        "device_kind": device_kind,
        "chip": _chip_of(device_kind),
        "n_devices": n_devices_seen,
    }
    return SelectionArtifact(
        version=TUNER_SCHEMA_VERSION, generated=generated,
        generated_unix=generated_unix, fingerprint=fingerprint,
        entries=tuple(entries), source=source,
    )


def _chip_of(device_kind: str) -> str:
    """The card table's short name for ``device_kind`` (the JAX
    fingerprint's ``chip``); "" when unknown or absent."""
    from tpu_perf_torch.chips import resolve_card

    spec = resolve_card(device_kind) if device_kind else None
    return spec.kind if spec is not None else ""


def write_artifact(artifact: SelectionArtifact, path: str) -> None:
    """Atomic publish (tmp + rename on the same filesystem): a reader —
    or a crashed tune — never sees a torn artifact, only the old bytes
    or the new (the fleet/timeline artifact discipline)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        fh.write(artifact.to_json())
    os.replace(tmp, path)


def read_artifact(path: str) -> SelectionArtifact:
    with open(path) as fh:
        return SelectionArtifact.from_json(fh.read())


def current_device_kind() -> str:
    """The card's name for fingerprinting (``torch.cuda.get_device_name``;
    "" when no card is visible — a tune on a login host still produces an
    artifact; the load-side check only rejects when BOTH sides know their
    kind and disagree)."""
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name()


def smi_device_kind() -> str:
    """The first card's name as ``nvidia-smi`` gives it (the name
    ``torch.cuda.get_device_name`` returns), without loading CUDA in this
    process: a file-reading command (``fleet report --tune-out``) makes no
    context.  "" when no ``nvidia-smi`` or no card answers."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0].strip() if out.strip() else ""


class LoadedSelection:
    """A selection artifact judged for use on THIS job: staleness and
    fingerprint foreignness are decided once at construction (with the
    caller's injected ``now``), so :meth:`resolve` stays a pure
    point→algorithm function — the property the two-rank lockstep test
    pins.  ``notes`` dedups the loud fallback messages (one per cause,
    not one per sweep point)."""

    def __init__(self, artifact: SelectionArtifact, *, n_devices: int = 0,
                 device_kind: str = "", max_age_sec: float = 0.0,
                 now: float | None = None, err=None):
        self.artifact = artifact
        self.stale = False
        self.foreign = False
        self._noted: set = set()
        fp = artifact.fingerprint
        if max_age_sec > 0 and now is not None and artifact.generated_unix:
            age = now - artifact.generated_unix
            if age > max_age_sec:
                self.stale = True
                self._say(err, f"selection artifact is stale (age "
                               f"{age:.0f}s > --tune-max-age "
                               f"{max_age_sec:.0f}s): --algo auto runs "
                               f"the native lowering for EVERY point — "
                               f"re-run `tpu-perf-torch tune` on fresh rows")
        fp_kind = str(fp.get("device_kind", "") or "")
        if fp_kind and device_kind and fp_kind != device_kind:
            self.foreign = True
            self._say(err, f"selection artifact was measured on "
                           f"{fp_kind!r} and this job runs on "
                           f"{device_kind!r}: foreign fingerprint — "
                           f"--algo auto runs the native lowering for "
                           f"EVERY point")
        fp_n = int(fp.get("n_devices", 0) or 0)
        if fp_n and n_devices and fp_n != n_devices:
            self.foreign = True
            self._say(err, f"selection artifact was measured on "
                           f"{fp_n} devices and this job's collective "
                           f"axis holds {n_devices}: foreign mesh — "
                           f"--algo auto runs the native lowering for "
                           f"EVERY point")

    @staticmethod
    def _say(err, msg: str) -> None:
        if err is not None:
            print(f"[tpu-perf-torch] tuner: {msg}", file=err)

    def note_once(self, key, msg: str, err=None) -> None:
        """Loud exactly once per cause: a per-point fallback note
        repeated for every size in a sweep would bury the signal."""
        if key in self._noted:
            return
        self._noted.add(key)
        self._say(err, msg)

    def resolve(self, op: str, nbytes: int, dtype: str, *,
                skew_us: int = 0, imbalance: int = 1, load: str = "",
                n_devices: int = 0, margin_min: float = 1.0,
                err=None) -> str:
        """The plan-time lookup: the artifact's winner at the nearest
        measured size bucket of this point's coordinate group, or
        ``native`` down the loud fallback ladder.  Pure in (self,
        args): no rank, no clock, no I/O — R2-lockstep by
        construction."""
        if self.stale or self.foreign:
            return "native"
        group = [e for e in self.artifact.entries
                 if e.op == op and e.dtype == dtype
                 and e.skew_us == skew_us and e.imbalance == imbalance
                 and e.load == load
                 and (not n_devices or e.n_devices == n_devices)]
        if not group:
            self.note_once(
                ("no-entry", op, dtype, skew_us, imbalance, load),
                f"no measured entry for {op}/{dtype} (skew={skew_us}us, "
                f"imbalance={imbalance}, load={load or 'idle'}): --algo "
                f"auto falls back to the native lowering there", err)
            return "native"
        # nearest measured size bucket by log-distance — latency curves
        # live on a log-size axis, so 64K is "between" 16K and 256K,
        # not 4x closer to 16K; ties break to the smaller bucket so the
        # interpolation is deterministic
        ref = math.log(max(1, nbytes))
        entry = min(group, key=lambda e: (abs(math.log(max(1, e.nbytes))
                                              - ref), e.nbytes))
        if entry.margin < margin_min:
            self.note_once(
                ("low-margin", op, dtype, entry.nbytes, skew_us,
                 imbalance, load),
                f"{op}@{entry.nbytes}B winner {entry.winner!r} holds a "
                f"{entry.margin:.3f}x margin < --tune-margin "
                f"{margin_min:.3f}: low confidence — --algo auto falls "
                f"back to the native lowering there", err)
            return "native"
        return entry.winner


def load_artifact(path: str, *, n_devices: int = 0, device_kind: str = "",
                  max_age_sec: float = 0.0, now: float | None = None,
                  err=None) -> LoadedSelection:
    """Read + judge an artifact for this job (the ONE loader --algo auto
    uses).  A missing or unversioned file is a hard error — auto with
    no table is a misconfiguration, not a fallback."""
    try:
        artifact = read_artifact(path)
    except FileNotFoundError:
        raise ValueError(
            f"--algo auto: selection artifact {path!r} does not exist "
            f"(produce one with `tpu-perf-torch tune -d LOGDIR -o {path}`)"
        ) from None
    except json.JSONDecodeError:
        raise ValueError(
            f"--algo auto: {path!r} is not a JSON selection artifact"
        ) from None
    return LoadedSelection(artifact, n_devices=n_devices,
                           device_kind=device_kind,
                           max_age_sec=max_age_sec, now=now, err=err)


@dataclasses.dataclass(frozen=True)
class DriftFinding:
    """One crossover that moved against the published artifact: the
    fresh rows crown a different winner with a convincing margin."""

    op: str
    nbytes: int
    dtype: str
    skew_us: int
    imbalance: int
    load: str
    published: str
    fresh_winner: str
    fresh_margin: float

    def describe(self) -> str:
        coord = f"{self.op}@{self.nbytes}B/{self.dtype}"
        if self.skew_us:
            coord += f" skew={self.skew_us}us"
        if self.imbalance > 1:
            coord += f" imbalance={self.imbalance}"
        if self.load:
            coord += f" load={self.load}"
        return (f"{coord}: published winner {self.published!r} lost to "
                f"{self.fresh_winner!r} (fresh margin "
                f"{self.fresh_margin:.3f}x)")


def check_drift(published: SelectionArtifact, fresh: SelectionArtifact,
                *, margin_min: float = 1.0) -> list[DriftFinding]:
    """The drift gate: re-grade fresh verdicts against the published
    table.  A flip counts only when the fresh winner's own margin
    clears ``margin_min`` — a noise-level reshuffle between near-tied
    algorithms must not fail CI, a real crossover move must."""
    pub = {(e.op, e.nbytes, e.dtype, e.skew_us, e.imbalance, e.load): e
           for e in published.entries}
    findings = []
    for e in fresh.entries:
        key = (e.op, e.nbytes, e.dtype, e.skew_us, e.imbalance, e.load)
        old = pub.get(key)
        if old is None or old.winner == e.winner:
            continue
        if e.margin < margin_min:
            continue
        findings.append(DriftFinding(
            op=e.op, nbytes=e.nbytes, dtype=e.dtype, skew_us=e.skew_us,
            imbalance=e.imbalance, load=e.load, published=old.winner,
            fresh_winner=e.winner, fresh_margin=e.margin,
        ))
    return findings
