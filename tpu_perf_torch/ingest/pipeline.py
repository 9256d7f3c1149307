"""Continuous CSV -> telemetry-store ingest (copy of
``tpu_perf/ingest/pipeline.py``, the kusto_ingest.py workalike).

Contract, identical to the reference (kusto_ingest.py:24-47):

* scan a log folder for files named ``tcp*`` (:32);
* sort them oldest-first by mtime (:34);
* **skip the newest ``skip_newest`` files** — they are still being written by
  the sibling flows (:38-40, the ``-f <flows>`` heuristic);
* ingest each remaining file, then delete it — a file is removed *only*
  after successful ingest, so rows already uploaded survive a crash and
  un-uploaded rows are retried next pass (:41-44).

Backends:

* :class:`KustoBackend` — queued CSV ingestion into ``WarpPPE.PerfLogsMPI``
  with managed-identity auth, like the reference (kusto_ingest.py:25-28).
  Gated on the azure SDKs being importable (a lazy import: nothing is
  installed for it).
* :class:`LocalDirBackend` — copies files into a local sink directory; the
  test/air-gapped stand-in.
* :class:`NullBackend` — discard (ingest == delete).

The port writes five rotating-log families (:data:`PREFIXES`): legacy
``tcp-*`` CSV, extended ``tpu-*`` CSV, and the JSONL ``health-*`` events,
``chaos-*`` ledger and ``spans-*`` records; one
:func:`run_all_ingest_passes` sweeps them all.  The JAX package's
linkmap, fleet and tune families come with their modules.

A file whose ingest keeps failing (a poison row the table mapping
rejects, re-failing every pass forever) is **quarantined** after
``MAX_INGEST_FAILURES`` consecutive failures: renamed to
``<name>.quarantined`` (out of the scan pattern) so the operator can
inspect it while the rest of the backlog keeps flowing.  Failures count
toward quarantine only in passes where another file succeeded — a
success proves the backend alive, so the failure is file-specific; a
backend outage must not quarantine the whole backlog.  The per-file
counter persists across passes (each rotation spawns a fresh ingest
process) in a ``.ingest-failures.json`` sidecar next to the logs.
"""

from __future__ import annotations

import json
import os
import shlex
import shutil
import subprocess
import sys

from tpu_perf_torch.schema import (
    ALL_PREFIXES, CHAOS_PREFIX, EXT_PREFIX, HEALTH_PREFIX, LEGACY_PREFIX,
    SPANS_PREFIX,
)

#: the rotating-log families this package writes
PREFIXES = ALL_PREFIXES
#: the JSONL families: lazy logs whose active file is ``<name>.open``, so
#: every ``<prefix>-*.log`` on disk is finished
LAZY_PREFIXES = (HEALTH_PREFIX, CHAOS_PREFIX, SPANS_PREFIX)


class IngestBackend:
    """Ingest one file; raise on failure (so the file is NOT deleted)."""

    def ingest(self, path: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class NullBackend(IngestBackend):
    def ingest(self, path: str) -> None:
        pass


class LocalDirBackend(IngestBackend):
    def __init__(self, sink_dir: str):
        self.sink_dir = sink_dir

    def ingest(self, path: str) -> None:
        os.makedirs(self.sink_dir, exist_ok=True)
        shutil.copy2(path, os.path.join(self.sink_dir, os.path.basename(path)))


#: extended-schema (tpu-*.log) rows carry 18 columns and cannot land in
#: the reference's 11-column PerfLogsMPI table; they get their own
TPU_TABLE = "PerfLogsTPU"
#: the JSONL families' tables (JSON ingestion format), the JAX package's
HEALTH_TABLE = "HealthEventsTPU"
CHAOS_TABLE = "ChaosEventsTPU"
SPANS_TABLE = "SpanEventsTPU"


class KustoBackend(IngestBackend):
    """Azure Data Explorer queued ingestion (kusto_ingest.py:24-31).

    Default database/table match the reference: ``WarpPPE.PerfLogsMPI``
    (kusto_ingest.py:25), CSV format, managed-identity auth (:27).  Files
    are routed by schema: legacy ``tcp-*`` rows into ``table``, extended
    ``tpu-*`` rows into ``table_ext``, and the JSONL families (JSON
    format) into ``table_health``, ``table_chaos`` and ``table_spans``.
    """

    def __init__(self, ingest_uri: str, database: str = "WarpPPE",
                 table: str = "PerfLogsMPI", table_ext: str = TPU_TABLE,
                 table_health: str = HEALTH_TABLE,
                 table_chaos: str = CHAOS_TABLE,
                 table_spans: str = SPANS_TABLE):
        try:
            from azure.identity import ManagedIdentityCredential  # noqa: F401
            from azure.kusto.data import KustoConnectionStringBuilder
            from azure.kusto.ingest import IngestionProperties, QueuedIngestClient
            from azure.kusto.ingest.ingestion_properties import DataFormat
        except ImportError as e:
            raise RuntimeError(
                "KustoBackend requires azure-kusto-ingest and azure-identity "
                "(scripts/install-kusto-dependencies.sh)"
            ) from e
        kcsb = KustoConnectionStringBuilder.with_aad_managed_service_identity_authentication(
            ingest_uri
        )
        self._client = QueuedIngestClient(kcsb)
        self._props = IngestionProperties(
            database=database, table=table, data_format=DataFormat.CSV
        )
        self._props_ext = IngestionProperties(
            database=database, table=table_ext, data_format=DataFormat.CSV
        )
        self._props_family = {
            prefix: IngestionProperties(database=database, table=t,
                                        data_format=DataFormat.JSON)
            for prefix, t in ((HEALTH_PREFIX, table_health),
                              (CHAOS_PREFIX, table_chaos),
                              (SPANS_PREFIX, table_spans))
        }

    def ingest(self, path: str) -> None:
        name = os.path.basename(path)
        props = self._props
        for prefix, p in self._props_family.items():
            if name.startswith(prefix + "-"):
                props = p
        if name.startswith(EXT_PREFIX + "-"):
            props = self._props_ext
        self._client.ingest_from_file(path, ingestion_properties=props)


def eligible_files(folder: str, skip_newest: int, *,
                   prefix: str = LEGACY_PREFIX) -> list[str]:
    """Files ready for ingest: oldest-first, newest ``skip_newest`` excluded
    (kusto_ingest.py:32-40)."""
    if skip_newest < 0:
        raise ValueError(f"skip_newest must be >= 0, got {skip_newest}")
    try:
        names = os.listdir(folder)
    except FileNotFoundError:
        return []
    paths = [
        os.path.join(folder, n)
        for n in names
        # the full rotating-log shape (<prefix>-...-.log), not a bare
        # prefix match: a --health-textfile named tpu-perf.prom in the
        # log folder must never be swept into the tpu-* CSV table
        if n.startswith(prefix + "-") and n.endswith(".log")
        and os.path.isfile(os.path.join(folder, n))
    ]
    paths.sort(key=os.path.getmtime)
    return paths[: max(0, len(paths) - skip_newest)]


#: consecutive per-file ingest failures before the file is quarantined
MAX_INGEST_FAILURES = 3
#: quarantined files drop out of eligible_files' ``.log`` suffix match
QUARANTINE_SUFFIX = ".quarantined"
#: sidecar persisting per-file failure counts across ingest processes
#: (each rotation spawns a fresh pass); never matches a family's
#: ``<prefix>-*.log`` scan shape, so it is never swept or deleted
FAILURE_STATE_FILE = ".ingest-failures.json"


def _load_failure_counts(folder: str) -> dict[str, int]:
    try:
        with open(os.path.join(folder, FAILURE_STATE_FILE)) as fh:
            data = json.load(fh)
        return {str(k): int(v) for k, v in data.items()}
    except (OSError, ValueError, AttributeError, TypeError):
        # missing or corrupt state (bad JSON, non-object, non-int
        # values) restarts the counters — worst case a poison file
        # takes one extra round of failures to quarantine
        return {}


def _save_failure_counts(folder: str, counts: dict[str, int]) -> None:
    path = os.path.join(folder, FAILURE_STATE_FILE)
    if not counts:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(counts, fh)
    os.replace(tmp, path)  # atomic: a killed pass never tears the state


def list_quarantined(folder: str) -> list[str]:
    """Quarantined files in ``folder`` (paths, oldest first) — the
    operator's triage view, instead of an ls pattern they must remember."""
    try:
        names = os.listdir(folder)
    except FileNotFoundError:
        return []
    paths = [
        os.path.join(folder, n) for n in names
        if n.endswith(QUARANTINE_SUFFIX)
        and os.path.isfile(os.path.join(folder, n))
    ]
    paths.sort(key=os.path.getmtime)
    return paths


def requeue_quarantined(folder: str) -> list[str]:
    """Strip the ``.quarantined`` suffix from every quarantined file and
    clear any stale sidecar failure counter for it, so the next ingest
    pass retries from scratch — the tooling replacement for manual
    renames.  The quarantining pass normally pops the counter itself,
    but it persists the sidecar only at pass end: a pass killed between
    the rename and the save leaves the old count armed, and a manual
    rename would then re-quarantine the file almost immediately.
    Returns the restored file names."""
    counts = _load_failure_counts(folder)
    restored = []
    dirty = False
    for path in list_quarantined(folder):
        dest = path[: -len(QUARANTINE_SUFFIX)]
        if os.path.exists(dest):
            # a live log has taken the name back (same-second rotation
            # reuse); renaming over it would destroy real rows
            print(
                f"[tpu-perf-torch] not requeueing {os.path.basename(path)}: "
                f"{os.path.basename(dest)} already exists",
                file=sys.stderr, flush=True,
            )
            continue
        os.replace(path, dest)
        name = os.path.basename(dest)
        if counts.pop(name, None) is not None:
            dirty = True
        restored.append(name)
    if dirty:
        _save_failure_counts(folder, counts)
    return restored


def run_ingest_pass(
    folder: str,
    *,
    skip_newest: int = 10,
    backend: IngestBackend | None = None,
    prefix: str = LEGACY_PREFIX,
    max_failures: int = MAX_INGEST_FAILURES,
) -> int:
    """One scan-ingest-delete pass; returns the number of files ingested.

    A failing file is kept for retry (delete-only-after-success), but no
    longer forever: after ``max_failures`` CONSECUTIVE counted failures
    it is renamed to ``<name>.quarantined`` — a poison file must not
    re-fail every pass and spam stderr for the soak's lifetime — and the
    pass moves on to the next file, so one bad upload never starves the
    backlog behind it.  Failures are counted toward quarantine ONLY in a
    pass where some other file ingested successfully: a success proves
    the backend is alive, so the failure is file-specific — a backend
    outage (every file failing, nothing succeeding) must not burn down
    the whole backlog's counters and silently quarantine it.  The first
    un-quarantined error is re-raised at the end (the caller's
    retry/report contract is unchanged)."""
    backend = backend or NullBackend()
    counts = _load_failure_counts(folder)
    dirty = False
    count = 0
    failures: list[tuple[str, str, Exception]] = []
    for path in eligible_files(folder, skip_newest, prefix=prefix):
        name = os.path.basename(path)
        try:
            backend.ingest(path)
        except Exception as e:  # noqa: BLE001 — judged per file after the
            # pass: quarantine or keep-for-retry, never abandon the rest
            # of the backlog
            failures.append((name, path, e))
            continue
        os.remove(path)  # delete only after success (kusto_ingest.py:41-44)
        if counts.pop(name, None) is not None:
            dirty = True  # a success resets the consecutive-failure count
        count += 1
    first_err: Exception | None = None
    backend_alive = count > 0
    for name, path, e in failures:
        if backend_alive:
            n = counts.get(name, 0) + 1
            dirty = True
            if n >= max_failures:
                os.replace(path, path + QUARANTINE_SUFFIX)
                counts.pop(name, None)
                print(
                    f"[tpu-perf-torch] ingest failed {n}x for {name}; quarantined "
                    f"as {name}{QUARANTINE_SUFFIX}: {e}",
                    file=sys.stderr, flush=True,
                )
                continue  # handled; not a retryable error anymore
            counts[name] = n
        if first_err is None:
            first_err = e
    if dirty:
        _save_failure_counts(folder, counts)
    if first_err is not None:
        raise first_err
    return count


def run_all_ingest_passes(
    folder: str,
    *,
    skip_newest: int = 10,
    backend: IngestBackend | None = None,
) -> int:
    """One pass over every rotating-log family (tcp-*, tpu-*, health-*,
    chaos-*, spans-*) — what one `tpu-perf-torch ingest` invocation
    sweeps; returns the total.  The CSV families apply ``skip_newest``
    (the reference's flow heuristic: the newest N files are still being
    written).  The JSONL families do not: their lazy logs keep the
    active file under a ``.open`` suffix, so every ``<prefix>-*.log`` on
    disk is finished, and the count heuristic would starve them (a
    sparse family's newest file can stay newest forever)."""
    backend = backend or NullBackend()
    return sum(
        run_ingest_pass(
            folder,
            skip_newest=0 if prefix in LAZY_PREFIXES else skip_newest,
            backend=backend, prefix=prefix)
        for prefix in PREFIXES
    )


def ingest_command(folder: str, skip_newest: int) -> list[str]:
    """The rotation-ingest command line — ``TPU_PERF_INGEST_CMD`` if set
    (the same env contract the C backend honors, tpu_mpi_perf.c; a shell
    line, so the operator can pin it off the measurement cores exactly
    like the reference's ``numactl -N 1 python3 ... kusto_ingest.py``,
    mpi_perf.c:363-364), else this interpreter running the framework's
    own ingest pass."""
    override = os.environ.get("TPU_PERF_INGEST_CMD")
    if override:
        return ["/bin/sh", "-c", override]
    return [sys.executable, "-m", "tpu_perf_torch", "ingest",
            "-d", folder, "-f", str(skip_newest)]


class SubprocessIngest:
    """Rotation hook running the ingest pass in a separate process, off
    the measurement thread (the reference forks its uploader the same
    way, mpi_perf.c:363-364 — the benchmark loop must never stall on a
    slow telemetry pass).

    * non-blocking: ``Popen`` at rotation, ``poll`` only — the measured
      run cadence is unaffected by ingest duration;
    * skip-if-still-running: when the previous pass is still alive the
      rotation spawns nothing; its un-ingested files stay eligible
      (delete-only-after-success) and are retried next rotation;
    * failure is non-fatal: a non-zero exit is reported to stderr at the
      next rotation (or at :meth:`finish`) and the pass retried.
    """

    def __init__(self, cmd: list[str], *, err=None, popen=subprocess.Popen):
        self.cmd = list(cmd)
        self.err = err
        self._popen = popen
        self._proc = None

    def _stream(self):
        return self.err if self.err is not None else sys.stderr

    def _reap(self) -> bool:
        """True when no pass is in flight (ready to spawn)."""
        if self._proc is None:
            return True
        rc = self._proc.poll()
        if rc is None:
            print(
                "[tpu-perf-torch] previous ingest pass still running; skipping "
                "this rotation (files retried next pass)",
                file=self._stream(), flush=True,
            )
            return False
        if rc != 0:
            print(f"[tpu-perf-torch] ingest pass exited {rc} "
                  f"({shlex.join(self.cmd)}); files kept for retry",
                  file=self._stream(), flush=True)
        self._proc = None
        return True

    def __call__(self) -> None:
        if not self._reap():
            return
        self._proc = self._popen(self.cmd)

    def finish(self, timeout: float | None = 60.0) -> None:
        """Drain an in-flight pass at driver exit so it is not orphaned;
        report (never raise) a failure or timeout."""
        if self._proc is None:
            return
        try:
            rc = self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            print("[tpu-perf-torch] ingest pass still running at exit; leaving "
                  "it to finish detached", file=self._stream(), flush=True)
            return
        if rc != 0:
            print(f"[tpu-perf-torch] ingest pass exited {rc} "
                  f"({shlex.join(self.cmd)}); files kept for retry",
                  file=self._stream(), flush=True)
        self._proc = None


def build_backend_from_env() -> IngestBackend:
    """Backend selection via ``TPU_PERF_INGEST``:

    * unset or ``none``  -> :class:`NullBackend`
    * ``local:<dir>``    -> :class:`LocalDirBackend`
    * ``kusto:<uri>[,db[,table[,table_ext[,table_health[,table_chaos
      [,table_spans]]]]]]`` -> :class:`KustoBackend`
    """
    spec = os.environ.get("TPU_PERF_INGEST", "none")
    if spec in ("", "none"):
        return NullBackend()
    kind, _, rest = spec.partition(":")
    if kind == "local":
        if not rest:
            raise ValueError("TPU_PERF_INGEST=local:<dir> requires a directory")
        return LocalDirBackend(rest)
    if kind == "kusto":
        parts = rest.split(",")
        if not parts[0]:
            raise ValueError(
                "TPU_PERF_INGEST=kusto:<ingest-uri>[,db[,table[,table_ext"
                "[,table_health[,table_chaos[,table_spans]]]]]]"
            )
        return KustoBackend(*parts[:7])
    raise ValueError(f"unknown TPU_PERF_INGEST backend {spec!r}")
