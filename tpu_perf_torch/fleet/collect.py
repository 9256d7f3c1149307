"""Cross-host record collection: streaming readers over N hosts' folders
(port of ``tpu_perf/fleet/collect.py``).

The fleet layout is one root directory holding one subfolder per host —
exactly what a fleet of ``-l``-configured daemons leaves behind a shared
mount (or what a sync job pulls from each host's local log folder)::

    fleet-root/
      host-a/   tcp-*.log tpu-*.log health-*.log chaos-*.log
                linkmap-*.log spans-*.log phase-*.json ...
      host-b/   ...

Every reader here **streams**: a row is parsed, folded into O(points)
aggregation state, and dropped — ``tpu-perf-torch fleet report`` over a
week-long soak's millions of rows holds kilobytes, never the row set
(the bounded-memory contract tests/test_fleet.py proves with a
generated large folder).  The readers tolerate the states a LIVE fleet
exhibits by construction:

* **torn final line** — a daemon mid-append (or hard-killed) tears its
  last line; skipped with a note, exactly the policy every JSONL replay
  applies (health.events.read_jsonl).  Corruption anywhere *else* in a
  file still raises: a log must not silently thin out.
* **live ``.open`` tails** — the lazy families' active file; read like
  any other (its final line is the torn-line candidate).
* **rotated mid-read** — a ``.open`` tail that closed (renamed to its
  bare ``.log`` name) between the directory scan and the open is
  re-resolved to the finished file; a bare ``.log`` the ingest pass
  deleted mid-read is skipped with a note (its rows are in the
  telemetry store, not lost).
* **quarantined files** — ``<name>.quarantined`` never matches the
  family scan shape and is never read (poison rows stay out of fleet
  judgements the same way they stay out of ingest).
"""

from __future__ import annotations

import os
import sys

from tpu_perf_torch.report import collect_paths
from tpu_perf_torch.schema import ALL_PREFIXES, FLEET_PREFIX, ResultRow

#: the families a HOST emits — everything except the fleet-rollup
#: family, which is this collector's own OUTPUT: a rollup folder inside
#: the fleet root (`fleet report -l <root>/rollups`) must not be
#: discovered as a phantom zero-row host on the next pass
HOST_PREFIXES = tuple(p for p in ALL_PREFIXES if p != FLEET_PREFIX)


def _open_tolerant(path: str, err):
    """Open a scanned file, tolerating the rename/delete races a live
    fleet produces between the scan and the open (module docstring)."""
    try:
        return open(path)
    except FileNotFoundError:
        if path.endswith(".open"):
            closed = path[: -len(".open")]
            try:
                fh = open(closed)
                print(f"tpu-perf-torch: {os.path.basename(path)} rotated "
                      f"mid-read; reading the finished "
                      f"{os.path.basename(closed)}", file=err)
                return fh
            except FileNotFoundError:
                pass
        print(f"tpu-perf-torch: {os.path.basename(path)} vanished mid-read "
              "(ingested?); skipped", file=err)
        return None


def stream_parsed(paths, parse, *, err=None):
    """Stream parsed records from ``paths``, one line at a time —
    bounded memory regardless of row count.

    ``parse(line)`` returns a record, ``None`` to skip the line (e.g. a
    CSV header), or raises ValueError on a malformed line.  A malformed
    FINAL line is the expected live-tail state and is skipped with a
    note; malformed anywhere else raises — same torn-line contract as
    the non-streaming JSONL readers, proven line-deferred here because
    a generator cannot look ahead to know which line is last."""
    err = err if err is not None else sys.stderr
    for path in paths:
        fh = _open_tolerant(path, err)
        if fh is None:
            continue
        with fh:
            pending: ValueError | None = None
            for raw in fh:
                if pending is not None:
                    # the bad line had a successor: mid-file corruption
                    raise ValueError(f"{path}: {pending}")
                line = raw.strip()
                if not line:
                    continue
                try:
                    rec = parse(line)
                except ValueError as e:
                    pending = e
                    continue
                if rec is not None:
                    yield rec
            if pending is not None:
                print(f"tpu-perf-torch: skipping torn final line of {path}",
                      file=err)


def _parse_row(line: str) -> ResultRow | None:
    if line.startswith("timestamp,job_id,"):
        return None  # a `run --csv` header of any schema revision
    return ResultRow.from_csv(line)


def stream_rows(paths, *, err=None):
    """Stream extended-schema result rows (tpu-*.log)."""
    return stream_parsed(paths, _parse_row, err=err)


def stream_jsonl(paths, record_cls, *, err=None):
    """Stream one JSONL family's record dicts through its own record
    class (one parser per contract, like faults.read_ledger)."""
    return stream_parsed(
        paths, lambda line: record_cls.from_json(line).data, err=err)


def host_paths(folder: str, prefix: str, *,
               include_open: bool = True) -> list[str]:
    """One host folder's files of one family (finished logs + the live
    ``.open`` tail; ``.quarantined`` files never match the shape)."""
    return collect_paths(folder, prefix=prefix, include_open=include_open)


def _has_records(folder: str) -> bool:
    try:
        names = os.listdir(folder)
    except (FileNotFoundError, NotADirectoryError):
        return False
    for n in names:
        if n.startswith("phase-") and n.endswith(".json"):
            return True
        for prefix in HOST_PREFIXES:
            if n.startswith(prefix + "-") and (
                    n.endswith(".log") or n.endswith(".log.open")):
                return True
    return False


def discover_hosts(root: str) -> dict[str, str]:
    """Host name -> folder.  Subdirectories of ``root`` holding any
    rotating-family file (or phase sidecar) are hosts; a root that IS a
    single record folder counts as a one-host fleet named after its
    directory — so the fleet surfaces degrade gracefully to the
    single-host layout every existing script produces."""
    hosts: dict[str, str] = {}
    try:
        names = sorted(os.listdir(root))
    except FileNotFoundError:
        return hosts
    for name in names:
        path = os.path.join(root, name)
        if os.path.isdir(path) and _has_records(path):
            hosts[name] = path
    if not hosts and _has_records(root):
        base = os.path.basename(os.path.abspath(root).rstrip(os.sep))
        hosts[base or "host"] = root
    return hosts


def last_seen(folder: str) -> float | None:
    """Newest mtime across every family file and sidecar in the host's
    folder — the staleness clock.  mtime (not the file-name timestamp)
    because a daemon APPENDS to its open logs: the name says when the
    file opened, the mtime says when the host last wrote anything."""
    newest: float | None = None
    for prefix in HOST_PREFIXES:
        for path in host_paths(folder, prefix):
            try:
                t = os.path.getmtime(path)
            except OSError:
                continue  # rotated/ingested between scan and stat
            newest = t if newest is None else max(newest, t)
    import glob

    for path in glob.glob(os.path.join(folder, "phase-*.json")):
        try:
            t = os.path.getmtime(path)
        except OSError:
            continue
        newest = t if newest is None else max(newest, t)
    return newest
