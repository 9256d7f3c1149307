"""Dead-letter spool (port of ``tpu_perf/push/spool.py``): undeliverable
push batches, durable on disk.

When the sender exhausts its retries for a batch (sink down longer than
the backoff window covers), the batch is **dead-lettered**: written to
``push-<family>-<job>-<rank>-<seq>.spool.quarantined`` next to the
rotating logs.  The naming is deliberate — it reuses the ingest
quarantine contract (ingest.pipeline.QUARANTINE_SUFFIX) end to end:

* ``tpu-perf-torch ingest --list-quarantined`` lists spooled batches next to
  poison ingest files (one triage surface for both planes);
* ``tpu-perf-torch ingest --requeue`` strips the suffix, turning the file
  into a *live* spool (``push-*.spool``) — and refuses to clobber an
  existing live spool, exactly as it refuses to clobber a live log;
* a live spool is replayed by the first healthy sender that sees it
  (a running ``--push`` soak's background plane, or ``tpu-perf-torch push
  replay``), and deleted only after successful delivery — the
  delete-only-after-success stance the ingest pass takes with files.

Spool files can never collide with any other scan: the ingest pass
matches ``<prefix>-*.log`` only, and ``push`` is not a family prefix.  The family rides in the file NAME (families are
dash-free by construction — schema.ALL_PREFIXES), so replay needs no
header line inside the payload and the payload bytes are exactly the
records that failed to send.
"""

from __future__ import annotations

import os

from tpu_perf_torch.ingest.pipeline import QUARANTINE_SUFFIX
from tpu_perf_torch.schema import ALL_PREFIXES

#: spool files are ``push-...`` — NOT a rotating family prefix, so no
#: ingest/collector scan ever matches them
SPOOL_PREFIX = "push"
SPOOL_SUFFIX = ".spool"


def spool_name(family: str, job_id: str, rank: int, seq: int) -> str:
    return f"{SPOOL_PREFIX}-{family}-{job_id}-{rank}-{seq:06d}{SPOOL_SUFFIX}"


def parse_spool_family(name: str) -> str | None:
    """The family a spool file (live or quarantined) holds, or None for
    a non-spool name.  Families carry no dash (schema.ALL_PREFIXES), so
    the second dash-field IS the family — job UUIDs after it may dash
    freely."""
    base = os.path.basename(name)
    if base.endswith(QUARANTINE_SUFFIX):
        base = base[: -len(QUARANTINE_SUFFIX)]
    if not base.startswith(SPOOL_PREFIX + "-") \
            or not base.endswith(SPOOL_SUFFIX):
        return None
    parts = base.split("-", 2)
    if len(parts) < 3 or parts[1] not in ALL_PREFIXES:
        return None
    return parts[1]


def write_spool(folder: str, family: str, job_id: str, rank: int,
                lines: list[str], *, seq: int,
                quarantine: bool = True) -> str:
    """Persist one dead-lettered batch atomically (tmp + rename: a
    replayer can never read a torn batch).  ``quarantine=True`` (the
    dead-letter default) lands the file under the ``.quarantined``
    suffix — exhausted retries mean the sink needs an operator, and the
    requeue step is their explicit "try again".  Returns the path."""
    os.makedirs(folder, exist_ok=True)
    stem = spool_name(family, job_id, rank, seq)[: -len(SPOOL_SUFFIX)]
    suffix = SPOOL_SUFFIX + (QUARANTINE_SUFFIX if quarantine else "")
    path = os.path.join(folder, stem + suffix)
    i = 0
    while os.path.exists(path):
        # seq is unique per plane instance; a collision means another
        # process shares the (job, rank) identity — disambiguate rather
        # than overwrite someone else's dead letters.  The counter goes
        # BEFORE the suffixes: a name that stopped ending in
        # .spool/.quarantined would be invisible to every recovery tool
        # (triage, requeue, replay, the depth gauge)
        i += 1
        path = os.path.join(folder, f"{stem}.{i}{suffix}")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        for line in lines:
            fh.write(line + "\n")
    os.replace(tmp, path)
    return path


def live_spool_files(folder: str) -> list[tuple[str, str]]:
    """Replayable (path, family) pairs — live spools only (quarantined
    ones need the operator's ``ingest --requeue`` first), oldest first
    so replay preserves rough record order."""
    try:
        names = os.listdir(folder)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        if n.endswith(QUARANTINE_SUFFIX) or n.endswith(".tmp"):
            continue
        family = parse_spool_family(n)
        if family is None:
            continue
        path = os.path.join(folder, n)
        try:
            # capture mtime in the same step as the existence check: a
            # concurrent replayer (another rank's plane sharing the
            # logfolder, or an operator's `push replay` against a live
            # soak) may delete the file between listdir and stat, and
            # a raise here would kill the caller's sender thread
            if not os.path.isfile(path):
                continue
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        out.append((mtime, path, family))
    out.sort()
    return [(path, family) for _, path, family in out]


def spool_depth(folder: str | None) -> int:
    """Spool files on disk, live AND quarantined — the gauge an
    operator alerts on (any depth > 0 means undelivered telemetry)."""
    if not folder:
        return 0
    try:
        names = os.listdir(folder)
    except FileNotFoundError:
        return 0
    return sum(1 for n in names
               if parse_spool_family(n) is not None
               and not n.endswith(".tmp"))


def read_spool(path: str) -> list[str]:
    """A spool file's payload lines (written atomically, so no torn-
    line policy is needed here)."""
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if ln.strip()]
