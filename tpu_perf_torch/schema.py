"""Result-row schemas and CSV emission (copy of ``tpu_perf/schema.py``'s
row types; the bytes written are identical, so the JAX package's
``ResultRow.from_csv`` and its reports read this package's logs).

* **Legacy rows** reproduce the reference's Kusto CSV (mpi_perf.c:550-554)::

      Timestamp,JobId,Rank,VMCount,LocalIP,RemoteIP,NumOfFlows,BufferSize,
      NumOfBuffers,TimeTakenms,RunId

* **Result rows** are the extended per-sweep-point schema.  This package
  writes ``backend="torch-sim"`` for the single-card sim world (n > 1
  ranks on one card) and ``backend="torch"`` for a one-rank run, which
  measures the card itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import json

LEGACY_HEADER = (
    "Timestamp,JobId,Rank,VMCount,LocalIP,RemoteIP,NumOfFlows,"
    "BufferSize,NumOfBuffers,TimeTakenms,RunId"
)

#: log-file prefixes, one per schema (the JAX package's names, so one
#: ingest/report pass reads both packages' folders)
LEGACY_PREFIX = "tcp"
EXT_PREFIX = "tpu"
HEALTH_PREFIX = "health"  # JSONL health events (tpu_perf_torch.health)
CHAOS_PREFIX = "chaos"    # JSONL fault-injection ledger (tpu_perf_torch.faults)
SPANS_PREFIX = "spans"    # JSONL harness spans (tpu_perf_torch.spans)

#: every rotating-log family this package writes, the ones one ingest
#: pass sweeps (the JAX package's linkmap, fleet and tune families wait
#: for their subsystems: ROADMAP)
ALL_PREFIXES = (LEGACY_PREFIX, EXT_PREFIX, HEALTH_PREFIX, CHAOS_PREFIX,
                SPANS_PREFIX)

RESULT_HEADER = (
    "timestamp,job_id,backend,op,nbytes,iters,run_id,n_devices,"
    "lat_us,algbw_gbps,busbw_gbps,time_ms,dtype,mode,overhead_us,"
    "runs_requested,runs_taken,ci_rel"
)


class JsonlRecord:
    """Free-form JSONL row of the lazy log families: duck-typed as a row
    (``to_csv`` is the JSON line), so a JSONL family's log is a
    RotatingCsvLog.  Record types share a stream through the required
    ``record`` discriminator; subclasses set ``FAMILY`` for messages."""

    __slots__ = ("data",)
    FAMILY = "jsonl"

    def __init__(self, **data):
        if "record" not in data:
            raise ValueError(
                f"{self.FAMILY} records need a 'record' discriminator"
            )
        self.data = data

    def to_json(self) -> str:
        return json.dumps(self.data, sort_keys=True)

    to_csv = to_json  # the RotatingCsvLog row interface

    @classmethod
    def from_json(cls, line: str):
        try:
            data = json.loads(line)
        except json.JSONDecodeError:
            raise ValueError(
                f"bad {cls.FAMILY} record line: {line!r}"
            ) from None
        if not isinstance(data, dict) or "record" not in data:
            raise ValueError(f"not a {cls.FAMILY} record: {line!r}")
        return cls(**data)


def window_index(run_id: int, stats_every: int) -> int:
    """Heartbeat-window index of a run: runs ``1..stats_every`` and the
    boundary heartbeat that covers them share window 0.  Health events,
    JSON heartbeats and chaos ledger records all join on it."""
    return max(0, run_id - 1) // max(1, stats_every)


def timestamp_now() -> str:
    """Wall-clock timestamp in the reference's format (mpi_perf.c:341-353):
    ``YYYY-MM-DD HH:MM:SS.mmm``, local time."""
    now = datetime.datetime.now()
    return now.strftime("%Y-%m-%d %H:%M:%S.") + f"{now.microsecond // 1000:03d}"


@dataclasses.dataclass(frozen=True)
class LegacyRow:
    """One reference-schema CSV row (one run of `iters` messages on one rank)."""

    timestamp: str
    job_id: str
    rank: int
    vm_count: int
    local_ip: str
    remote_ip: str
    num_flows: int
    buffer_size: int
    num_buffers: int  # = iters (mpi_perf.c:553 logs opts.iters as NumOfBuffers)
    time_taken_ms: float
    run_id: int

    def to_csv(self) -> str:
        return (
            f"{self.timestamp},{self.job_id},{self.rank},{self.vm_count},"
            f"{self.local_ip},{self.remote_ip},{self.num_flows},"
            f"{self.buffer_size},{self.num_buffers},{self.time_taken_ms:.3f},"
            f"{self.run_id}"
        )

    @classmethod
    def from_csv(cls, line: str) -> "LegacyRow":
        parts = line.rstrip("\n").split(",")
        if len(parts) != 11:
            raise ValueError(f"expected 11 fields, got {len(parts)}: {line!r}")
        return cls(
            timestamp=parts[0],
            job_id=parts[1],
            rank=int(parts[2]),
            vm_count=int(parts[3]),
            local_ip=parts[4],
            remote_ip=parts[5],
            num_flows=int(parts[6]),
            buffer_size=int(parts[7]),
            num_buffers=int(parts[8]),
            time_taken_ms=float(parts[9]),
            run_id=int(parts[10]),
        )


@dataclasses.dataclass(frozen=True)
class ResultRow:
    """One extended-schema row: a single run of one sweep point.

    The fields and their CSV rendering are the JAX package's, column for
    column.  Trailing optional columns (span, algo, skew, imbalance,
    stream, load) are rendered only when set, exactly as there: this
    package sets ``stream`` (``run --streams K``: the 1-based lane) and
    ``load`` (``contend``), so most of its rows are the 18-field form.
    """

    timestamp: str
    job_id: str
    backend: str  # "torch-sim" | "torch"
    op: str
    nbytes: int
    iters: int
    run_id: int
    n_devices: int
    lat_us: float
    algbw_gbps: float
    busbw_gbps: float
    time_ms: float
    dtype: str = "float32"
    mode: str = "oneshot"
    overhead_us: float = 0.0
    runs_requested: int = 0
    runs_taken: int = 0
    ci_rel: float = 0.0
    span_id: str = ""
    algo: str = ""
    skew_us: int = 0
    imbalance: int = 1
    stream: int = 0
    load: str = ""

    def to_csv(self) -> str:
        base = (
            f"{self.timestamp},{self.job_id},{self.backend},{self.op},"
            f"{self.nbytes},{self.iters},{self.run_id},{self.n_devices},"
            f"{self.lat_us:.3f},{self.algbw_gbps:.6g},{self.busbw_gbps:.6g},"
            f"{self.time_ms:.3f},{self.dtype},{self.mode},"
            f"{self.overhead_us:.3f},{self.runs_requested},"
            f"{self.runs_taken},{self.ci_rel:.6g}"
        )
        if self.load:
            return (f"{base},{self.span_id},{self.algo},{self.skew_us},"
                    f"{self.imbalance},{self.stream},{self.load}")
        if self.stream > 0:
            return (f"{base},{self.span_id},{self.algo},{self.skew_us},"
                    f"{self.imbalance},{self.stream}")
        if self.imbalance > 1:
            return (f"{base},{self.span_id},{self.algo},{self.skew_us},"
                    f"{self.imbalance}")
        if self.skew_us:
            return f"{base},{self.span_id},{self.algo},{self.skew_us}"
        if self.algo:
            return f"{base},{self.span_id},{self.algo}"
        return f"{base},{self.span_id}" if self.span_id else base

    @classmethod
    def from_csv(cls, line: str) -> "ResultRow":
        parts = line.rstrip("\n").split(",")
        if len(parts) not in (12, 13, 15, 18, 19, 20, 21, 22, 23, 24):
            raise ValueError(
                f"expected 12, 13, 15, 18, 19, 20, 21, 22, 23, or 24 "
                f"fields, got {len(parts)}: {line!r}"
            )
        return cls(
            timestamp=parts[0],
            job_id=parts[1],
            backend=parts[2],
            op=parts[3],
            nbytes=int(parts[4]),
            iters=int(parts[5]),
            run_id=int(parts[6]),
            n_devices=int(parts[7]),
            lat_us=float(parts[8]),
            algbw_gbps=float(parts[9]),
            busbw_gbps=float(parts[10]),
            time_ms=float(parts[11]),
            dtype=parts[12] if len(parts) >= 13 else "float32",
            mode=parts[13] if len(parts) >= 15 else "oneshot",
            overhead_us=float(parts[14]) if len(parts) >= 15 else 0.0,
            runs_requested=int(parts[15]) if len(parts) >= 18 else 0,
            runs_taken=int(parts[16]) if len(parts) >= 18 else 0,
            ci_rel=float(parts[17]) if len(parts) >= 18 else 0.0,
            span_id=parts[18] if len(parts) >= 19 else "",
            algo=parts[19] if len(parts) >= 20 else "",
            skew_us=int(parts[20]) if len(parts) >= 21 and parts[20] else 0,
            imbalance=int(parts[21]) if len(parts) >= 22 and parts[21]
            else 1,
            stream=int(parts[22]) if len(parts) >= 23 and parts[22] else 0,
            load=parts[23] if len(parts) >= 24 else "",
        )



def decorate_op(op: str, algo: str = "", skew_us: int = 0,
                imbalance: int = 1, load: str = "") -> str:
    """The decorated point label (``op[algo]@500us%8&load``), the JAX
    package's one spelling; ``native``/empty algo, zero skew, imbalance 1
    and an empty load decorate nothing, so this package's rows keep their
    bare op names."""
    if algo and algo != "native":
        op = f"{op}[{algo}]"
    if skew_us:
        op = f"{op}@{skew_us}us"
    if imbalance > 1:
        op = f"{op}%{imbalance}"
    if load:
        op = f"{op}&{load}"
    return op


def parse_op_label(label: str) -> tuple[str, str, int, int, str]:
    """The inverse of :func:`decorate_op`: ``(op, algo, skew_us,
    imbalance, load)`` of a decorated label, with ``("", 0, 1, "")``
    coordinates for an undecorated one.  Coordinates strip in reverse
    append order, so ``load`` (appended last) strips first."""
    rest = str(label)
    load = ""
    head, sep, tail = rest.rpartition("&")
    if sep and tail:
        rest, load = head, tail
    imbalance = 1
    head, sep, tail = rest.rpartition("%")
    if sep and tail.isdigit():
        rest, imbalance = head, int(tail)
    skew_us = 0
    head, sep, tail = rest.rpartition("@")
    if sep and tail.endswith("us") and tail[:-2].isdigit():
        rest, skew_us = head, int(tail[:-2])
    algo = ""
    if rest.endswith("]") and "[" in rest:
        rest, _, algo = rest[:-1].partition("[")
    return rest, algo, skew_us, imbalance, load


def base_op(label: str) -> str:
    """Every experiment coordinate stripped off a decorated label
    (``allreduce[ring]@500us%8`` -> ``allreduce``)."""
    return parse_op_label(label)[0]
