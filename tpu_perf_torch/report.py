"""Result aggregation: extended-schema CSV -> per-sweep-point curve tables
(copy of the parts of ``tpu_perf/report.py`` that read what this package
writes).

Feed it rotated ``tpu-*.log`` files (or ``run --csv`` stdout) and get the
(op, nbytes) -> {p50 latency, bus bandwidth} curves, the accelerator-vs-MPI
pivot (``compare``), each ``pl_*`` kernel beside its library op
(``compare_pallas``), and the diff of two artifacts.  The pivots keep this
package's backends, ``torch`` (one rank) and ``torch-sim`` (the sim
world), where the JAX package's keep ``jax``; so does the interference
matrix of ``contend``'s loaded rows against their idle twins.  The
chaos, arena, hier, straggler, scenario, imbalance, adaptive, phases and
push views wait for their modules (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
from typing import Iterable

from tpu_perf_torch.metrics import (
    KNOWN_OPS, flops_per_iter_dtype, is_latency_only, summarize,
)
from tpu_perf_torch.schema import (
    EXT_PREFIX, LEGACY_HEADER, LegacyRow, ResultRow, decorate_op,
)
from tpu_perf_torch.sweep import format_size

#: the backends this package's rows carry: the pivots' accelerator side
TORCH_BACKENDS = ("torch", "torch-sim")


@dataclasses.dataclass(frozen=True)
class CurvePoint:
    """Aggregate of all runs of one (backend, op, nbytes, dtype,
    n_devices) sweep point.  Backend is part of the key so MPI-baseline
    rows and accelerator rows in the same folder stay side-by-side instead
    of pooling into one mixed distribution; dtype is part of the key
    because a bf16 row moves twice the elements per byte of an f32 row —
    pooling them would mix two different measurements under one curve;
    mode is part of the key because a daemon's back-to-back visits run
    under other conditions than a one-shot sweep — pooling or diffing
    them against one-shot rows manufactures phantom changes."""

    backend: str
    op: str
    nbytes: int
    n_devices: int
    runs: int
    lat_us: dict[str, float]  # min/max/avg/p50/p95/p99
    busbw_gbps: dict[str, float]
    algbw_gbps: dict[str, float]
    dtype: str = "float32"
    mode: str = "oneshot"  # "oneshot" | "daemon" | "chaos" (pre-mode
    # artifacts were all one-shot grid/publish runs, so the default
    # backfills them)
    tflops: dict[str, float] | None = None  # compute ops only
    # (metrics.FLOPS_PER_ITER): TFLOP/s from each row's latency
    algo: str = "native"  # collective decomposition (the JAX arena's);
    # part of the key — an arena experiment's rows must never pool with
    # the native lowering's curve, and like chaos rows they stay out of
    # the clean compare pivots (compare_arena is their own view)
    skew_us: int = 0  # arrival-spread coordinate (--skew-spread); part
    # of the key — a skewed point runs systematically slow BY DESIGN
    # (the straggler cost is the measurement), so it must never pool
    # with the synchronized-entry curve; straggler_cost is its view
    imbalance: int = 1  # per-rank payload ratio (--imbalance); part of
    # the key — an imbalanced point moves a different per-rank byte
    # distribution BY DESIGN, so it must never pool with the balanced
    # curve; imbalance_cost / scenario_steps are its views
    load: str = ""  # the concurrent background load the point raced
    # against (tpu-perf contend); part of the key — a loaded point runs
    # slow BY DESIGN (the interference IS the measurement), so it must
    # never pool with the idle curve; interference_matrix is its view,
    # and compare_arena treats it as a crossover dimension (the loaded
    # winner).  The stream column is deliberately NOT here: a dispatch
    # lane runs the same program as the serial walk, so lanes POOL.


def read_rows(paths: Iterable[str]) -> list[ResultRow]:
    """Parse extended-schema rows from files; ``run --csv`` headers (any
    schema revision's — the header evolves with the column set) and blank
    lines are skipped, malformed lines raise."""
    rows: list[ResultRow] = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("timestamp,job_id,"):
                    continue
                rows.append(ResultRow.from_csv(line))
    return rows


def collect_paths(target: str, *, prefix: str = EXT_PREFIX,
                  include_open: bool = False) -> list[str]:
    """A file, a directory (its <prefix>-*.log files), or a glob pattern.

    ``include_open`` also collects the lazy families' ACTIVE
    ``<prefix>-*.log.open`` file from a directory target (health/chaos
    logs carry the suffix until closed; a live-daemon replay or a
    killed soak's conformance pass must see those rows too)."""
    if os.path.isfile(target):
        return [target]
    if os.path.isdir(target):
        pats = [f"{prefix}-*.log"]
        if include_open:
            pats.append(f"{prefix}-*.log.open")
        return sorted(
            p for pat in pats for p in glob.glob(os.path.join(target, pat))
        )
    return sorted(glob.glob(target))


@dataclasses.dataclass(frozen=True)
class LegacyPoint:
    """Aggregate of all legacy-schema rows sharing one measurement config.
    The reference schema records no kernel/op, so the key is the config
    triple it does carry; only wall-time stats are honest (bandwidth would
    need the kernel's direction count)."""

    buffer_size: int
    num_flows: int
    vm_count: int
    num_buffers: int
    rows: int
    ranks: int
    time_ms: dict[str, float]  # min/max/avg/p50/p95/p99


def read_legacy_rows(paths: Iterable[str]) -> list[LegacyRow]:
    """Parse reference-schema rows (tcp-*.log; header-less in the
    reference, but a header line is tolerated)."""
    rows: list[LegacyRow] = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line == LEGACY_HEADER:
                    continue
                rows.append(LegacyRow.from_csv(line))
    return rows


def aggregate_legacy(rows: list[LegacyRow]) -> list[LegacyPoint]:
    groups: dict[tuple, list[LegacyRow]] = {}
    for row in rows:
        groups.setdefault(
            (row.buffer_size, row.num_flows, row.vm_count, row.num_buffers), []
        ).append(row)
    points = []
    for (size, flows, vms, bufs), grp in sorted(groups.items()):
        points.append(
            LegacyPoint(
                buffer_size=size, num_flows=flows, vm_count=vms,
                num_buffers=bufs, rows=len(grp),
                ranks=len({r.rank for r in grp}),
                time_ms=summarize([r.time_taken_ms for r in grp]),
            )
        )
    return points


def legacy_to_markdown(points: list[LegacyPoint]) -> str:
    lines = [
        "| size | flows | VMs | msgs/run | rows | ranks | time p50 (ms) "
        "| time p95 (ms) | time max (ms) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for p in points:
        lines.append(
            f"| {format_size(p.buffer_size)} | {p.num_flows} | {p.vm_count} "
            f"| {p.num_buffers} | {p.rows} | {p.ranks} "
            f"| {p.time_ms['p50']:.3f} | {p.time_ms['p95']:.3f} "
            f"| {p.time_ms['max']:.3f} |"
        )
    return "\n".join(lines)


def aggregate(rows: list[ResultRow]) -> list[CurvePoint]:
    """Group rows by (backend, op, nbytes, dtype, n_devices, mode,
    algo, skew_us, imbalance, load); summarize each group.  The stream
    column is NOT a key: an overlapped sweep's lanes run the serial
    walk's exact programs, so their samples pool into the same curve."""
    groups: dict[tuple, list[ResultRow]] = {}
    for row in rows:
        groups.setdefault(
            (row.backend, row.op, row.nbytes, row.dtype, row.n_devices,
             row.mode, row.algo or "native", row.skew_us,
             row.imbalance, row.load), []
        ).append(row)
    points = []
    for (backend, op, nbytes, dtype, n, mode, algo, skew_us,
         imbalance, load), grp in sorted(groups.items()):
        points.append(
            CurvePoint(
                backend=backend,
                op=op,
                nbytes=nbytes,
                n_devices=n,
                runs=len(grp),
                lat_us=summarize([r.lat_us for r in grp]),
                busbw_gbps=summarize([r.busbw_gbps for r in grp]),
                algbw_gbps=summarize([r.algbw_gbps for r in grp]),
                dtype=dtype,
                mode=mode,
                algo=algo,
                skew_us=skew_us,
                imbalance=imbalance,
                load=load,
                tflops=_tflops(flops_per_iter_dtype(op, nbytes, dtype),
                               [r.lat_us for r in grp]),
            )
        )
    return points


def _tflops(flops: float | None, lats) -> dict[str, float] | None:
    """The derived TFLOP/s summary of one point's latencies; None for an
    op without a FLOP model, and for a point with any ``lat_us <= 0`` (a
    corrupt or foreign row: the bandwidth columns still render)."""
    if flops is None or any(v <= 0 for v in lats):
        return None
    return summarize([flops / (v * 1e-6) / 1e12 for v in lats])


def _fold_curve(groups: dict, r: ResultRow) -> None:
    """Fold one streamed row into the per-key compact sample columns
    :func:`_curve_points` summarizes."""
    from array import array

    key = (r.backend, r.op, r.nbytes, r.dtype, r.n_devices,
           r.mode, r.algo or "native", r.skew_us, r.imbalance, r.load)
    g = groups.get(key)
    if g is None:
        g = groups[key] = {
            "lat": array("d"), "bus": array("d"), "alg": array("d"),
        }
    g["lat"].append(r.lat_us)
    g["bus"].append(r.busbw_gbps)
    g["alg"].append(r.algbw_gbps)


def _curve_points(groups: dict) -> list[CurvePoint]:
    points = []
    for (backend, op, nbytes, dtype, n, mode, algo, skew_us,
         imbalance, load), g in sorted(groups.items()):
        lat = g["lat"]
        points.append(CurvePoint(
            backend=backend, op=op, nbytes=nbytes, n_devices=n,
            runs=len(lat),
            lat_us=summarize(list(lat)),
            busbw_gbps=summarize(list(g["bus"])),
            algbw_gbps=summarize(list(g["alg"])),
            dtype=dtype, mode=mode, algo=algo, skew_us=skew_us,
            imbalance=imbalance, load=load,
            tflops=_tflops(flops_per_iter_dtype(op, nbytes, dtype), lat),
        ))
    return points


def _open_tolerant(path: str, err):
    """Open a scanned file; one the ingest pass deleted between the scan
    and the open is skipped with a note (its rows are in the telemetry
    store, not lost)."""
    try:
        return open(path)
    except FileNotFoundError:
        print(f"tpu-perf-torch: {os.path.basename(path)} vanished mid-read "
              "(ingested?); skipped", file=err)
        return None


def stream_rows(paths: Iterable[str], *, err=None):
    """Stream extended-schema rows from ``paths``, one line at a time
    (the JAX package's ``fleet.collect.stream_rows``): ``run --csv``
    headers and blank lines are skipped; a malformed final line (a daemon
    mid-append) is skipped with a note, a malformed line anywhere else
    raises."""
    err = err if err is not None else sys.stderr
    for path in paths:
        fh = _open_tolerant(path, err)
        if fh is None:
            continue
        with fh:
            pending: ValueError | None = None
            for raw in fh:
                if pending is not None:
                    raise ValueError(f"{path}: {pending}")
                line = raw.strip()
                if not line or line.startswith("timestamp,job_id,"):
                    continue
                try:
                    row = ResultRow.from_csv(line)
                except ValueError as e:
                    pending = e
                    continue
                yield row
            if pending is not None:
                print(f"tpu-perf-torch: skipping torn final line of {path}",
                      file=err)


def stream_aggregate(paths: Iterable[str], *, err=None) -> list[CurvePoint]:
    """:func:`aggregate` with streaming input: rows are parsed one line
    at a time (:func:`stream_rows`),
    folded into per-key compact ``array('d')`` sample columns, and
    dropped, so a week-long soak's folder aggregates in memory
    proportional to samples-as-doubles, never rows-as-objects (the
    buffered path holds every ResultRow plus its strings — ~20x the
    bytes; tests/test_push.py pins the bound on a generated 150k-row
    folder).  Exact, not approximate: the per-key sample columns feed
    the same ``summarize`` the buffered path uses, so the rendered
    tables are byte-identical to ``aggregate(read_rows(paths))``.

    The torn-final-line policy is the fleet readers': a daemon
    mid-append (or hard-killed) tears its last line, which is skipped
    with a note; corruption anywhere else still raises."""
    groups: dict[tuple, dict] = {}
    for r in stream_rows(paths, err=err):
        _fold_curve(groups, r)
    return _curve_points(groups)



@dataclasses.dataclass(frozen=True)
class ComparePoint:
    """One (op, nbytes) curve key with both backends' p50s side-by-side:
    this package's accelerator rows (``torch`` or ``torch-sim``) against
    the MPI baseline, as a single row.  ``ratio`` is torch/mpi bus
    bandwidth (>1: the accelerator path is faster); latency ratio is
    mpi/torch so >1 also reads as 'torch better'."""

    op: str
    nbytes: int
    torch: CurvePoint | None
    mpi: CurvePoint | None
    dtype: str = "float32"

    @property
    def busbw_ratio(self) -> float | None:
        if self.torch is None or self.mpi is None:
            return None
        mpi_bw = self.mpi.busbw_gbps["p50"]
        return self.torch.busbw_gbps["p50"] / mpi_bw if mpi_bw else None

    @property
    def latency_ratio(self) -> float | None:
        if self.torch is None or self.mpi is None:
            return None
        torch_lat = self.torch.lat_us["p50"]
        return self.mpi.lat_us["p50"] / torch_lat if torch_lat else None


def _pivot_pref(p: CurvePoint) -> tuple:
    """Which point wins a pivot slot: one-shot beats daemon (claims come
    from one-shot sweeps), then the largest device count (the fullest
    fabric)."""
    return (p.mode == "oneshot", p.n_devices)


def compare(points: list[CurvePoint]) -> list[ComparePoint]:
    """Pivot curve points into per-(op, nbytes, dtype) backend
    comparisons.  Device counts may differ between backends (an 8-rank
    sim world vs a 2-rank MPI pair), so n_devices is NOT part of the pivot
    key; when one backend has several device counts at a key, the largest
    wins (the fullest fabric is the one the operator is comparing), with
    one-shot rows preferred over daemon rows.  ``torch`` and ``torch-sim``
    rows share the accelerator side.  Chaos-mode rows are excluded
    outright: their samples are deliberately fault-perturbed, so letting
    one win a slot would present injected degradation as the backend's
    performance."""
    by_key: dict[tuple, dict[str, CurvePoint]] = {}
    for p in points:
        if (p.mode == "chaos" or p.algo != "native" or p.skew_us
                or p.imbalance > 1 or p.load):
            # arena/scenario rows are a different implementation of the
            # op, skewed rows measured deliberately imbalanced entry,
            # and imbalanced rows a deliberately uneven payload; one
            # winning a pivot slot would present an experiment as the
            # backend's performance (the chaos-rows precedent) —
            # compare_arena / straggler_cost / imbalance_cost /
            # scenario_steps are their own views
            continue
        side = "torch" if p.backend in TORCH_BACKENDS else p.backend
        slot = by_key.setdefault((p.op, p.nbytes, p.dtype), {})
        cur = slot.get(side)
        if cur is None or _pivot_pref(p) > _pivot_pref(cur):
            slot[side] = p
    out = []
    for (op, nbytes, dtype), slot in sorted(by_key.items()):
        out.append(ComparePoint(op=op, nbytes=nbytes, dtype=dtype,
                                torch=slot.get("torch"),
                                mpi=slot.get("mpi")))
    return out




#: Which library op each ``pl_*`` kernel is judged against (the JAX
#: package's table).  The names do not always align mechanically:
#: ``pl_hbm_copy`` is judged against the ``hbm_stream`` read+write loop,
#: and ``pl_all_gather_bidir`` is a second implementation of
#: ``all_gather``, so two kernels can share one library counterpart.
PALLAS_COUNTERPARTS: dict[str, str] = {
    "pl_ring": "ring",
    "pl_exchange": "exchange",
    "pl_all_gather": "all_gather",
    "pl_all_gather_bidir": "all_gather",
    "pl_reduce_scatter": "reduce_scatter",
    "pl_allreduce": "allreduce",
    "pl_pingpong": "pingpong",
    "pl_hbm_copy": "hbm_stream",
    "pl_hbm_stream": "hbm_stream",
    "pl_hbm_read": "hbm_read",
    "pl_hbm_write": "hbm_write",
    "pl_barrier": "barrier",
    "pl_all_to_all": "all_to_all",
}


@dataclasses.dataclass(frozen=True)
class PallasComparePoint:
    """One (library counterpart op, ``pl_*`` kernel, nbytes) key with the
    library op and its hand-written kernel side by side.  The field and
    column names are the JAX package's (``xla`` the library family,
    ``pallas`` the ``pl_*`` family), so the two packages' tables read
    alike."""

    op: str  # counterpart (library) op name
    nbytes: int
    xla: CurvePoint | None
    pallas: CurvePoint | None
    pallas_op: str | None = None  # the pl_* kernel name; None = one-sided
    dtype: str = "float32"

    @property
    def busbw_ratio(self) -> float | None:
        """pallas/xla p50 bus bandwidth; >1 means the raw kernel is faster."""
        if self.xla is None or self.pallas is None:
            return None
        xla_bw = self.xla.busbw_gbps["p50"]
        return self.pallas.busbw_gbps["p50"] / xla_bw if xla_bw else None


def compare_pallas(points: list[CurvePoint]) -> list[PallasComparePoint]:
    """Pivot torch-backend points into per-(counterpart op, pl kernel, nbytes)
    library-vs-kernel pairs.  Counterparts come from PALLAS_COUNTERPARTS (an
    unlisted pl_* op falls back to prefix-stripping); library ops no pl_*
    row references keep a one-sided row.  Like compare(), n_devices stays out
    of the pivot key — when a side has several device counts at a key, the
    largest (fullest fabric) wins."""
    xla_pts: dict[tuple, CurvePoint] = {}
    pl_pts: dict[tuple, CurvePoint] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.mode == "chaos"
                or p.algo != "native" or p.skew_us or p.imbalance > 1
                or p.load):
            # chaos rows are fault-perturbed, arena rows implement a
            # different wire schedule, and skewed rows entered the
            # collective imbalanced; pooling any against a clean native
            # counterpart manufactures phantom kernel regressions
            continue
        table = pl_pts if p.op.startswith("pl_") else xla_pts
        cur = table.get((p.op, p.nbytes, p.dtype))
        if cur is None or _pivot_pref(p) > _pivot_pref(cur):
            table[(p.op, p.nbytes, p.dtype)] = p
    out = []
    paired_xla: set[tuple] = set()
    for (pl_op, nbytes, dtype), pp in pl_pts.items():
        base = PALLAS_COUNTERPARTS.get(pl_op, pl_op[3:])
        xp = xla_pts.get((base, nbytes, dtype))
        if xp is not None:
            paired_xla.add((base, nbytes, dtype))
        out.append(PallasComparePoint(op=base, nbytes=nbytes, xla=xp,
                                      pallas=pp, pallas_op=pl_op,
                                      dtype=dtype))
    for (op, nbytes, dtype), xp in xla_pts.items():
        if (op, nbytes, dtype) not in paired_xla:
            out.append(PallasComparePoint(op=op, nbytes=nbytes, xla=xp,
                                          pallas=None, dtype=dtype))
    out.sort(key=lambda c: (c.op, c.pallas_op or "", c.nbytes, c.dtype))
    return out


def _fmt(v, spec=".4g"):
    """Render an optional metric cell; one-sided comparisons show a dash."""
    return format(v, spec) if v is not None else "—"


def _op_cell(op: str, algo: str, skew_us: int = 0,
             imbalance: int = 1, load: str = "") -> str:
    """The op column with the arena decomposition, arrival spread,
    payload-imbalance ratio, and background load folded in
    (``allreduce[ring]@500us``, ``allgatherv%8``,
    ``allreduce&hbm_stream``, schema.decorate_op — the one spelling the
    driver's health keys and the fleet rollup share) — no header
    change, so every existing table consumer keeps parsing, while an
    arena, skewed, imbalanced, or loaded row can never masquerade as
    the idle balanced synchronized native lowering."""
    return decorate_op(op, algo, skew_us, imbalance, load)


def _devices_cell(a: CurvePoint | None, b: CurvePoint | None) -> str:
    """``8/2``-style cell naming each side's chosen device count — the
    pivot keeps only the largest-mesh point per side, so the counts a
    ratio actually compares must be visible in the table, not just in
    the pivot docstring."""
    return f"{a.n_devices if a else '—'}/{b.n_devices if b else '—'}"


def _mode_cell(a: CurvePoint | None, b: CurvePoint | None) -> str:
    """Both sides' row modes.  One-shot pairs render quietly; any daemon
    side is spelled out so a daemon-vs-oneshot ratio is visible in the
    table, not hidden behind the pivot's oneshot-preference fallback."""
    am = a.mode if a else "—"
    bm = b.mode if b else "—"
    return "oneshot" if am == bm == "oneshot" else f"{am}/{bm}"


def compare_pallas_to_markdown(cmp: list[PallasComparePoint]) -> str:
    lines = [
        "| op | pallas kernel | size | dtype | xla busbw p50 (GB/s) "
        "| pallas busbw p50 (GB/s) | pallas/xla | xla lat p50 (us) "
        "| pallas lat p50 (us) | devices xla/pl | mode |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = _fmt
    for c in cmp:
        xb = c.xla.busbw_gbps["p50"] if c.xla else None
        pb = c.pallas.busbw_gbps["p50"] if c.pallas else None
        xl = c.xla.lat_us["p50"] if c.xla else None
        pl = c.pallas.lat_us["p50"] if c.pallas else None
        lines.append(
            f"| {c.op} | {c.pallas_op or '—'} | {format_size(c.nbytes)} "
            f"| {c.dtype} | {fmt(xb)} | {fmt(pb)} "
            f"| {fmt(c.busbw_ratio, '.3g')} | {fmt(xl, '.2f')} "
            f"| {fmt(pl, '.2f')} | {_devices_cell(c.xla, c.pallas)} "
            f"| {_mode_cell(c.xla, c.pallas)} |"
        )
    return "\n".join(lines)


def compare_to_markdown(cmp: list[ComparePoint]) -> str:
    lines = [
        "| op | size | dtype | torch busbw p50 (GB/s) | mpi busbw p50 (GB/s) "
        "| torch/mpi bw | torch lat p50 (us) | mpi lat p50 (us) "
        "| mpi/torch lat | devices torch/mpi | mode |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = _fmt
    for c in cmp:
        jb = c.torch.busbw_gbps["p50"] if c.torch else None
        mb = c.mpi.busbw_gbps["p50"] if c.mpi else None
        jl = c.torch.lat_us["p50"] if c.torch else None
        ml = c.mpi.lat_us["p50"] if c.mpi else None
        lines.append(
            f"| {c.op} | {format_size(c.nbytes)} | {c.dtype} "
            f"| {fmt(jb)} | {fmt(mb)} "
            f"| {fmt(c.busbw_ratio, '.3g')} | {fmt(jl, '.2f')} "
            f"| {fmt(ml, '.2f')} | {fmt(c.latency_ratio, '.3g')} "
            f"| {_devices_cell(c.torch, c.mpi)} "
            f"| {_mode_cell(c.torch, c.mpi)} |"
        )
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class InterferencePoint:
    """One cell of the interference matrix: a victim point under one
    background load against its idle twin (same op, size, dtype, algo;
    ``contend`` measures both in one job).  ``slowdown`` is loaded p50
    latency over idle p50 latency.  A cell whose idle twin is missing
    keeps its row with a dash."""

    op: str
    nbytes: int
    dtype: str
    load: str
    algo: str = "native"
    loaded: CurvePoint | None = None
    idle: CurvePoint | None = None

    @property
    def slowdown(self) -> float | None:
        if self.loaded is None or self.idle is None:
            return None
        idle_lat = self.idle.lat_us["p50"]
        return (self.loaded.lat_us["p50"] / idle_lat) if idle_lat else None


def interference_matrix(points: list[CurvePoint]) -> list[InterferencePoint]:
    """Pivot loaded points (``contend``) against their idle twins: one row
    per (op, nbytes, dtype, algo, load) a loaded row measured.  Only this
    package's rows (``torch``, ``torch-sim``) take part, where the JAX
    package's view keeps ``jax``; chaos, skewed and imbalanced rows stay
    out of both sides; when several modes or device counts hold a slot,
    the one-shot largest-world point wins, as in :func:`compare`."""
    loaded_pts: dict[tuple, CurvePoint] = {}
    idle_pts: dict[tuple, CurvePoint] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.mode == "chaos"
                or p.skew_us or p.imbalance > 1):
            continue
        key = (p.op, p.nbytes, p.dtype, p.algo)
        table, slot = ((loaded_pts, key + (p.load,)) if p.load
                       else (idle_pts, key))
        cur = table.get(slot)
        if cur is None or _pivot_pref(p) > _pivot_pref(cur):
            table[slot] = p
    return [
        InterferencePoint(
            op=op, nbytes=nbytes, dtype=dtype, algo=algo, load=load,
            loaded=lp, idle=idle_pts.get((op, nbytes, dtype, algo)),
        )
        for (op, nbytes, dtype, algo, load), lp
        in sorted(loaded_pts.items())
    ]


def interference_to_markdown(cmp: list[InterferencePoint]) -> str:
    """The interference matrix: per (op, size), the slowdown each
    background load induces over the idle baseline."""
    lines = [
        "| op | size | dtype | load | idle lat p50 (us) "
        "| loaded lat p50 (us) | slowdown | loaded busbw p50 (GB/s) "
        "| mode |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cmp:
        lines.append(
            f"| {_op_cell(c.op, c.algo)} | {format_size(c.nbytes)} "
            f"| {c.dtype} | {c.load} "
            f"| {_fmt(c.idle.lat_us['p50'] if c.idle else None, '.2f')} "
            f"| {_fmt(c.loaded.lat_us['p50'] if c.loaded else None, '.2f')} "
            f"| {_fmt(c.slowdown, '.3g')} "
            f"| {_fmt(c.loaded.busbw_gbps['p50'] if c.loaded else None)} "
            f"| {_mode_cell(c.idle, c.loaded)} |"
        )
    return "\n".join(lines)


def to_markdown(points: list[CurvePoint]) -> str:
    lines = [
        "| backend | op | size | dtype | devices | mode | runs "
        "| lat p50 (us) | lat p95 (us) | busbw p50 (GB/s) "
        "| busbw max (GB/s) | TFLOP/s p50 |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for p in points:
        tf = "—" if p.tflops is None else f"{p.tflops['p50']:.4g}"
        lines.append(
            f"| {p.backend} "
            f"| {_op_cell(p.op, p.algo, p.skew_us, p.imbalance, p.load)} "
            f"| {format_size(p.nbytes)} "
            f"| {p.dtype} | {p.n_devices} | {p.mode} | {p.runs} "
            f"| {p.lat_us['p50']:.2f} | {p.lat_us['p95']:.2f} "
            f"| {p.busbw_gbps['p50']:.4g} | {p.busbw_gbps['max']:.4g} "
            f"| {tf} |"
        )
    return "\n".join(lines)


def to_json(points: list[CurvePoint]) -> str:
    """One JSON object per curve point, machine-readable (the same shape
    bench.py's headline line uses, for dashboards downstream of Kusto)."""
    import json

    return json.dumps(
        [
            {
                "backend": p.backend,
                "op": p.op,
                "nbytes": p.nbytes,
                "dtype": p.dtype,
                "n_devices": p.n_devices,
                "mode": p.mode,
                "runs": p.runs,
                "lat_us": p.lat_us,
                "busbw_gbps": p.busbw_gbps,
                "algbw_gbps": p.algbw_gbps,
                **({} if p.tflops is None else {"tflops": p.tflops}),
                **({} if p.algo == "native" else {"algo": p.algo}),
                **({} if not p.skew_us else {"skew_us": p.skew_us}),
                **({} if p.imbalance == 1
                   else {"imbalance": p.imbalance}),
                **({} if not p.load else {"load": p.load}),
            }
            for p in points
        ],
        indent=2,
    )


def points_from_artifact(target: str) -> list[CurvePoint]:
    """Curve points from a ``report --format json`` artifact (*.json) or
    raw rotating-log rows (file / folder / glob)."""
    if os.path.isfile(target) and target.endswith(".json"):
        import json

        with open(target) as fh:
            data = json.load(fh)
        try:
            # to_json emits exactly the CurvePoint fields (dtype optional
            # in pre-dtype artifacts, covered by the dataclass default)
            return [CurvePoint(**d) for d in data]
        except TypeError as e:
            raise ValueError(
                f"{target!r} is not a report --format json artifact: {e}"
            ) from None
    # the streaming reader: identical points, bounded memory (a diff
    # against a week-long soak's raw folder must not buffer it)
    return stream_aggregate(collect_paths(target))


@dataclasses.dataclass(frozen=True)
class DiffPoint:
    """One curve key diffed across two artifacts (base -> new).

    ``metric`` is the judged column: p50 bus bandwidth for bandwidth ops,
    p50 latency for latency-only ops (busbw 0 — barrier/extern rows).
    ``delta_pct`` is signed relative change new-vs-base of that metric."""

    backend: str
    op: str
    nbytes: int
    dtype: str
    n_devices: int
    mode: str
    base: CurvePoint | None
    new: CurvePoint | None
    metric: str  # "busbw p50" | "lat p50"
    delta_pct: float | None  # None for one-sided and incomparable keys
    verdict: str  # ok | regressed | improved | base-only | new-only | incomparable
    algo: str = "native"  # part of the pairing key: an arena artifact
    # diffs per algorithm, never against the native curve
    skew_us: int = 0  # part of the pairing key: a skewed curve diffs
    # against the same spread's baseline, never the synchronized one
    imbalance: int = 1  # part of the pairing key: an imbalanced curve
    # diffs against the same ratio's baseline, never the balanced one
    load: str = ""  # part of the pairing key: a loaded curve diffs
    # against the same background load's baseline, never the idle one


def diff_points(
    base: list[CurvePoint],
    new: list[CurvePoint],
    *,
    threshold_pct: float = 10.0,
) -> list[DiffPoint]:
    """Pair two artifacts' points on the full curve key and judge each
    pair against ``threshold_pct``.  Bandwidth ops regress when busbw p50
    drops by more than the threshold; latency-only ops when lat p50 rises
    by more than it.  Changes within the threshold are ``ok`` (runs wobble
    a few percent); beyond-threshold moves in the good direction are
    ``improved``.

    ``mode`` is part of the pairing key: a daemon artifact diffed against
    a one-shot baseline yields one-sided rows instead of phantom gains."""
    if threshold_pct <= 0:
        raise ValueError(f"threshold_pct must be positive, got {threshold_pct}")

    def key(p: CurvePoint):
        return (p.backend, p.op, p.nbytes, p.dtype, p.n_devices, p.mode,
                p.algo, p.skew_us, p.imbalance, p.load)

    base_by, new_by = {key(p): p for p in base}, {key(p): p for p in new}
    out = []
    for k in sorted(set(base_by) | set(new_by)):
        bp, np_ = base_by.get(k), new_by.get(k)
        some = bp or np_
        # judge the metric the op's bus factor defines, not
        # whichever column a (possibly corrupt) artifact happened to
        # record as 0 — a bandwidth op whose base artifact recorded 0
        # busbw must surface as incomparable, never silently 'ok'.
        # Unknown ops (foreign artifacts) fall back to the recorded value.
        op = k[1]
        if op in KNOWN_OPS:
            latency_only = is_latency_only(op, k[4])
        else:
            latency_only = some.busbw_gbps["p50"] == 0
        metric = "lat p50" if latency_only else "busbw p50"
        if bp is None or np_ is None:
            verdict = "new-only" if bp is None else "base-only"
            delta = None
        else:
            if latency_only:
                b, n = bp.lat_us["p50"], np_.lat_us["p50"]
                worse_sign = 1  # latency rising is the regression
            else:
                b, n = bp.busbw_gbps["p50"], np_.busbw_gbps["p50"]
                worse_sign = -1
            if b <= 0 or n <= 0:
                # a zero judged metric on either side is a broken or
                # partial artifact, not a measurement — no delta exists,
                # and both sides being broken is no better than one
                delta = None
                verdict = "incomparable"
            else:
                delta = (n - b) / b * 100.0
                if delta * worse_sign > threshold_pct:
                    verdict = "regressed"
                elif delta * worse_sign < -threshold_pct:
                    verdict = "improved"
                else:
                    verdict = "ok"
        out.append(DiffPoint(
            backend=k[0], op=k[1], nbytes=k[2], dtype=k[3], n_devices=k[4],
            mode=k[5], base=bp, new=np_, metric=metric, delta_pct=delta,
            verdict=verdict, algo=k[6], skew_us=k[7], imbalance=k[8],
            load=k[9],
        ))
    return out


def diff_to_markdown(diffs: list[DiffPoint]) -> str:
    lines = [
        "| backend | op | size | dtype | devices | mode | metric | base "
        "| new | Δ% | verdict |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in diffs:
        if d.metric == "lat p50":
            bv = d.base.lat_us["p50"] if d.base else None
            nv = d.new.lat_us["p50"] if d.new else None
        else:
            bv = d.base.busbw_gbps["p50"] if d.base else None
            nv = d.new.busbw_gbps["p50"] if d.new else None
        lines.append(
            f"| {d.backend} "
            f"| {_op_cell(d.op, d.algo, d.skew_us, d.imbalance, d.load)} "
            f"| {format_size(d.nbytes)} | {d.dtype} "
            f"| {d.n_devices} | {d.mode} | {d.metric} | {_fmt(bv)} "
            f"| {_fmt(nv)} | {_fmt(d.delta_pct, '+.1f')} | {d.verdict} |"
        )
    return "\n".join(lines)


def to_csv(points: list[CurvePoint]) -> str:
    # the algo/skew columns exist only when arena/skew points do: a
    # pure-native synchronized folder's CSV stays byte-identical to
    # every earlier artifact (the same conditional-growth contract
    # run --csv and to_json keep); a skew column always brings algo
    # with it so the widths stay unambiguous, like the row schema
    arena = any(p.algo != "native" for p in points)
    loaded = any(p.load for p in points)
    imbalanced = any(p.imbalance > 1 for p in points) or loaded
    skewed = any(p.skew_us for p in points) or imbalanced
    lines = [
        "backend,op,nbytes,dtype,n_devices,mode,runs,lat_p50_us,lat_p95_us,"
        "lat_p99_us,busbw_p50_gbps,busbw_max_gbps,algbw_p50_gbps,tflops_p50"
        + (",algo" if arena or skewed else "")
        + (",skew_us" if skewed else "")
        + (",imbalance" if imbalanced else "")
        + (",load" if loaded else "")
    ]
    for p in points:
        tf = "" if p.tflops is None else f"{p.tflops['p50']:.6g}"
        lines.append(
            f"{p.backend},{p.op},{p.nbytes},{p.dtype},{p.n_devices},"
            f"{p.mode},{p.runs},"
            f"{p.lat_us['p50']:.3f},{p.lat_us['p95']:.3f},{p.lat_us['p99']:.3f},"
            f"{p.busbw_gbps['p50']:.6g},{p.busbw_gbps['max']:.6g},"
            f"{p.algbw_gbps['p50']:.6g},{tf}"
            + (f",{p.algo}" if arena or skewed else "")
            + (f",{p.skew_us}" if skewed else "")
            + (f",{p.imbalance}" if imbalanced else "")
            + (f",{p.load}" if loaded else "")
        )
    return "\n".join(lines)

