"""Result aggregation: extended-schema CSV -> per-sweep-point curve tables
(copy of the parts of ``tpu_perf/report.py`` that read what this package
writes).

Feed it rotated ``tpu-*.log`` files (or ``run --csv`` stdout) and get the
(op, nbytes) -> {p50 latency, bus bandwidth} curves, the accelerator-vs-MPI
pivot (``compare``), each ``pl_*`` kernel beside its library op
(``compare_pallas``), a chaos soak's curves beside a clean soak's
(``compare_chaos``), the adaptive savings, the harness phases, and the
diff of two artifacts.  The pivots keep this package's backends,
``torch`` (one rank) and ``torch-sim`` (the sim world), where the JAX
package's keep ``jax``; so does the interference matrix of ``contend``'s
loaded rows against their idle twins.  The arena, hier, straggler,
scenario, imbalance and push views wait for their modules (ROADMAP).
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


@dataclasses.dataclass(frozen=True)
class ChaosComparePoint:
    """One (op, nbytes, dtype) key with a chaos soak's curve and a clean
    soak's curve side by side (the JAX package's): the injected
    degradation in the curve tables, not only in the event stream.
    Ratios read >1 as 'chaos worse': latency chaos/clean, bandwidth
    clean/chaos."""

    op: str
    nbytes: int
    chaos: CurvePoint | None
    clean: CurvePoint | None
    dtype: str = "float32"

    @property
    def latency_ratio(self) -> float | None:
        if self.chaos is None or self.clean is None:
            return None
        clean_lat = self.clean.lat_us["p50"]
        return self.chaos.lat_us["p50"] / clean_lat if clean_lat else None

    @property
    def busbw_ratio(self) -> float | None:
        if self.chaos is None or self.clean is None:
            return None
        chaos_bw = self.chaos.busbw_gbps["p50"]
        return self.clean.busbw_gbps["p50"] / chaos_bw if chaos_bw else None


def _chaos_clean_pref(p: CurvePoint) -> tuple:
    """Which clean point pairs against a chaos soak: a clean daemon soak
    first (it runs as hot as the chaos soak does; a one-shot counterpart
    would manufacture degradation), then the fullest fabric."""
    return (p.mode == "daemon", p.n_devices)


def compare_chaos(points: list[CurvePoint]) -> list[ChaosComparePoint]:
    """Pivot this package's points into per-(op, nbytes, dtype) chaos-
    vs-clean pairs.  Chaos rows are the ``mode == "chaos"`` curves the
    fault-injected driver emits; the clean side prefers a daemon soak of
    the same spec over a one-shot run.  Keys with no chaos row are
    dropped; a chaos key with no clean counterpart keeps a one-sided row
    so a missing control soak is visible."""
    chaos_pts: dict[tuple, CurvePoint] = {}
    clean_pts: dict[tuple, CurvePoint] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.algo != "native"
                or p.skew_us or p.imbalance > 1 or p.load):
            continue
        key = (p.op, p.nbytes, p.dtype)
        if p.mode == "chaos":
            cur = chaos_pts.get(key)
            if cur is None or p.n_devices > cur.n_devices:
                chaos_pts[key] = p
        else:
            cur = clean_pts.get(key)
            if cur is None or _chaos_clean_pref(p) > _chaos_clean_pref(cur):
                clean_pts[key] = p
    return [
        ChaosComparePoint(op=op, nbytes=nbytes, dtype=dtype,
                          chaos=cp, clean=clean_pts.get((op, nbytes, dtype)))
        for (op, nbytes, dtype), cp in sorted(chaos_pts.items())
    ]


def compare_chaos_to_markdown(cmp: list[ChaosComparePoint]) -> str:
    lines = [
        "| op | size | dtype | clean lat p50 (us) | chaos lat p50 (us) "
        "| chaos/clean lat | clean busbw p50 (GB/s) "
        "| chaos busbw p50 (GB/s) | clean/chaos bw | devices clean/chaos "
        "| clean mode |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = _fmt
    for c in cmp:
        cl, ch = c.clean, c.chaos
        lines.append(
            f"| {c.op} | {format_size(c.nbytes)} | {c.dtype} "
            f"| {fmt(cl.lat_us['p50'] if cl else None, '.2f')} "
            f"| {fmt(ch.lat_us['p50'] if ch else None, '.2f')} "
            f"| {fmt(c.latency_ratio, '.3g')} "
            f"| {fmt(cl.busbw_gbps['p50'] if cl else None)} "
            f"| {fmt(ch.busbw_gbps['p50'] if ch else None)} "
            f"| {fmt(c.busbw_ratio, '.3g')} | {_devices_cell(cl, ch)} "
            f"| {cl.mode if cl else '—'} |"
        )
    return "\n".join(lines)




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
class ArenaCrossoverPoint:
    """One (collective, nbytes, dtype) key with every raced
    decomposition's curve side by side — the arena's verdict row.

    ``entries`` maps algorithm name (``native`` included when present)
    to its pivoted curve point.  ``best`` is the fastest algorithm by
    p50 latency (at a fixed (op, nbytes) the latency and bandwidth
    rankings coincide — both derive from the same per-op time — so one
    judged metric suffices); ties break lexicographically so a
    synthetic soak's verdict is deterministic.  ``native_vs_best`` is
    native p50 latency over the best p50 latency: > 1 means a
    hand-built schedule beat the native lowering at this size.

    ``skew_us`` is the arrival-spread coordinate: an arena race under
    ``--skew-spread`` verdicts per (size, spread), because the best
    algorithm CHANGES under imbalanced arrival (arXiv 1804.05349 — the
    whole reason the axis exists); 0 = synchronized entry, the
    pre-skew table unchanged.  ``imbalance`` is the payload-ratio
    coordinate the same way (arXiv 2006.13112: the best decomposition
    changes under uneven per-rank payloads); scenario rows land here
    too — op ``scenario`` with one entry per scenario label.  ``load``
    is the contention coordinate the same way again (arXiv 2305.10612:
    decompositions differ in how they degrade under concurrent
    traffic, so the LOADED winner is its own verdict); "" = idle
    fabric, the pre-contention table unchanged."""

    op: str
    nbytes: int
    dtype: str
    entries: dict[str, CurvePoint]
    skew_us: int = 0
    imbalance: int = 1
    load: str = ""

    @property
    def best(self) -> tuple[str, CurvePoint]:
        return min(sorted(self.entries.items()),
                   key=lambda kv: kv[1].lat_us["p50"])

    @property
    def native_vs_best(self) -> float | None:
        native = self.entries.get("native")
        if native is None:
            return None
        best_lat = self.best[1].lat_us["p50"]
        return native.lat_us["p50"] / best_lat if best_lat else None

    @property
    def margin(self) -> float | None:
        """Best-vs-runner-up p50 ratio (>= 1): the verdict's confidence
        — 1.0 is a coin flip, 1.5 a decisive win.  None for a one-sided
        slot (a single algorithm with no native control raced nothing),
        so a low-confidence verdict is visible in the report table, not
        just inside the tuner's selection artifact."""
        if len(self.entries) < 2:
            return None
        lats = sorted(p.lat_us["p50"] for p in self.entries.values())
        return lats[1] / lats[0] if lats[0] else None

    @property
    def mesh_axes(self) -> tuple[tuple[str, int], ...] | None:
        """The mesh-axis tuple this slot raced on, recovered from any
        keyed hierarchical entry's algo string (the arena registry keys
        hier* per mesh-axis tuple, so the rows are self-describing);
        None for a flat-only slot — native rows carry only n_devices."""
        from tpu_perf_torch.arena.hierarchy import hier_axis_pairs

        for algo in sorted(self.entries):
            pairs = hier_axis_pairs(algo)
            if pairs:
                return pairs
        return None

    @property
    def mesh(self) -> str:
        """The crossover table's mesh-shape cell (``2x(4)`` / ``flat``)."""
        from tpu_perf_torch.arena.hierarchy import mesh_shape_label

        return mesh_shape_label(self.mesh_axes)


def compare_arena(points: list[CurvePoint]) -> list[ArenaCrossoverPoint]:
    """Pivot torch-backend points into the per-size best-algorithm
    crossover table: one row per (op, nbytes, dtype) that any arena
    algorithm measured, every algorithm's curve in its slot, native
    included for the ratio.  Chaos-mode rows are excluded (injected
    degradation must not crown a winner); when one algorithm has
    several device counts / modes at a key, the one-shot largest-mesh
    point wins the slot, exactly like compare().  Keys with no arena
    row are dropped — this view exists for arena experiments; a key
    missing its native row keeps a one-sided row (ratio —) so a
    missing control is visible rather than silently absent."""
    slots: dict[tuple, dict[str, CurvePoint]] = {}
    for p in points:
        if p.backend not in TORCH_BACKENDS or p.mode == "chaos":
            continue
        # skew_us, imbalance, and load are crossover DIMENSIONS, not
        # exclusions: the papers' claim is that the winner changes
        # under arrival skew (1804.05349), payload imbalance
        # (2006.13112), and concurrent load (2305.10612), so each
        # coordinate verdicts separately against its own entries
        op, algo = p.op, p.algo
        if p.op == "scenario":
            # scenario rows race per-phase INNERS, not scenarios
            # against each other (two scenarios are two workloads, not
            # two implementations of one): the slot is the decorated
            # scenario, the entries its inners — a native-only
            # scenario never renders here (scenario_steps owns it)
            from tpu_perf_torch.scenarios.compose import split_scenario_label

            name, inner = split_scenario_label(p.algo)
            op, algo = f"scenario[{name}]", inner
        slot = slots.setdefault(
            (op, p.nbytes, p.dtype, p.skew_us, p.imbalance, p.load), {})
        cur = slot.get(algo)
        if cur is None or _pivot_pref(p) > _pivot_pref(cur):
            slot[algo] = p
    return [
        ArenaCrossoverPoint(op=op, nbytes=nbytes, dtype=dtype,
                            entries=dict(slot), skew_us=skew_us,
                            imbalance=imbalance, load=load)
        for (op, nbytes, dtype, skew_us, imbalance, load), slot
        in sorted(slots.items())
        if any(a != "native" for a in slot)
    ]


def arena_to_markdown(cmp: list[ArenaCrossoverPoint]) -> str:
    """The crossover table: per size (and, under --skew-spread, per
    arrival spread), who won and by how much.  The ``native/best``
    column IS the harness's answer to "where does a hand-built schedule
    beat the native lowering on this chip" — > 1 above the crossover,
    1.00 (native wins) below it.  The spread column appears only when
    any skewed verdict exists, so every pre-skew table stays
    byte-identical; with it, "under 500 µs stagger switch from ring to
    binomial at ≤ 1 MiB" is one row's verdict.

    The mesh column appears only when any slot raced a hierarchical
    (mesh-keyed) algorithm, so every flat-arena table stays
    byte-identical too; with it, "on 2x(4), hier beats flat above
    256 KiB" is one row's verdict with the mesh shape it holds on."""
    skewed = any(c.skew_us for c in cmp)
    meshed = any(c.mesh_axes for c in cmp)
    imbalanced = any(c.imbalance > 1 for c in cmp)
    # the contention column appears only when any loaded verdict exists
    # (tpu-perf-torch contend --algo), so every idle-arena table stays
    # byte-identical; with it, "idle the ring wins but under hbm_stream
    # load native holds" is two rows' verdicts side by side
    loaded = any(c.load for c in cmp)
    head = "| op | size | dtype |"
    sep = "|---|---|---|"
    if meshed:
        head += " mesh |"
        sep += "---|"
    if skewed:
        head += " spread (us) |"
        sep += "---|"
    if imbalanced:
        head += " imbalance |"
        sep += "---|"
    if loaded:
        head += " load |"
        sep += "---|"
    head += (" algorithms | best | best lat p50 (us) "
             "| best busbw p50 (GB/s) | native lat p50 (us) "
             "| native/best | margin | verdict |")
    sep += "---|---|---|---|---|---|---|---|"
    lines = [head, sep]
    fmt = _fmt
    for c in cmp:
        algo, point = c.best
        native = c.entries.get("native")
        verdict = ("native holds" if algo == "native"
                   else f"{algo} wins")
        cells = f"| {c.op} | {format_size(c.nbytes)} | {c.dtype} "
        if meshed:
            cells += f"| {c.mesh} "
        if skewed:
            cells += f"| {c.skew_us} "
        if imbalanced:
            cells += f"| {c.imbalance} "
        if loaded:
            cells += f"| {c.load or 'idle'} "
        lines.append(
            cells
            + f"| {','.join(sorted(c.entries))} | {algo} "
            f"| {point.lat_us['p50']:.2f} "
            f"| {fmt(point.busbw_gbps['p50'])} "
            f"| {fmt(native.lat_us['p50'] if native else None, '.2f')} "
            f"| {fmt(c.native_vs_best, '.3g')} "
            f"| {fmt(c.margin, '.3g')} | {verdict} |"
        )
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class HierTrafficPoint:
    """One hierarchical curve point priced against the bytes-per-axis
    model (tpu_perf_torch.arena.hierarchy): the DCN-traffic bound of the
    composition next to the measured time, with the flat lowering's
    bound and measured time alongside — the table that answers whether
    the measured win tracks the modeled DCN reduction."""

    op: str
    nbytes: int
    dtype: str
    algo: str                 # the keyed hier algorithm
    mesh_axes: tuple[tuple[str, int], ...]
    hier: CurvePoint
    native: CurvePoint | None
    dcn_bytes_hier: float     # the composition's DCN bound (model)
    dcn_bytes_flat: float     # the flat schedule's DCN exposure (model)

    @property
    def dcn_reduction(self) -> float | None:
        """flat/hier modeled DCN bytes (> 1 = the hierarchy keeps that
        factor off the slow hop)."""
        if self.dcn_bytes_hier <= 0:
            return None
        return self.dcn_bytes_flat / self.dcn_bytes_hier

    @property
    def native_vs_hier(self) -> float | None:
        """Measured native/hier p50 latency (> 1 = hier faster)."""
        if self.native is None:
            return None
        hier_lat = self.hier.lat_us["p50"]
        return self.native.lat_us["p50"] / hier_lat if hier_lat else None


def hier_traffic(points: list[CurvePoint]) -> list[HierTrafficPoint]:
    """Pivot torch-backend points into the per-(op, size, hier-algorithm)
    DCN-model table: every hierarchical curve point next to the same
    key's native curve and both sides' modeled DCN bytes.  Chaos and
    skewed rows are excluded (the model prices synchronized clean
    entry); pivot preferences match compare_arena's.

    The native control must match the hier point's DEVICE COUNT — the
    keyed algo proves the hier side's mesh, and ratioing it against a
    native curve from a different-sized fabric would compare two
    machines while claiming one.  One residual ambiguity the row
    schema cannot resolve: native rows carry no mesh shape, so a
    folder mixing a flat-N and an NxM native sweep at the SAME device
    count pairs whichever point the oneshot/largest-mesh preference
    keeps — keep per-job folders when that distinction matters."""
    from tpu_perf_torch.arena.hierarchy import (
        dcn_bound_bytes, flat_dcn_bytes, hier_axis_pairs,
    )

    hier_pts: dict[tuple, CurvePoint] = {}
    native_pts: dict[tuple, CurvePoint] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.mode == "chaos" or p.skew_us
                or p.imbalance > 1 or p.load):
            continue
        if p.algo == "native":
            key = (p.op, p.nbytes, p.dtype, p.n_devices)
            cur = native_pts.get(key)
            if cur is None or _pivot_pref(p) > _pivot_pref(cur):
                native_pts[key] = p
        elif hier_axis_pairs(p.algo):
            key = (p.op, p.nbytes, p.dtype, p.algo)
            cur = hier_pts.get(key)
            if cur is None or _pivot_pref(p) > _pivot_pref(cur):
                hier_pts[key] = p
    out = []
    for (op, nbytes, dtype, algo), hp in sorted(hier_pts.items()):
        pairs = hier_axis_pairs(algo)
        n = hp.n_devices
        out.append(HierTrafficPoint(
            op=op, nbytes=nbytes, dtype=dtype, algo=algo,
            mesh_axes=pairs, hier=hp,
            native=native_pts.get((op, nbytes, dtype, n)),
            dcn_bytes_hier=dcn_bound_bytes(op, nbytes, pairs),
            dcn_bytes_flat=flat_dcn_bytes(op, nbytes, n),
        ))
    return out


def hier_traffic_to_markdown(cmp: list[HierTrafficPoint]) -> str:
    """The bytes-per-axis verdict table: modeled DCN bound (hier vs
    flat) next to measured p50 time.  The model columns are per-device
    payload volume crossing the slow axis — payload/n_slice for the
    composition vs payload*(n-1)/n for the flat schedule — so the
    ``dcn x`` factor is the headroom the slow hop hands back and
    ``native/hier`` is how much of it this fabric's speed ratio
    actually realizes at this size."""
    lines = [
        "| op | size | dtype | mesh | algo | dcn B/dev (hier) "
        "| dcn B/dev (flat) | dcn x | hier lat p50 (us) "
        "| native lat p50 (us) | native/hier |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    from tpu_perf_torch.arena.hierarchy import mesh_shape_label

    fmt = _fmt
    for c in cmp:
        lines.append(
            f"| {c.op} | {format_size(c.nbytes)} | {c.dtype} "
            f"| {mesh_shape_label(c.mesh_axes)} | {c.algo} "
            f"| {c.dcn_bytes_hier:.4g} | {c.dcn_bytes_flat:.4g} "
            f"| {fmt(c.dcn_reduction, '.3g')} "
            f"| {c.hier.lat_us['p50']:.2f} "
            f"| {fmt(c.native.lat_us['p50'] if c.native else None, '.2f')} "
            f"| {fmt(c.native_vs_hier, '.3g')} |"
        )
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class StragglerCostPoint:
    """One skewed curve point paired against its synchronized-entry
    baseline — the straggler-cost verdict row: "what does a 1 ms
    straggler cost an allreduce at 256 MiB on this mesh?" is
    ``slowdown`` at (op=allreduce, size=256M, spread=1000).

    ``slowdown`` is skewed p50 latency over zero-skew p50 latency
    (> 1 = the straggler costs that factor); None when the sweep
    measured no spread-0 baseline for the key."""

    op: str
    nbytes: int
    dtype: str
    skew_us: int
    skewed: CurvePoint
    base: CurvePoint | None
    algo: str = "native"

    @property
    def slowdown(self) -> float | None:
        if self.base is None:
            return None
        base_lat = self.base.lat_us["p50"]
        return self.skewed.lat_us["p50"] / base_lat if base_lat else None


def straggler_cost(points: list[CurvePoint]) -> list[StragglerCostPoint]:
    """Pivot torch-backend points into the per-(op, size, spread)
    straggler-cost table: every skewed curve point paired with the same
    key's spread-0 baseline.  Chaos-mode rows are excluded (a
    fault-perturbed sample must not masquerade as arrival cost); the
    algorithm is part of the key, so an arena skew sweep reports each
    decomposition's straggler sensitivity separately.  Keys with no
    skewed row are dropped (this view exists for skew sweeps); a
    skewed key with no spread-0 counterpart keeps a one-sided row so a
    missing baseline is visible rather than silently absent."""
    skewed: dict[tuple, CurvePoint] = {}
    base: dict[tuple, CurvePoint] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.mode == "chaos" or p.imbalance > 1
                or p.load):
            continue
        key = (p.op, p.nbytes, p.dtype, p.algo)
        table = skewed if p.skew_us else base
        k = key + ((p.skew_us,) if p.skew_us else ())
        cur = table.get(k)
        if cur is None or _pivot_pref(p) > _pivot_pref(cur):
            table[k] = p
    return [
        StragglerCostPoint(
            op=op, nbytes=nbytes, dtype=dtype, skew_us=skew_us,
            skewed=sp, base=base.get((op, nbytes, dtype, algo)),
            algo=algo,
        )
        for (op, nbytes, dtype, algo, skew_us), sp in sorted(skewed.items())
    ]


def straggler_to_markdown(cmp: list[StragglerCostPoint]) -> str:
    """The straggler-cost table: per (op, size), the slowdown factor at
    each measured arrival spread vs synchronized entry.  Slowdowns
    shrink as sizes grow (a fixed stagger amortizes over a longer
    transfer) — the crossover from latency-dominated to
    bandwidth-dominated skew cost is the table's shape."""
    lines = [
        "| op | size | dtype | spread (us) | sync lat p50 (us) "
        "| skewed lat p50 (us) | slowdown | skewed busbw p50 (GB/s) "
        "| mode |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = _fmt
    for c in cmp:
        lines.append(
            f"| {_op_cell(c.op, c.algo)} | {format_size(c.nbytes)} "
            f"| {c.dtype} | {c.skew_us} "
            f"| {fmt(c.base.lat_us['p50'] if c.base else None, '.2f')} "
            f"| {c.skewed.lat_us['p50']:.2f} "
            f"| {fmt(c.slowdown, '.3g')} "
            f"| {fmt(c.skewed.busbw_gbps['p50'])} "
            f"| {_mode_cell(c.base, c.skewed)} |"
        )
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ScenarioStepPoint:
    """One model-step scenario point (tpu_perf_torch.scenarios): its measured
    step-time distribution, the balanced-equivalent baseline when the
    point swept imbalance, and the modeled per-phase attribution.

    ``phases`` is the composition layer's wire model resolved from the
    BUILT-IN catalog (a custom JSON scenario's rows cannot recover the
    foreign spec, so its attribution cell renders a dash); ``cost`` is
    skewed-vs-balanced p50 step time (> 1 = the imbalance costs that
    factor) — the v-variant cost-vs-balanced-equivalent verdict."""

    name: str
    inner: str                # per-phase arena inner ("native" = none)
    nbytes: int
    dtype: str
    imbalance: int
    point: CurvePoint
    base: CurvePoint | None   # the imbalance-1 twin (None when absent
    #                           or when this IS the balanced point)
    phases: list[dict] | None

    @property
    def cost(self) -> float | None:
        if self.base is None or self.imbalance == 1:
            return None
        base_lat = self.base.lat_us["p50"]
        return self.point.lat_us["p50"] / base_lat if base_lat else None


def scenario_steps(points: list[CurvePoint]) -> list[ScenarioStepPoint]:
    """Pivot scenario rows (op == "scenario") into the per-(scenario,
    size, imbalance) step table.  Chaos-mode rows are excluded
    (perturbed samples must not price a model step); skewed rows keep
    their own coordinate out of this table (straggler_cost owns the
    skew view).  Imbalanced points pair against the same label's
    ratio-1 twin for the cost-vs-balanced column."""
    from tpu_perf_torch.scenarios.compose import phase_plan, split_scenario_label
    from tpu_perf_torch.scenarios.spec import BUILTIN_SCENARIOS
    from tpu_perf_torch.metrics import DTYPE_ITEMSIZE

    slots: dict[tuple, CurvePoint] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.op != "scenario"
                or p.mode == "chaos" or p.skew_us or p.load):
            continue
        key = (p.algo, p.nbytes, p.dtype, p.imbalance)
        cur = slots.get(key)
        if cur is None or _pivot_pref(p) > _pivot_pref(cur):
            slots[key] = p
    out = []
    for (label, nbytes, dtype, imbalance), p in sorted(slots.items()):
        name, inner = split_scenario_label(label)
        spec = BUILTIN_SCENARIOS.get(name)
        phases = None
        if spec is not None:
            try:
                phases = phase_plan(
                    spec, nbytes, p.n_devices,
                    itemsize=DTYPE_ITEMSIZE.get(dtype, 4),
                    imbalance=imbalance)
            except ValueError:
                phases = None  # foreign geometry: render without shares
        base = None
        if imbalance > 1:
            # the balanced twin's nbytes differs by rounding (the
            # quantum follows the ratio), so pair on the label alone
            # at the nearest balanced size
            twins = [q for (lbl, _, dt, imb), q in slots.items()
                     if lbl == label and dt == dtype and imb == 1]
            if twins:
                base = min(twins, key=lambda q: abs(q.nbytes - nbytes))
        out.append(ScenarioStepPoint(
            name=name, inner=inner, nbytes=nbytes, dtype=dtype,
            imbalance=imbalance, point=p, base=base, phases=phases,
        ))
    return out


def _phases_cell(phases: list[dict] | None) -> str:
    """The attribution cell: each phase's modeled share of the step's
    wire volume (``allreduce x4 100%``; a dash for foreign specs)."""
    if not phases:
        return "—"
    return " + ".join(f"{e['phase']} {e['share']:.0%}" for e in phases)


def scenario_to_markdown(cmp: list[ScenarioStepPoint]) -> str:
    """The "Scenario steps" table: per-scenario p50/p95 step time with
    modeled per-phase attribution and the cost-vs-balanced-equivalent
    ratio for imbalance-swept points."""
    lines = [
        "| scenario | inner | size | dtype | imbalance | runs "
        "| step p50 (us) | step p95 (us) | vs balanced | mode "
        "| phase attribution (modeled wire share) |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = _fmt
    for c in cmp:
        lines.append(
            f"| {c.name} | {c.inner} | {format_size(c.nbytes)} "
            f"| {c.dtype} | {c.imbalance} | {c.point.runs} "
            f"| {c.point.lat_us['p50']:.2f} | {c.point.lat_us['p95']:.2f} "
            f"| {fmt(c.cost, '.3g')} | {c.point.mode} "
            f"| {_phases_cell(c.phases)} |"
        )
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ImbalanceCostPoint:
    """One imbalanced v-variant curve point paired against its balanced
    (ratio-1) twin — "what does a ratio-8 hot rank cost an allgatherv
    at 4 MiB on this mesh?" is ``cost`` at (op=allgatherv, size≈4M,
    imbalance=8).  The twin is the nearest-size ratio-1 point of the
    same (op, dtype, algo): sizes differ slightly by count rounding."""

    op: str
    nbytes: int
    dtype: str
    imbalance: int
    imbalanced: CurvePoint
    base: CurvePoint | None
    algo: str = "native"
    # arena annotations, filled only when several algos raced the same
    # (op, dtype, size, ratio) coordinate: the coordinate's fastest algo
    # by imbalanced p50, its speedup over the native row, and how many
    # algos competed (1 = no race — the markdown renders dashes and the
    # extra columns disappear entirely for pre-arena artifacts)
    best_algo: str = ""
    best_vs_native: float | None = None
    raced: int = 1

    @property
    def cost(self) -> float | None:
        if self.base is None:
            return None
        base_lat = self.base.lat_us["p50"]
        return self.imbalanced.lat_us["p50"] / base_lat if base_lat \
            else None


def imbalance_cost(points: list[CurvePoint]) -> list[ImbalanceCostPoint]:
    """Pivot torch-backend v-variant points into the per-(op, size,
    ratio) imbalance-cost table: every imbalance > 1 curve point
    (scenario rows excluded — scenario_steps owns them) paired with
    the same key's balanced twin.  Chaos and skewed rows are excluded;
    a ratio with no balanced counterpart keeps a one-sided row so a
    missing baseline is visible rather than silently absent."""
    imb: dict[tuple, CurvePoint] = {}
    base: dict[tuple, list[CurvePoint]] = {}
    for p in points:
        if (p.backend not in TORCH_BACKENDS or p.mode == "chaos" or p.skew_us
                or p.op == "scenario" or p.load):
            continue
        if p.imbalance > 1:
            key = (p.op, p.dtype, p.algo, p.nbytes, p.imbalance)
            cur = imb.get(key)
            if cur is None or _pivot_pref(p) > _pivot_pref(cur):
                imb[key] = p
        else:
            base.setdefault((p.op, p.dtype, p.algo), []).append(p)
    out = []
    for (op, dtype, algo, nbytes, ratio), p in sorted(imb.items()):
        twins = base.get((op, dtype, algo), [])
        twin = min(twins, key=lambda q: abs(q.nbytes - nbytes)) \
            if twins else None
        out.append(ImbalanceCostPoint(
            op=op, nbytes=nbytes, dtype=dtype, imbalance=ratio,
            imbalanced=p, base=twin, algo=algo,
        ))
    # annotate algo races: v_counts sizes buffers from (op, ratio, n)
    # alone, so every algo of one coordinate lands on the same nbytes
    # and the group key needs no size fuzzing
    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(out):
        groups.setdefault((c.op, c.dtype, c.nbytes, c.imbalance), []).append(i)
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        best = min(idxs, key=lambda i: (out[i].imbalanced.lat_us["p50"],
                                        out[i].algo))
        native_lat = next(
            (out[i].imbalanced.lat_us["p50"] for i in idxs
             if out[i].algo == "native"), None)
        ratio = (out[best].imbalanced.lat_us["p50"] / native_lat) \
            if native_lat else None
        for i in idxs:
            out[i] = dataclasses.replace(
                out[i], best_algo=out[best].algo,
                best_vs_native=ratio, raced=len(idxs))
    return out


def imbalance_to_markdown(cmp: list[ImbalanceCostPoint]) -> str:
    """The imbalance-cost table: per (op, size), the slowdown factor at
    each measured payload ratio vs the balanced equivalent (same
    aggregate volume, even per-rank split).  The hot rank serializes
    the schedule's longest chain, so costs grow with ratio and shrink
    with size as bandwidth terms dominate — the shape is the verdict.

    When the arena raced several algos at an imbalanced coordinate, two
    extra columns appear: the coordinate's fastest algo and its p50
    speedup over native (< 1 means the optimized schedule wins).  Rows
    where only one algo raced show dashes; artifacts with no races at
    all render the legacy 9-column table byte-identically."""
    raced_any = any(c.raced > 1 for c in cmp)
    lines = [
        "| op | size | dtype | imbalance | balanced lat p50 (us) "
        "| imbalanced lat p50 (us) | cost | imbalanced busbw p50 (GB/s) "
        "| mode |" if not raced_any else
        "| op | size | dtype | imbalance | balanced lat p50 (us) "
        "| imbalanced lat p50 (us) | cost | imbalanced busbw p50 (GB/s) "
        "| mode | best algo | best/naive |",
        "|---|---|---|---|---|---|---|---|---|" if not raced_any else
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = _fmt
    for c in cmp:
        row = (
            f"| {_op_cell(c.op, c.algo)} | {format_size(c.nbytes)} "
            f"| {c.dtype} | {c.imbalance} "
            f"| {fmt(c.base.lat_us['p50'] if c.base else None, '.2f')} "
            f"| {c.imbalanced.lat_us['p50']:.2f} "
            f"| {fmt(c.cost, '.3g')} "
            f"| {fmt(c.imbalanced.busbw_gbps['p50'])} "
            f"| {_mode_cell(c.base, c.imbalanced)} |"
        )
        if raced_any:
            row += (
                f" {c.best_algo or '—'} "
                f"| {fmt(c.best_vs_native, '.3g')} |"
                if c.raced > 1 else " — | — |"
            )
        lines.append(row)
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


# --- the harness phases and the adaptive savings (the JAX package's
# report.py:1574-1755) ---


def read_phases(target: str) -> list[dict]:
    """The ``phase-<job>-<rank>.json`` sidecars the Driver writes beside
    the rotating logs (``driver.Driver._write_phases``): one a (job,
    rank), each with the run's compile / measure / log totals and wall
    clock.  A folder is scanned; a file target looks beside it; a glob
    finds none.  A torn or foreign JSON file is skipped: the phase table
    never blocks the curve tables."""
    import json

    if os.path.isdir(target):
        folder = target
    elif os.path.isfile(target):
        folder = os.path.dirname(os.path.abspath(target))
    else:
        return []
    out = []
    for path in sorted(glob.glob(os.path.join(folder, "phase-*.json"))):
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(data, dict) and isinstance(data.get("phase"), dict):
            out.append(data)
    return out


@dataclasses.dataclass(frozen=True)
class AdaptiveSavingsPoint:
    """One adaptively sampled point's budget verdict, rebuilt from its rows
    alone: the runs_requested / runs_taken / ci_rel columns stream a run
    at a time, so the point's last row (its largest run_id) carries the
    controller's stop state.  Dropped runs write no row, so trailing
    dropped runs read low here; the sidecar's totals are exact."""

    job_id: str
    backend: str
    op: str
    nbytes: int
    dtype: str
    runs_requested: int
    runs_attempted: int   # final row's run_id: budget consumed
    runs_taken: int       # recorded samples
    ci_rel: float         # achieved relative CI half-width at stop
    wall_saved_s: float   # (requested - attempted) x mean run time


def adaptive_savings(rows: list[ResultRow]) -> list[AdaptiveSavingsPoint]:
    """Group adaptive rows (runs_requested > 0) a point and read each
    point's last row; fixed-budget rows (runs_requested 0) are left out.
    The job is part of the key: two jobs in one folder give two
    verdicts a point."""
    groups: dict[tuple, list[ResultRow]] = {}
    for row in rows:
        if row.runs_requested <= 0:
            continue
        groups.setdefault(
            (row.job_id, row.backend, row.op, row.nbytes, row.dtype), []
        ).append(row)
    out = []
    for (job_id, backend, op, nbytes, dtype), grp in sorted(groups.items()):
        final = max(grp, key=lambda r: r.run_id)
        saved = max(0, final.runs_requested - final.run_id)
        mean_s = sum(r.time_ms for r in grp) / len(grp) / 1e3
        out.append(AdaptiveSavingsPoint(
            job_id=job_id, backend=backend, op=op, nbytes=nbytes,
            dtype=dtype,
            runs_requested=final.runs_requested,
            runs_attempted=final.run_id,
            runs_taken=final.runs_taken,
            ci_rel=final.ci_rel,
            wall_saved_s=saved * mean_s,
        ))
    return out


def _fold_adaptive(state: dict, row: ResultRow) -> None:
    """Fold one streamed row into the per-point adaptive state: the last
    row so far, the sample count and the time sum (memory a point, never
    a row)."""
    if row.runs_requested <= 0:
        return
    key = (row.job_id, row.backend, row.op, row.nbytes, row.dtype)
    st = state.get(key)
    if st is None:
        state[key] = [row, 1, row.time_ms]
        return
    if row.run_id > st[0].run_id:
        st[0] = row
    st[1] += 1
    st[2] += row.time_ms


def _adaptive_points(state: dict) -> list[AdaptiveSavingsPoint]:
    out = []
    for (job_id, backend, op, nbytes, dtype), (final, n, time_sum) in \
            sorted(state.items()):
        saved = max(0, final.runs_requested - final.run_id)
        out.append(AdaptiveSavingsPoint(
            job_id=job_id, backend=backend, op=op, nbytes=nbytes,
            dtype=dtype,
            runs_requested=final.runs_requested,
            runs_attempted=final.run_id,
            runs_taken=final.runs_taken,
            ci_rel=final.ci_rel,
            wall_saved_s=saved * (time_sum / n / 1e3),
        ))
    return out


def stream_report(paths: Iterable[str], *, err=None):
    """One streaming pass folding both report states, the curve points and
    the adaptive-savings verdicts: ``(points, savings)``, each what its
    own reader gives."""
    groups: dict[tuple, dict] = {}
    state: dict[tuple, list] = {}
    for r in stream_rows(paths, err=err):
        _fold_curve(groups, r)
        _fold_adaptive(state, r)
    return _curve_points(groups), _adaptive_points(state)


def adaptive_to_markdown(points: list[AdaptiveSavingsPoint]) -> str:
    """The "Adaptive savings" table: what the early stop handed back a
    point, with a totals row."""
    lines = [
        "| job | backend | op | size | dtype | runs requested "
        "| runs attempted | runs saved | CI achieved | wall saved (s) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    tot_req = tot_att = 0
    tot_wall = 0.0
    for p in points:
        saved = p.runs_requested - p.runs_attempted
        tot_req += p.runs_requested
        tot_att += p.runs_attempted
        tot_wall += p.wall_saved_s
        lines.append(
            f"| {p.job_id[:8]} | {p.backend} | {p.op} "
            f"| {format_size(p.nbytes)} "
            f"| {p.dtype} | {p.runs_requested} | {p.runs_attempted} "
            f"| {saved} | {p.ci_rel:.2%} | {p.wall_saved_s:.3f} |"
        )
    pct = (f"{(tot_req - tot_att) / tot_req:.0%}" if tot_req else "—")
    lines.append(
        f"| **total** | | | | | {tot_req} | {tot_att} "
        f"| {tot_req - tot_att} ({pct}) | | {tot_wall:.3f} |"
    )
    return "\n".join(lines)


def phases_to_markdown(entries: list[dict]) -> str:
    """The phase sidecars as the report's harness-overhead table.

    ``compile/wall`` is compile work over wall clock: under
    ``--precompile`` the worker's builds overlap measurement, so the
    ratio can exceed what a serial run shows, and that excess is the
    overlap won.  A fused job's sidecar carries its dispatch audit: the
    ``dispatches`` column reads measured dispatches over points (1/1 a
    point on a fixed budget, more under ``--ci-rel``'s chunks)."""
    fused = any(isinstance(e.get("fused"), dict) for e in entries)
    head = ("| job | rank | precompile | wall (s) | compile (s) "
            "| measure (s) | log (s) | compile/wall |")
    sep = "|---|---|---|---|---|---|---|---|"
    if fused:
        head += " dispatches |"
        sep += "---|"
    lines = [head, sep]
    for e in entries:
        ph = e.get("phase", {})
        wall = e.get("wall_s") or 0.0
        compile_s = ph.get("compile_s", 0.0)
        ratio = f"{compile_s / wall:.0%}" if wall else "—"
        line = (
            f"| {str(e.get('job_id', ''))[:8]} | {e.get('rank', 0)} "
            f"| {e.get('precompile', 0)} | {wall:.3f} "
            f"| {compile_s:.3f} | {ph.get('measure_s', 0.0):.3f} "
            f"| {ph.get('log_s', 0.0):.3f} | {ratio} |"
        )
        if fused:
            fu = e.get("fused")
            cell = (f"{fu['measure_dispatches']}/{fu['points']}"
                    if isinstance(fu, dict) else "—")
            line += f" {cell} |"
        lines.append(line)
    return "\n".join(lines)


def push_to_markdown(entries: list[dict]) -> str:
    """Render the phase sidecars' push-plane counters as the report's
    "Push plane" table (entries without a ``push`` block — push-off
    jobs — are skipped by the caller).  The one-line read: sent is the
    live deliveries, dropped/spooled is every record that did NOT go
    live (dropped = lost to the bounded queue, counted; spooled = on
    disk awaiting requeue+replay), and a non-zero spool depth means
    undelivered telemetry is sitting next to the logs right now."""
    lines = [
        "| job | rank | sent | dropped | retried | spooled | replayed "
        "| spool depth |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for e in entries:
        p = e.get("push")
        if not isinstance(p, dict):
            continue
        lines.append(
            f"| {str(e.get('job_id', ''))[:8]} | {e.get('rank', 0)} "
            f"| {p.get('sent', 0)} | {p.get('dropped', 0)} "
            f"| {p.get('retried', 0)} | {p.get('spooled', 0)} "
            f"| {p.get('replayed', 0)} | {p.get('spool_depth', 0)} |"
        )
    return "\n".join(lines)
