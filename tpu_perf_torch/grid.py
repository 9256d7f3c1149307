"""Operating-point grid (port of ``tpu_perf/grid.py``).

A size x iters grid of one or more ops, each cell judged against the
card's physical ceiling and a plateau floor, and the most stable ``ok``
cell of each op marked as its operating point.  Two families, one
discipline: **bandwidth** cells are judged on bus bandwidth (GB/s,
``--spec-gbps`` / ``--floor-gbps``, ``--spec hbm``), **compute** cells on
TFLOP/s from each row's latency and the op's FLOP model
(``metrics.FLOPS_PER_ITER``: mxu_gemm 2m^3 an iteration;
``--spec-tflops`` / ``--floor-tflops``, ``--spec mxu``).  The rules are
the JAX package's:

* ``unphysical`` — p50 or p75 of the cell's metric exceeds the spec
  ceiling: timing jitter, or a cache standing in for device memory (an
  H100's 50 MB L2 holds a chained small buffer; take ``--spec hbm`` grids
  at 256 MiB and above);
* ``degraded``  — p50 below the floor: with ``--spec hbm`` the card's
  stream floor (the ``hbm_stream`` / ``hbm_triad`` plateaus', applied to
  every op as JAX's grid applies it: ``hbm_read``, a reduction, reads
  under it on a healthy card), with ``--spec mxu`` its mxu floor for the
  dtype, each measured on the H100 SXM (derived for the other cards) in
  :mod:`tpu_perf_torch.chips`; with a floor of ``None`` no cell is judged
  degraded;
* ``ok``        — everything else; the ok cell with the narrowest
  relative interquartile range, among those within
  ``_CHOSEN_P50_FRACTION`` of the op's best p50, is chosen.

Cells run on a :class:`~tpu_perf_torch.world.SimWorld` instead of a mesh.
"""

from __future__ import annotations

import dataclasses

from tpu_perf_torch.config import Options, new_job_id
from tpu_perf_torch.metrics import (
    DTYPE_ITEMSIZE, FLOPS_PER_ITER, is_latency_only, percentile,
)
from tpu_perf_torch.runner import run_point
from tpu_perf_torch.sweep import format_size
from tpu_perf_torch.timing import SLOPE_ITERS_FACTOR
from tpu_perf_torch.world import SimWorld


def judge(p50: float, spec: float | None, floor: float | None, *,
          p75: float | None = None) -> str:
    """The per-cell verdict; pure so the rules are unit-testable."""
    if spec is not None and p50 > spec:
        return "unphysical"
    if spec is not None and p75 is not None and p75 > spec:
        return "unphysical"  # jitter-widened: a quarter of samples > spec
    if floor is not None and p50 < floor:
        return "degraded"
    return "ok"


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One (size, iters) operating point with its verdict; ``p25``..
    ``vmax`` are in the judged metric's ``unit``: busbw in GB/s, or
    TFLOP/s for compute grids."""

    op: str
    nbytes: int
    dtype: str
    iters: int
    n_devices: int
    runs: int  # valid samples measured
    drops: int  # requested - valid (degenerate slope samples)
    p25: float
    p50: float
    p75: float
    vmax: float
    lat_p50_us: float
    verdict: str
    unit: str = "GB/s"
    note: str = ""
    chosen: bool = False


def _check_ops(ops: list[str], compute: bool) -> None:
    from tpu_perf_torch.ops.collectives import known_ops
    from tpu_perf_torch.scenarios.vops import V_OPS

    if not ops:
        raise ValueError("grid needs at least one op")
    # the v-ops are no grid instruments, as in the JAX package: their
    # cells would need an imbalance coordinate the grid does not sweep
    known = [o for o in known_ops() if o not in V_OPS]
    unknown = [o for o in ops if o not in known]
    if unknown:
        raise ValueError(f"unknown op(s) {unknown}; known: {known}")
    if compute:
        # mixing compute and bandwidth instruments would judge half the
        # cells on a meaningless axis
        no_model = [o for o in ops if o not in FLOPS_PER_ITER]
        if no_model:
            raise ValueError(
                f"op(s) {no_model} have no FLOP model; compute grids "
                f"support: {sorted(FLOPS_PER_ITER)}")
        return
    latency_only = [o for o in ops if is_latency_only(o)]
    if latency_only:
        raise ValueError(
            f"grid judges bus bandwidth; latency-only op(s) {latency_only} "
            "have no bandwidth operating point (use run for them)")


def run_grid(
    world: SimWorld,
    ops: str | list[str],
    sizes: list[int],
    iters_list: list[int],
    *,
    dtype: str = "float32",
    runs: int = 8,
    fence: str = "slope",
    spec_gbps: float | None = None,
    floor_gbps: float | None = None,
    spec_tflops: float | None = None,
    floor_tflops: float | None = None,
    on_cell=None,
    on_rows=None,
    job_id: str | None = None,
) -> list[GridCell]:
    """Measure every (op, size, iters) cell on ``world`` and judge it; each
    op gets its own chosen operating point.  ``spec_tflops`` /
    ``floor_tflops`` switch the judged metric to TFLOP/s; every op must
    then have a FLOP model, and the bandwidth limits must not be given.

    A cell whose measurement raises is recorded as verdict ``failed`` with
    the error in the note: one broken operating point must not lose the
    grid.  ``on_cell`` (cell -> None) streams progress; ``on_rows``
    (list[ResultRow] -> None) receives every cell's raw rows, stamped with
    ``job_id`` (one is made per grid when not given)."""
    if isinstance(ops, str):
        ops = [s.strip() for s in ops.split(",") if s.strip()]
    compute = spec_tflops is not None or floor_tflops is not None
    if compute and (spec_gbps is not None or floor_gbps is not None):
        raise ValueError(
            "grid judges ONE metric: give either --spec-gbps/--floor-gbps "
            "(bandwidth) or --spec-tflops/--floor-tflops (compute), not both")
    spec, floor, unit = ((spec_tflops, floor_tflops, "TFLOP/s") if compute
                         else (spec_gbps, floor_gbps, "GB/s"))
    _check_ops(ops, compute)
    job_id = job_id or new_job_id()
    cells = []
    for op, nbytes in ((o, s) for o in ops for s in sizes):
        for iters in iters_list:
            opts = Options(op=op, iters=iters, num_runs=runs, fence=fence,
                           dtype=dtype, sim_ranks=world.n,
                           device=world.device.type)
            try:
                point = run_point(opts, world, nbytes)
            except Exception as e:  # noqa: BLE001 — grid completeness
                cell = GridCell(
                    op=op, nbytes=nbytes, dtype=dtype, iters=iters,
                    n_devices=0, runs=0, drops=runs, p25=0.0, p50=0.0,
                    p75=0.0, vmax=0.0, lat_p50_us=0.0, verdict="failed",
                    unit=unit, note=f"{type(e).__name__}: {e}")
                cells.append(cell)
                if on_cell:
                    on_cell(cell)
                continue
            rows = point.rows(job_id, backend=world.backend)
            if on_rows:
                on_rows(rows)
            if compute:
                flops = FLOPS_PER_ITER[op](point.nbytes, DTYPE_ITEMSIZE[dtype])
                vals = [flops / (r.lat_us * 1e-6) / 1e12 for r in rows]
            else:
                vals = [r.busbw_gbps for r in rows]
            p50, p75 = percentile(vals, 50), percentile(vals, 75)
            note = ""
            if spec is not None and max(vals) > spec:
                note = "max>spec (slope artifact)"
            verdict = judge(p50, spec, floor, p75=p75)
            if verdict == "unphysical" and p50 <= spec:
                note = "p75>spec (jitter-widened)"
            cell = GridCell(
                op=point.op, nbytes=point.nbytes, dtype=dtype, iters=iters,
                n_devices=point.n_devices, runs=len(vals),
                drops=max(0, runs - len(vals)), p25=percentile(vals, 25),
                p50=p50, p75=p75, vmax=max(vals),
                lat_p50_us=percentile([r.lat_us for r in rows], 50),
                verdict=verdict, unit=unit, note=note)
            cells.append(cell)
            if on_cell:
                on_cell(cell)
    return mark_chosen(cells)


#: relative IQRs below this are statistically indistinguishable (the JAX
#: package's value): a microscopic IQR difference must not outrank a
#: higher p50
_STABILITY_FLOOR = 0.01


def _stability_key(c: GridCell) -> tuple:
    """Sort key: narrowest relative IQR wins (floored — sub-1% IQRs tie),
    higher p50 breaks ties."""
    rel_iqr = ((c.p75 - c.p25) / c.p50 if c.p50 > 0 else float("inf"))
    return (max(rel_iqr, _STABILITY_FLOOR), -c.p50)


#: chosen-cell candidates must reach this fraction of the op's best ok
#: p50, so a latency-bound cell with quantized samples cannot win on
#: stability alone (the JAX package's value)
_CHOSEN_P50_FRACTION = 0.8


def mark_chosen(cells: list[GridCell]) -> list[GridCell]:
    """Mark the most stable ``ok`` cell per op, among cells within
    ``_CHOSEN_P50_FRACTION`` of that op's best ok p50, as chosen."""
    best_p50: dict[str, float] = {}
    for c in cells:
        if c.verdict == "ok":
            best_p50[c.op] = max(best_p50.get(c.op, 0.0), c.p50)
    best = {}
    for c in cells:
        if (c.verdict == "ok"
                and c.p50 >= _CHOSEN_P50_FRACTION * best_p50[c.op]
                and (c.op not in best
                     or _stability_key(c) < _stability_key(best[c.op]))):
            best[c.op] = c
    chosen = set(id(c) for c in best.values())
    return [dataclasses.replace(c, chosen=id(c) in chosen) for c in cells]


def grid_caption(spec: float | None, floor: float | None, source: str, *,
                 unit: str = "GB/s") -> str:
    """The line above the verdict table: what the cells were judged
    against, in ``unit``, and where that came from."""
    metric = "TFLOP/s" if unit == "TFLOP/s" else "busbw"
    spec_s = "none" if spec is None else f"{spec:g} {unit}"
    floor_s = ("none: no cell is judged degraded" if floor is None
               else f"{floor:g} {unit}")
    return f"{metric} spec ceiling {spec_s} ({source}); floor {floor_s}"


def grid_to_markdown(cells: list[GridCell], *, fence: str = "slope") -> str:
    """Render the verdict table (the JAX package's layout).  With the
    slope/trace fences the iters column shows the lo/hi pair."""
    iters_head = "iters (lo/hi)" if fence in ("slope", "trace") else "iters"
    unit = cells[0].unit if cells else "GB/s"
    metric = "TFLOP/s" if unit == "TFLOP/s" else "busbw"
    lines = [
        f"| op | size | dtype | {iters_head} | {metric} p25/p50/p75 ({unit}) "
        "| max | dropped | verdict |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        verdict = f"**{c.verdict} — chosen**" if c.chosen else c.verdict
        if c.note:
            verdict += f" ({c.note})"
        iters_cell = (f"{c.iters}/{c.iters * SLOPE_ITERS_FACTOR}"
                      if fence in ("slope", "trace") else str(c.iters))
        lines.append(
            f"| {c.op} | {format_size(c.nbytes)} | {c.dtype} "
            f"| {iters_cell} "
            f"| {c.p25:.1f} / {c.p50:.1f} / {c.p75:.1f} "
            f"| {c.vmax:.4g} | {c.drops}/{c.runs + c.drops} "
            f"| {verdict} |"
        )
    return "\n".join(lines)
