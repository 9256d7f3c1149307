"""Link grading: roofline fractions + row/column MAD outliers (copy of
``tpu_perf/linkmap/grade.py``).

Two judgements per probed link, in the mpiGraph tradition but per-link
instead of per-cell-average:

* **Roofline** — the link's achieved bandwidth against the card's
  per-direction ``nvlink_gbps`` (tpu_perf_torch.chips).  Reported as a
  fraction on every verdict; links below ``roofline_floor`` (a fraction
  of the roofline) are graded ``slow`` outright.  Disabled (``None``)
  for synthetic and CPU sweeps, and in the single-card sim world, where
  a probe is a memory copy and no link exists.
* **Row/column MAD** — the localization signal.  A link ``(i, j)`` is
  compared against its peer population: every other link OF THE SAME
  MESH AXIS sharing its source row (``src == i``) or destination
  column (``dst == j``), the mpiGraph row/col sweep (falling back to
  the axis's whole link class when the population is tiny).  Peers are
  axis-scoped because a heterogeneous mesh's axes are different
  fabrics — on a ``(dcn, ici)`` mesh every healthy slow-axis link is
  legitimately many times a fast-axis link, and pooling them would
  grade the whole slow axis dead.  The robust z-score is
  ``(t - median) / (1.4826 * MAD)``; a link is ``slow`` only when BOTH
  the z-score clears ``mad_z`` AND the relative excess over the median
  clears ``rel_threshold`` — the double bar is what keeps near-flat
  synthetic populations (MAD ~ noise floor, so z inflates on nothing)
  from producing false alarms.  ``dead`` is reserved for links with no
  surviving samples (every probe dropped) or a mean beyond
  ``dead_ratio`` × the population median.

Thresholds are relative to each link's OWN peer population, never
absolute: per-link cost asymmetries (axis mixes, DCN vs ICI) make one
absolute number meaningless, the same argument the health detectors
apply per point (arXiv:2006.13112).
"""

from __future__ import annotations

import dataclasses

from tpu_perf_torch.linkmap.probe import (
    LinkmapRecord, LinkMapResult, ProbeResult,
)
from tpu_perf_torch.metrics import percentile

#: robust-sigma factor: MAD of a normal distribution is sigma / 1.4826
_MAD_SIGMA = 1.4826

VERDICTS = ("ok", "slow", "dead")


@dataclasses.dataclass(frozen=True)
class GradeConfig:
    """Grader knobs — one set per sweep."""

    roofline_gbps: float | None = None  # per-link spec bw; None = no roofline
    roofline_axes: tuple[str, ...] | None = None  # axes the roofline
    #                                   # models (None = every axis): the
    #                                   # card's nvlink_gbps is a fast-
    #                                   # link spec, so a dcn axis or the
    #                                   # all-pairs "pair" axis must not
    #                                   # be judged against it by default
    dcn_roofline_gbps: float | None = None  # per-link spec bw for the
    #                                   # dcn*-named axes — their OWN
    #                                   # roofline (--dcn-roofline-gbps),
    #                                   # so a sick slow-fabric hop is
    #                                   # graded against its own spec
    #                                   # as a fast link is against
    #                                   # nvlink_gbps; None =
    #                                   # dcn axes keep MAD-only grading
    roofline_floor: float = 0.5         # slow below this fraction of spec
    mad_z: float = 6.0                  # robust z bar for outliers
    rel_threshold: float = 0.25         # AND a +25% excess over the median
    dead_ratio: float = 10.0            # mean >= 10x median = dead
    min_population: int = 4             # row/col peers before global fallback

    def __post_init__(self) -> None:
        if self.roofline_gbps is not None and self.roofline_gbps <= 0:
            raise ValueError(
                f"roofline_gbps must be positive, got {self.roofline_gbps}"
            )
        if self.dcn_roofline_gbps is not None and self.dcn_roofline_gbps <= 0:
            raise ValueError(
                f"dcn_roofline_gbps must be positive, got "
                f"{self.dcn_roofline_gbps}"
            )
        if not 0.0 < self.roofline_floor < 1.0:
            raise ValueError(
                f"roofline_floor must be in (0, 1), got {self.roofline_floor}"
            )
        if self.mad_z <= 0 or self.rel_threshold <= 0:
            raise ValueError("mad_z and rel_threshold must be positive")
        if self.dead_ratio <= 1.0:
            raise ValueError(f"dead_ratio must be > 1, got {self.dead_ratio}")


@dataclasses.dataclass(frozen=True)
class LinkVerdict:
    """One graded link: the triage answer for one direction of one cable."""

    op: str
    src: int
    dst: int
    src_coords: tuple[int, ...]
    dst_coords: tuple[int, ...]
    axis: str
    rank: int
    host: str
    lat_us: float | None       # mean per-message latency
    bw_gbps: float | None
    roofline_frac: float | None
    mad_z: float | None        # robust z vs the row/col population
    rel: float | None          # relative excess over the population median
    baseline_us: float | None  # what a HEALTHY link would take: the peer
    #                          # median, overridden by the roofline-implied
    #                          # latency when the roofline produced the
    #                          # verdict — so the health event's
    #                          # observed/baseline pair always measures the
    #                          # degradation the verdict is about
    verdict: str               # ok | slow | dead
    detail: str
    run_id: int                # last probe run (the health-event clock)

    def to_record(self) -> LinkmapRecord:
        return LinkmapRecord(
            record="verdict", op=self.op, src=self.src, dst=self.dst,
            src_coords=list(self.src_coords), dst_coords=list(self.dst_coords),
            axis=self.axis, rank=self.rank, host=self.host,
            lat_us=self.lat_us, bw_gbps=self.bw_gbps,
            roofline_frac=self.roofline_frac, mad_z=self.mad_z,
            rel=self.rel, baseline_us=self.baseline_us,
            verdict=self.verdict, detail=self.detail,
            run_id=self.run_id,
        )


def _median(xs: list[float]) -> float:
    """The one p50 the codebase uses everywhere (metrics.percentile)."""
    return percentile(xs, 50)


def mad_robust_z(t: float, pop: list[float], *, rel_threshold: float,
                 med: float | None = None) -> tuple[float | None,
                                                    float | None,
                                                    float | None]:
    """The shared robust-outlier core: ``(z, rel, median)`` of ``t``
    against its peer population.  ``z`` is the MAD robust z-score
    ``(t - median) / (1.4826 * MAD)``; ``rel`` the relative excess over
    the median.  A zero MAD (near-flat population — synthetic sweeps, a
    healthy homogeneous fleet) degrades to ``inf``/``0`` keyed on
    whether ``rel`` clears ``rel_threshold``, so flat populations never
    inflate z on noise.  Extracted from the per-link grader so a
    cross-HOST grading (the fleet rollup, still to port) judges hosts
    with exactly the machinery that judges links — one definition of
    "outlier against its peers" for the whole instrument stack.
    Returns ``(None, None, median-or-None)`` when the population is
    empty or its median is non-positive (nothing to judge against).
    ``med`` accepts the caller's already-computed population median so
    a wide sweep's grading pass never computes it twice per link."""
    if not pop:
        return None, None, None
    if med is None:
        med = _median(pop)
    if med <= 0:
        return None, None, med
    mad = _median([abs(x - med) for x in pop])
    rel = t / med - 1.0
    z = ((t - med) / (_MAD_SIGMA * mad)) if mad > 0 else (
        float("inf") if rel > rel_threshold else 0.0
    )
    return z, rel, med


class _AxisIndex:
    """One axis class's link times, indexed by source row and
    destination column — built ONCE per axis so each link's peer lookup
    is O(peers), not a scan of the whole class (an all-pairs sweep's
    "pair" axis holds n*(n-1) links; a per-link scan would make grading
    O(n^4) and dwarf the probe time on wide fleets)."""

    def __init__(self, times: dict[tuple[int, int], float]):
        self.times = times
        self.rows: dict[int, list[tuple[int, float]]] = {}
        self.cols: dict[int, list[tuple[int, float]]] = {}
        for (s, d), t in times.items():
            self.rows.setdefault(s, []).append((d, t))
            self.cols.setdefault(d, []).append((s, t))


def _population(r: ProbeResult, idx: _AxisIndex,
                cfg: GradeConfig) -> list[float]:
    """The link's peers: SAME-AXIS links sharing its source row or
    destination column, excluding itself; the axis's whole link class
    when too few.  Never cross-axis — axes are different fabrics."""
    src, dst = r.probe.src, r.probe.dst
    pop = [t for d, t in idx.rows.get(src, ()) if d != dst]
    pop += [t for s, t in idx.cols.get(dst, ()) if s != src]
    if len(pop) < cfg.min_population:
        # tiny classes only (big ones have >= 2(n-2) row/col peers), so
        # the O(class) fallback scan never hits the wide-fabric path
        pop = [t for k, t in idx.times.items() if k != (src, dst)]
    return pop


def peer_links(result: LinkMapResult, links: set[tuple[int, int]],
               config: GradeConfig | None = None) -> set[tuple[int, int]]:
    """The links in the grading population of each of ``links`` (the
    peers :func:`_population` takes their times from), ``links``
    themselves excluded: a link measured anew must be graded against
    peers measured the same way."""
    cfg = config or GradeConfig()
    by_axis: dict[str, dict[tuple[int, int], float]] = {}
    for r in result.probes:
        if r.mean_s is not None:
            by_axis.setdefault(r.probe.axis, {})[
                (r.probe.src, r.probe.dst)] = r.mean_s
    peers: set[tuple[int, int]] = set()
    for r in result.probes:
        src, dst = r.probe.src, r.probe.dst
        if (src, dst) not in links or r.probe.axis not in by_axis:
            continue
        idx = _AxisIndex(by_axis[r.probe.axis])
        keys = [(src, d) for d, _ in idx.rows.get(src, ()) if d != dst]
        keys += [(s, dst) for s, _ in idx.cols.get(dst, ()) if s != src]
        if len(keys) < cfg.min_population:
            keys = [k for k in idx.times if k != (src, dst)]
        peers.update(keys)
    return peers - links


def _roofline_for(axis: str, cfg: GradeConfig) -> float | None:
    """The per-axis roofline: dcn*-named axes (the make_mesh naming
    convention, any case) get their OWN spec when ``dcn_roofline_gbps``
    is set — a slow-fabric hop graded against that fabric's number,
    never the fast-link spec it can legitimately never reach — and otherwise fall
    back to the general roofline under its axis scoping."""
    if axis.lower().startswith("dcn") and cfg.dcn_roofline_gbps is not None:
        return cfg.dcn_roofline_gbps
    if cfg.roofline_gbps is not None and (
            cfg.roofline_axes is None or axis in cfg.roofline_axes):
        return cfg.roofline_gbps
    return None


def grade(result: LinkMapResult,
          config: GradeConfig | None = None) -> list[LinkVerdict]:
    """Judge every probed link; verdicts in probe order."""
    cfg = config or GradeConfig()
    by_axis: dict[str, dict[tuple[int, int], float]] = {}
    for r in result.probes:
        if r.mean_s is not None:
            by_axis.setdefault(r.probe.axis, {})[
                (r.probe.src, r.probe.dst)] = r.mean_s
    index = {axis: _AxisIndex(times) for axis, times in by_axis.items()}
    empty = _AxisIndex({})
    verdicts = []
    for r in result.probes:
        t = r.mean_s
        pop = _population(r, index.get(r.probe.axis, empty), cfg)
        med = _median(pop) if pop else None
        common = dict(
            op=r.probe.op, src=r.probe.src, dst=r.probe.dst,
            src_coords=r.probe.src_coords, dst_coords=r.probe.dst_coords,
            axis=r.probe.axis, rank=r.rank, host=r.host,
            lat_us=None if t is None else t * 1e6, bw_gbps=r.bw_gbps,
            roofline_frac=None, mad_z=None, rel=None,
            baseline_us=None if med is None else med * 1e6,
            run_id=r.last_run,
        )
        if t is None:
            verdicts.append(LinkVerdict(
                **common, verdict="dead",
                detail=f"no surviving samples ({r.dropped} dropped)",
            ))
            continue
        axis_roofline = _roofline_for(r.probe.axis, cfg)
        if axis_roofline is not None and r.bw_gbps is not None:
            common["roofline_frac"] = r.bw_gbps / axis_roofline
        z = rel = None
        if med is not None and med > 0:
            z, rel, _ = mad_robust_z(t, pop, med=med,
                                     rel_threshold=cfg.rel_threshold)
        common["mad_z"] = z
        common["rel"] = rel
        if rel is not None and (1.0 + rel) >= cfg.dead_ratio:
            verdicts.append(LinkVerdict(
                **common, verdict="dead",
                detail=f"{1.0 + rel:.3g}x the peer median "
                       f"(>= dead ratio {cfg.dead_ratio:g})",
            ))
            continue
        if z is not None and rel is not None and \
                z > cfg.mad_z and rel > cfg.rel_threshold:
            verdicts.append(LinkVerdict(
                **common, verdict="slow",
                detail=f"+{100 * rel:.3g}% vs row/col median "
                       f"(robust z {z:.3g})",
            ))
            continue
        frac = common["roofline_frac"]
        if frac is not None and frac < cfg.roofline_floor:
            # the roofline produced this verdict, so the event baseline
            # is what the roofline says the transfer should take — the
            # peer median measures nothing here (peers may be equally
            # under spec, rel ~ 0, or even slower than this link)
            common["baseline_us"] = \
                r.nbytes / (axis_roofline * 1e9) * 1e6
            verdicts.append(LinkVerdict(
                **common, verdict="slow",
                detail=f"{100 * frac:.3g}% of the {axis_roofline:g} "
                       f"GB/s link roofline (floor "
                       f"{100 * cfg.roofline_floor:g}%)",
            ))
            continue
        verdicts.append(LinkVerdict(**common, verdict="ok", detail=""))
    return verdicts


def meta_record(result: LinkMapResult, *, job_id: str,
                config: GradeConfig, seed: int | None = None,
                mode: str = "neighbor") -> LinkmapRecord:
    """The sweep's header record — everything a replay or the telemetry
    store needs to interpret the probe/verdict rows (no wall-clock
    fields beyond the rotating file name's own timestamp)."""
    return LinkmapRecord(
        record="meta", job_id=job_id, mode=mode,
        n=result.n, shape=list(result.shape), axes=list(result.axes),
        nbytes=result.nbytes, iters=result.iters, runs=result.runs,
        fence=result.fence, concurrent=result.concurrent,
        synthetic=result.synthetic, seed=seed,
        roofline_gbps=config.roofline_gbps,
        roofline_axes=None if config.roofline_axes is None
        else list(config.roofline_axes),
        dcn_roofline_gbps=config.dcn_roofline_gbps,
        roofline_floor=config.roofline_floor,
        mad_z=config.mad_z, rel_threshold=config.rel_threshold,
        dead_ratio=config.dead_ratio,
    )
