"""Probe-sweep planner: a named mesh decomposed into directed link probes
(copy of ``tpu_perf/linkmap/plan.py``).

The fleet-triage question — WHICH link is sick — needs per-link
measurements, not whole-collective averages (PAPERS.md: pMR's per-link
modelling; mpiGraph's all-pairs matrices).  The planner turns a mesh
shape into :class:`Schedule`\\ s of :class:`LinkProbe`\\ s:

* **Neighbor mode** (:func:`plan_mesh_links`): one schedule per
  ``(axis, shift)`` — the ±1 ring shift along each mesh axis, i.e. every
  device probing its axis neighbor at once.  Within a schedule no two
  probes share a *directed* link (each directed link carries exactly one
  message; links are full duplex, so the two directions of one cable
  are distinct probes and may run concurrently), which is what makes the
  batched/concurrent probe mode contention-free.  Across all schedules
  every directed neighbor link of the torus appears exactly once.
* **All-pairs mode** (:func:`plan_all_pairs`): the mpiGraph-style
  host×host sweep for multi-host fabrics, or every card pair of an
  NVSwitch node — a round-robin tournament (circle method) whose every
  round is mapped through the existing
  :func:`tpu_perf_torch.topology.pair_permutation` machinery, so each
  round is a two-group pairing exactly like the reference's host-group topology
  and rounds cover every ordered pair once.

Pure logic: flat indices are row-major over the mesh shape (the flat
rank order of :mod:`tpu_perf_torch.parallel.mesh`), so the prober maps
probes onto ranks mechanically and the planner is testable without a
device.
"""

from __future__ import annotations

import dataclasses
import math

from tpu_perf_torch.topology import pair_permutation


def coords_of(flat: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    """Row-major coordinates of flat index ``flat`` in ``shape``."""
    out = []
    for s in reversed(shape):
        out.append(flat % s)
        flat //= s
    return tuple(reversed(out))


def flat_of(coords: tuple[int, ...], shape: tuple[int, ...]) -> int:
    flat = 0
    for c, s in zip(coords, shape):
        flat = flat * s + c
    return flat


def format_coords(coords: tuple[int, ...]) -> str:
    return "(" + ",".join(str(c) for c in coords) + ")"


def probe_op_name(src_coords: tuple[int, ...],
                  dst_coords: tuple[int, ...]) -> str:
    """The probe's op name, e.g. ``link:(1,2)>(1,3)``.

    This string is the probe's identity everywhere downstream: the
    matrix cell, the grader's verdict, the ``link_degraded`` health
    event's op column, and the fault-schedule filter a chaos/CI run
    targets one link with (``FaultSpec(op="link:(1,2)>(1,3)", ...)``).
    """
    return f"link:{format_coords(src_coords)}>{format_coords(dst_coords)}"


@dataclasses.dataclass(frozen=True)
class LinkProbe:
    """One directed link measurement: src device sends dst one message."""

    src: int                       # flat device index (row-major)
    dst: int
    src_coords: tuple[int, ...]
    dst_coords: tuple[int, ...]
    axis: str                      # mesh axis name; "pair" in all-pairs mode
    shift: int                     # ±1 neighbor shift; 0 in all-pairs mode

    @property
    def op(self) -> str:
        return probe_op_name(self.src_coords, self.dst_coords)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A set of directed probes that never share a directed link — safe
    to drive as ONE ppermute (concurrent mode) or one at a time."""

    name: str                      # e.g. "ici[+1]", "pairs[2]"
    probes: tuple[LinkProbe, ...]

    def perm(self) -> list[tuple[int, int]]:
        """The schedule as a ppermute permutation (concurrent mode)."""
        return [(p.src, p.dst) for p in self.probes]


def _check_disjoint(probes: list[LinkProbe], name: str) -> None:
    links = [(p.src, p.dst) for p in probes]
    if len(set(links)) != len(links):
        raise ValueError(f"schedule {name} repeats a directed link")
    # one message out and one in per device: the ppermute contract, and
    # what keeps a concurrent schedule free of endpoint contention
    if len({s for s, _ in links}) != len(links) or \
            len({d for _, d in links}) != len(links):
        raise ValueError(f"schedule {name} reuses a src or dst device")


def plan_mesh_links(
    shape: tuple[int, ...],
    axes: tuple[str, ...] = (),
    *,
    wrap: bool = True,
) -> list[Schedule]:
    """Neighbor-link schedules for a mesh of ``shape``.

    One schedule per (axis, direction): the +1 and -1 ring shifts along
    each axis of size >= 2.  ``wrap=False`` drops the wraparound edges
    (a non-torus line fabric).  A size-2 axis keeps only the +1 shift
    when wrapping (its -1 shift names the same two directed links).
    """
    if not shape or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {shape}")
    if not axes:
        axes = tuple(f"ax{i}" for i in range(len(shape)))
    if len(axes) != len(shape):
        raise ValueError(f"shape {shape} / axes {axes} length mismatch")
    n = math.prod(shape)
    schedules: list[Schedule] = []
    for k, (axis, size) in enumerate(zip(axes, shape)):
        if size < 2:
            continue
        shifts = (1,) if size == 2 and wrap else (1, -1)
        for shift in shifts:
            probes = []
            for flat in range(n):
                c = coords_of(flat, shape)
                nxt = c[k] + shift
                if not wrap and not 0 <= nxt < size:
                    continue  # line fabric: no wraparound link
                d = c[:k] + (nxt % size,) + c[k + 1:]
                probes.append(LinkProbe(
                    src=flat, dst=flat_of(d, shape),
                    src_coords=c, dst_coords=d,
                    axis=axis, shift=shift,
                ))
            if not probes:
                continue
            name = f"{axis}[{shift:+d}]"
            _check_disjoint(probes, name)
            schedules.append(Schedule(name=name, probes=tuple(probes)))
    return schedules


def _round_robin_rounds(n: int) -> list[list[tuple[int, int]]]:
    """Circle-method tournament: ``n`` participants, each round a perfect
    matching, every unordered pair met exactly once.  Odd ``n`` plays
    with a bye (pairs touching it are dropped)."""
    members = list(range(n))
    if n % 2:
        members.append(-1)  # the bye
    m = len(members)
    rounds = []
    for _ in range(m - 1):
        pairs = [
            (members[i], members[m - 1 - i])
            for i in range(m // 2)
            if members[i] != -1 and members[m - 1 - i] != -1
        ]
        rounds.append(pairs)
        # rotate all but the first member
        members = [members[0]] + [members[-1]] + members[1:-1]
    return rounds


def plan_all_pairs(n: int) -> list[Schedule]:
    """All-ordered-pairs schedules over ``n`` endpoints (mpiGraph mode —
    hosts of a fleet, or every card pair of one NVSwitch node).

    Each tournament round's matching is laid out as a two-group order
    ``[a_0..a_k, b_0..b_k]`` and expanded through
    :func:`tpu_perf_torch.topology.pair_permutation` — the same first-half/
    second-half pairing machinery the pair topology uses — which yields
    both directions of every pair, so one round probes each of its links
    full duplex and the rounds together cover all ``n*(n-1)`` ordered
    pairs exactly once.
    """
    if n < 2:
        raise ValueError(f"all-pairs needs >= 2 endpoints, got {n}")
    schedules = []
    for r, pairs in enumerate(_round_robin_rounds(n)):
        order = [a for a, _ in pairs] + [b for _, b in pairs]
        probes = []
        for i, j in pair_permutation(len(order)):
            src, dst = order[i], order[j]
            probes.append(LinkProbe(
                src=src, dst=dst,
                src_coords=(src,), dst_coords=(dst,),
                axis="pair", shift=0,
            ))
        name = f"pairs[{r}]"
        _check_disjoint(probes, name)
        schedules.append(Schedule(name=name, probes=tuple(probes)))
    return schedules


def all_links(schedules: list[Schedule]) -> list[LinkProbe]:
    """Every probe of a plan, flattened in schedule order."""
    return [p for s in schedules for p in s.probes]
