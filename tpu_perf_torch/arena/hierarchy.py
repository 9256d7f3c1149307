"""Hierarchical multislice collectives: slow-axis-minimal composed
algorithms (port of ``tpu_perf/arena/hierarchy.py``).

A production mesh is a (slow, fast) axis tuple -- (dcn, ici) in the JAX
package's words: across nodes and within one -- and the cheapest hop to
minimise is the slow one.  The generalized-allreduce construction (arXiv
2004.09362) composes each collective from phases, each over the axis
whose fabric suits it:

=================  ===================================================
collective         composition (slow axis D ranks, fast axis I; m)
=================  ===================================================
allreduce          reduce_scatter over the fast axis (m -> m/I)
                   -> allreduce over the slow axis (the m/I shard)
                   -> all_gather over the fast axis (m/I -> m)
all_gather         all_gather over the slow axis first (the m/n
                   shard), then over the fast axis, then one local
                   block transpose back to row-major rank order
reduce_scatter     reduce_scatter over the fast axis, then over the
                   slow axis, after one local block pre-transpose
=================  ===================================================

``hier`` runs each phase as the library call along its axis (in the sim
world the row sums and gathers of :class:`~tpu_perf_torch.arena.spmd.
Ranks`; across processes ``torch.distributed`` on the axis group);
``hier-<inner>`` runs each phase on the flat catalog's hand-built
schedule, and ``hier-<p0>/<p1>[/<p2>]`` names one inner a phase.  A
hierarchical algorithm is keyed per mesh-axis tuple
(``hier-ring:dcn=2+ici=4``); the first axis is the slow one.

:func:`phase_traffic` prices each phase's per-rank wire bytes on its
axis; :func:`dcn_bound_bytes` / :func:`flat_dcn_bytes` give the bound
``report`` renders beside the measured time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_perf_torch.arena import spmd
from tpu_perf_torch.arena.algorithms import (
    _ALLGATHER,
    _SUM_ALLREDUCE,
    _SUM_REDUCE_SCATTER,
    _pad_to_blocks,
)
from tpu_perf_torch.topology import format_axis_tuple, parse_axis_tuple

#: every hierarchical base name starts with this
HIER_PREFIX = "hier"

#: the phase kinds each composition runs, in order (the accounting
#: model walks the same table, so pricing can never drift from the
#: program structure)
_COMPOSITIONS: dict[str, tuple[str, ...]] = {
    # (phase collective, axis slot): slot 0 = slow/outer, 1 = fast/inner
    "allreduce": ("reduce_scatter@1", "allreduce@0", "all_gather@1"),
    "all_gather": ("all_gather@0", "all_gather@1"),
    "reduce_scatter": ("reduce_scatter@1", "reduce_scatter@0"),
}

#: which phase kinds each flat inner algorithm implements (the
#: registration filter: a hier-<inner> variant exists only when the
#: inner catalog covers every phase its composition needs)
_INNER_PHASES: dict[str, frozenset] = {
    "ring": frozenset({"reduce_scatter", "allreduce", "all_gather"}),
    "rhd": frozenset({"reduce_scatter", "allreduce", "all_gather"}),
    "bruck": frozenset({"allreduce", "all_gather"}),
    "binomial": frozenset({"reduce_scatter", "allreduce"}),
}

#: inner algorithms whose pairing math needs a power-of-two size on
#: EVERY axis they run a phase over
_POW2_INNERS = frozenset({"rhd"})


def is_hier(algo: str) -> bool:
    """True for any hierarchical algo spelling — bare base (``hier``,
    ``hier-ring``) or keyed (``hier-ring:dcn=2+ici=4``)."""
    base = str(algo).split(":", 1)[0]
    return base == HIER_PREFIX or base.startswith(HIER_PREFIX + "-")


def split_hier(algo: str) -> tuple[str, tuple[tuple[str, int], ...] | None]:
    """``(base, axis_pairs-or-None)`` of a hier algo string; the pairs
    half parses the keyed suffix (None for a bare base name)."""
    base, sep, suffix = str(algo).partition(":")
    if not sep:
        return base, None
    return base, parse_axis_tuple(suffix)


def hier_axis_pairs(algo: str) -> tuple[tuple[str, int], ...] | None:
    """The keyed mesh-axis tuple of ``algo``, or None when ``algo`` is
    not a keyed hierarchical name (non-hier, or bare base).  The one
    lookup report uses to recover the mesh shape from a row's algo
    column — never raises on foreign algo strings."""
    if not is_hier(algo):
        return None
    try:
        _, pairs = split_hier(algo)
    except ValueError:
        return None
    return pairs


def hier_inner(base: str) -> str:
    """The per-axis inner algorithm of a base name: ``"native"`` for
    bare ``hier`` (per-axis XLA primitives), else the flat-catalog name
    (``hier-ring`` -> ``ring``)."""
    if base == HIER_PREFIX:
        return "native"
    return base[len(HIER_PREFIX) + 1:]


def split_mixed_inner(base: str) -> tuple[str, ...] | None:
    """The slash-separated per-PHASE inner list of a mixed spelling
    (``hier-ring/native/bruck`` -> ``("ring", "native", "bruck")``), or
    None for the single-inner registry names (``hier`` / ``hier-ring``).
    Purely syntactic — arity and phase coverage are judged per
    collective by :func:`hier_inners`."""
    if not str(base).startswith(HIER_PREFIX + "-"):
        return None
    inner = str(base)[len(HIER_PREFIX) + 1:]
    if "/" not in inner:
        return None
    return tuple(inner.split("/"))


def hier_inners(collective: str, base: str) -> tuple[tuple[str, ...],
                                                     tuple[str, ...]]:
    """``(inners, phases)`` — the per-phase inner algorithms of the
    ``collective`` composition under the hier spelling ``base``: the
    ONE resolver the registered single-inner names and the mixed
    ``hier-<p0>/<p1>[/<p2>]`` spelling share (one inner per PHASE
    instead of one per name — the PR-13 headroom item; the scenario
    engine's per-phase selection reuses this parser).  Every way a
    spelling can be wrong fails here with the specific reason — an
    uncovered phase is a LOUD error, never a silent fallback to a
    different wire schedule mid-composition."""
    phases = _COMPOSITIONS.get(collective)
    if phases is None:
        raise ValueError(
            f"op {collective!r} has no hierarchical decompositions; "
            f"hier collectives: {tuple(sorted(_COMPOSITIONS))}"
        )
    mixed = split_mixed_inner(base)
    if mixed is None:
        entry = HIER_ALGORITHMS.get((collective, base))
        if entry is None:
            raise ValueError(
                f"no {base!r} hierarchical decomposition registered for "
                f"{collective!r}; registered: {hier_bases_for(collective)} "
                f"(or the mixed per-phase spelling "
                f"hier-<inner>/<inner>...)"
            )
        return (entry.inner,) * len(phases), phases
    chain = " -> ".join(p.split("@")[0] for p in phases)
    if len(mixed) != len(phases):
        raise ValueError(
            f"{collective}@{base}: the mixed-inner spelling names one "
            f"inner per phase, and {collective}'s composition runs "
            f"{len(phases)} ({chain}) — got {len(mixed)}"
        )
    for inner, ph in zip(mixed, phases):
        kind = ph.split("@", 1)[0]
        if inner == "native":
            continue
        has = _INNER_PHASES.get(inner)
        if has is None:
            raise ValueError(
                f"unknown inner {inner!r} in {base!r}; flat-catalog "
                f"inners: {tuple(sorted(_INNER_PHASES))} (or native)"
            )
        if kind not in has:
            raise ValueError(
                f"{collective}@{base}: inner {inner!r} has no {kind} "
                f"schedule (it implements {tuple(sorted(has))}), so "
                f"that phase cannot run it — name an inner that covers "
                f"the {kind} slot"
            )
    return mixed, phases


@dataclasses.dataclass(frozen=True)
class HierAlgorithm:
    """One registered (collective, hier base) composition."""

    collective: str
    base: str
    inner: str  # per-phase algorithm: "native" | flat catalog name
    pow2_axes: bool = False  # every phase axis size must be a power of 2
    summary: str = ""


def _build_registry() -> dict[tuple[str, str], HierAlgorithm]:
    reg: dict[tuple[str, str], HierAlgorithm] = {}
    for coll, phases in _COMPOSITIONS.items():
        kinds = {p.split("@", 1)[0] for p in phases}
        chain = " -> ".join(
            f"{p.split('@')[0]}({'dcn' if p.endswith('@0') else 'ici'})"
            for p in phases)
        reg[(coll, HIER_PREFIX)] = HierAlgorithm(
            collective=coll, base=HIER_PREFIX, inner="native",
            summary=f"{chain} via the native per-axis primitives",
        )
        for inner, has in sorted(_INNER_PHASES.items()):
            if kinds <= has:
                reg[(coll, f"{HIER_PREFIX}-{inner}")] = HierAlgorithm(
                    collective=coll, base=f"{HIER_PREFIX}-{inner}",
                    inner=inner, pow2_axes=inner in _POW2_INNERS,
                    summary=f"{chain} via the {inner} schedules per axis",
                )
    return reg


#: the hierarchical registry: (collective, base) -> HierAlgorithm.
#: Deliberately SEPARATE from the flat ARENA_ALGORITHMS table — flat
#: entries are single-axis programs, hier entries need a 2-axis mesh,
#: and every flat-registry consumer (``--algo all`` on a flat mesh, the
#: parity gates) keeps its meaning unchanged.
HIER_ALGORITHMS: dict[tuple[str, str], HierAlgorithm] = _build_registry()


def hier_bases_for(collective: str) -> tuple[str, ...]:
    """Registered hierarchical base names for one collective (sorted)."""
    return tuple(sorted(b for c, b in HIER_ALGORITHMS if c == collective))


def is_hier_compatible(collective: str, base: str,
                       axis_sizes: tuple[int, ...]) -> bool:
    entry = HIER_ALGORITHMS.get((collective, base))
    if entry is None or len(axis_sizes) != 2:
        return False
    if entry.pow2_axes and any(s & (s - 1) for s in axis_sizes):
        return False
    return True


def resolve_hier(collective: str, algo: str, axes: tuple[str, ...],
                 sizes: tuple[int, ...]) -> str:
    """Validate ``algo`` (bare or keyed) against this job's mesh-axis
    tuple and return the KEYED name (``hier-ring:dcn=2+ici=4``) rows
    and compile specs carry.  Every way the pair can be wrong fails
    here, loudly, before anything compiles."""
    base, pairs = split_hier(algo)
    # mixed spellings resolve per phase; registry names per entry —
    # both through the one shared resolver (unknown bases/collectives
    # and uncovered phases raise their specific errors here)
    inners, phases = hier_inners(collective, base)
    if len(axes) == 1:
        raise ValueError(
            f"{collective}@{base} composes per-axis phases and needs a "
            f"2-axis (slow, fast) mesh — on the single axis {axes[0]!r} "
            f"there is no slow hop to minimize (the flat native lowering "
            f"IS the algorithm there; --mesh DxI --axes dcn,ici builds "
            f"the multislice mesh)"
        )
    if len(axes) != 2:
        raise ValueError(
            f"{collective}@{base} needs exactly two mesh axes "
            f"(slow, fast), got {axes} — name two with --axes"
        )
    for inner, ph in zip(inners, phases):
        if inner in _POW2_INNERS:
            # pow2 is judged per PHASE SLOT: a mixed spelling running
            # rhd on one axis only constrains that axis (the uniform
            # registry names constrain every axis they touch, exactly
            # as before)
            slot = int(ph.split("@", 1)[1])
            if sizes[slot] & (sizes[slot] - 1):
                raise ValueError(
                    f"{collective}@{base} runs recursive halving/"
                    f"doubling over axis {axes[slot]!r} and needs "
                    f"power-of-two axis sizes there, got "
                    f"{tuple(zip(axes, sizes))}"
                )
    keyed = f"{base}:{format_axis_tuple(zip(axes, sizes))}"
    if pairs is not None and pairs != tuple(zip(axes, sizes)):
        raise ValueError(
            f"algo {algo!r} is keyed for mesh axes {pairs}, but this "
            f"job's collective axes are {tuple(zip(axes, sizes))} "
            f"(a keyed name from another mesh's artifact cannot run here)"
        )
    return keyed


def hier_algos_for(op: str, mesh_axes: tuple[tuple[str, int], ...],
                   err=None) -> list[str]:
    """Every registered hierarchical algorithm compatible with ``op``
    on this mesh-axis tuple, KEYED — the ``--algo all`` expansion for a
    multi-axis mesh.  Incompatible pow2-only variants are skipped with
    a note (the flat catalog's rhd-skip precedent); a mesh the whole
    family cannot run on (3+ axes) is ONE note naming the real reason,
    never a per-variant misdiagnosis."""
    axes = tuple(a for a, _ in mesh_axes)
    sizes = tuple(s for _, s in mesh_axes)
    if len(mesh_axes) != 2:
        if err is not None and hier_bases_for(op):
            print(f"[tpu-perf-torch] arena: skipping the {op} hier* "
                  f"compositions (they need exactly two mesh axes — "
                  f"slow, fast — got {tuple(zip(axes, sizes))}; name "
                  f"two with --axes)", file=err)
        return []
    out = []
    for base in hier_bases_for(op):
        if is_hier_compatible(op, base, sizes):
            out.append(resolve_hier(op, base, axes, sizes))
        elif err is not None:
            print(f"[tpu-perf-torch] arena: skipping {op}@{base} (needs "
                  f"power-of-two axis sizes, have "
                  f"{tuple(zip(axes, sizes))})", file=err)
    return out


# --- composed phase implementations ----------------------------------


def _pad_to_axis(x, k):
    """Each rank's buffer zero-padded to a multiple of ``k`` (flat): the
    virtual padding that lets an allreduce payload of any length ride the
    fast-axis reduce_scatter (the pad rides the wire and is sliced off
    after)."""
    return _pad_to_blocks(x, k).reshape(x.shape[0], -1)


def _phase_rs(y, inner, rk, axis, k):
    return rk.psum_scatter(y, axis) if inner == "native" \
        else _SUM_REDUCE_SCATTER[inner](y, rk, axis, k)


def _phase_ar(y, inner, rk, axis, k):
    return rk.psum(y, axis) if inner == "native" \
        else _SUM_ALLREDUCE[inner](y, rk, axis, k)


def _phase_ag(y, inner, rk, axis, k):
    return rk.all_gather(y, axis) if inner == "native" \
        else _ALLGATHER[inner](y, rk, axis, k)


def _hier_allreduce_sum(x, rk, axes, sizes, inners):
    """reduce_scatter(fast) -> allreduce(slow) -> all_gather(fast): the
    UNSCALED sum (the body scales by 1/n).  Only the m/I reduced shard
    crosses the slow axis."""
    dcn, ici = axes
    d, i = sizes
    m = x.shape[1]
    xb = _pad_to_axis(x, i)
    rs_in, ar_in, ag_in = inners
    s = _phase_rs(xb, rs_in, rk, ici, i)
    s = _phase_ar(s, ar_in, rk, dcn, d)
    g = _phase_ag(s, ag_in, rk, ici, i)
    return g[:, :m]


def _hier_allgather(x, rk, axes, sizes, inners):
    """all_gather(slow) THEN all_gather(fast), plus one local block
    transpose: after the fast phase position ``i*D + d`` holds shard
    ``(d, i)``, and row-major rank order wants ``d*I + i``."""
    dcn, ici = axes
    d, i = sizes
    rows, s = x.shape
    g1 = _phase_ag(x, inners[0], rk, dcn, d)
    g2 = _phase_ag(g1, inners[1], rk, ici, i)
    return g2.reshape(rows, i, d, s).transpose(1, 2).reshape(rows, -1)


def _hier_reduce_scatter_sum(x, rk, axes, sizes, inners):
    """reduce_scatter(fast) -> reduce_scatter(slow), after one local block
    PRE-transpose so that rank (d, i) lands on the row-major segment
    ``d*I + i``.  The UNSCALED sum of the own shard."""
    dcn, ici = axes
    d, i = sizes
    rows = x.shape[0]
    c = x.shape[1] // (d * i)
    xp = x.reshape(rows, d, i, c).transpose(1, 2).reshape(rows, -1)
    s1 = _phase_rs(xp, inners[0], rk, ici, i)
    return _phase_rs(s1, inners[1], rk, dcn, d)


def hier_body_builder(collective: str, algo: str) -> Callable:
    """A builder ``(rk, axes, axis_sizes, n, elems, dtype) -> body``
    wrapping the composition in the native op's carry contract, with the
    flat index over both axes in place of the single axis' index.
    ``algo`` may be bare or keyed; validation happened in
    ``resolve_hier``."""
    base, _ = split_hier(algo)
    inners, _ = hier_inners(collective, base)

    def make(rk, axes, axis_sizes, n, elems, dtype):
        inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)
        if collective == "allreduce":

            def body(x):
                return _hier_allreduce_sum(x, rk, axes, axis_sizes,
                                           inners) * inv

        elif collective == "all_gather":

            def body(x):
                # gather, then carry the own shard back
                g = _hier_allgather(x, rk, axes, axis_sizes, inners)
                idx = rk.axis_index(tuple(axes))
                return spmd.dslice(g, idx * x.shape[1], x.shape[1])

        else:  # reduce_scatter

            def body(x):
                s = _hier_reduce_scatter_sum(x, rk, axes, axis_sizes,
                                             inners) * inv
                idx = rk.axis_index(tuple(axes))
                return spmd.dupdate(x, s, idx * s.shape[1])

        return body

    return make


# --- bytes-per-axis accounting model ---------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseTraffic:
    """One phase's per-device traffic on its axis.

    ``payload_bytes`` is the buffer the phase operates on (the payload
    volume exposed to that axis's fabric); ``wire_bytes`` the standard
    per-device bytes sent by a bandwidth-optimal schedule of the phase
    collective over ``axis_size`` ranks (reduce_scatter ``b(k-1)/k``,
    allreduce ``2b(k-1)/k``, all_gather ``b_in(k-1)`` received)."""

    phase: str        # reduce_scatter | allreduce | all_gather
    axis: str
    axis_size: int
    payload_bytes: float
    wire_bytes: float


def phase_traffic(collective: str, nbytes: int,
                  pairs: tuple[tuple[str, int], ...]) -> list[PhaseTraffic]:
    """Per-phase traffic of the hierarchical composition of
    ``collective`` at row size ``nbytes`` on mesh-axis tuple ``pairs``.
    Size semantics are the ROW's (``payload_elems``): all_gather rows
    carry the gathered total, allreduce/reduce_scatter the per-device
    buffer — so report can feed a row's nbytes straight in."""
    if collective not in _COMPOSITIONS:
        raise ValueError(
            f"{collective!r} has no hierarchical composition; known: "
            f"{tuple(_COMPOSITIONS)}"
        )
    pairs = tuple((str(a), int(s)) for a, s in pairs)
    if len(pairs) != 2:
        raise ValueError(f"need a 2-axis tuple, got {pairs}")
    (dcn, d), (ici, i) = pairs
    n = d * i
    out = []
    for spec in _COMPOSITIONS[collective]:
        kind, slot = spec.split("@", 1)
        axis, k = pairs[int(slot)]
        out.append((kind, axis, k))
    traffic = []
    if collective == "allreduce":
        m = float(nbytes)
        buffers = (m, m / i, m / i)      # RS(ici), AR(dcn), AG(ici)
    elif collective == "all_gather":
        s = float(nbytes) / n            # per-device shard
        buffers = (s, s * d)             # AG(dcn) input, AG(ici) input
    else:  # reduce_scatter
        m = float(nbytes)
        buffers = (m, m / i)             # RS(ici), RS(dcn)
    for (kind, axis, k), b in zip(out, buffers):
        if kind == "reduce_scatter":
            wire = b * (k - 1) / k
        elif kind == "allreduce":
            wire = 2 * b * (k - 1) / k
        else:  # all_gather: b is the per-device INPUT shard
            wire = b * (k - 1)
        traffic.append(PhaseTraffic(phase=kind, axis=axis, axis_size=k,
                                    payload_bytes=b, wire_bytes=wire))
    return traffic


def axis_bytes(collective: str, nbytes: int,
               pairs: tuple[tuple[str, int], ...]) -> dict[str, float]:
    """Per-axis wire-byte totals (per device) of the composition — the
    bytes-per-axis model summed over phases."""
    totals: dict[str, float] = {}
    for ph in phase_traffic(collective, nbytes, pairs):
        totals[ph.axis] = totals.get(ph.axis, 0.0) + ph.wire_bytes
    return totals


def dcn_bound_bytes(collective: str, nbytes: int,
                    pairs: tuple[tuple[str, int], ...]) -> float:
    """The headline DCN bound: the unique payload volume each device
    must push across the SLOW (first) axis under the hierarchical
    composition, one direction.

    * allreduce: the reduced shard — ``payload / n_slice`` (n_slice =
      the slice size I; the cross-slice phase only ever sees m/I).
    * all_gather: the foreign shards pulled across —
      ``payload * (D-1) / n``.
    * reduce_scatter: the partial shard shipped across —
      ``payload / I * (D-1) / D``.
    """
    pairs = tuple((str(a), int(s)) for a, s in pairs)
    if len(pairs) != 2:
        raise ValueError(f"need a 2-axis tuple, got {pairs}")
    (_, d), (_, i) = pairs
    n = d * i
    m = float(nbytes)
    if collective == "allreduce":
        return m / i
    if collective == "all_gather":
        return m * (d - 1) / n
    if collective == "reduce_scatter":
        return m / i * (d - 1) / d
    raise ValueError(
        f"{collective!r} has no hierarchical composition; known: "
        f"{tuple(_COMPOSITIONS)}"
    )


def flat_dcn_bytes(collective: str, nbytes: int, n: int) -> float:
    """What a topology-blind FLAT schedule exposes to the slow axis:
    the bandwidth-optimal per-device wire volume ``payload * (n-1)/n``
    (for allreduce that is the reduce-scatter phase alone — the
    allgather phase crosses again, so the bound is conservative), all
    of which a flat ring/halving schedule routes over whichever links
    the flattened order hands it, DCN hops included."""
    if collective not in _COMPOSITIONS:
        raise ValueError(
            f"{collective!r} has no hierarchical composition; known: "
            f"{tuple(_COMPOSITIONS)}"
        )
    return float(nbytes) * (n - 1) / n


def mesh_shape_label(pairs: tuple[tuple[str, int], ...] | None) -> str:
    """The crossover table's mesh-shape cell: ``2x(4)`` for a keyed
    (dcn=2, ici=4) tuple — slow axis outside the parentheses, slice
    shape inside (the multislice convention) — or ``flat`` when the
    entry carries no axis tuple."""
    if not pairs:
        return "flat"
    return f"{pairs[0][1]}x({'x'.join(str(s) for _, s in pairs[1:])})"
