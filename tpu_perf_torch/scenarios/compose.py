"""Scenario composition: a phase sequence compiled into ONE step (port of
``tpu_perf/scenarios/compose.py``).

The composition layer turns a declarative :class:`~tpu_perf_torch.
scenarios.spec.ScenarioSpec` into a measurement step with the exact
``build_op`` / ``BuiltOp`` carry contract: the phases are chained inside
one body (each phase reads the window the previous one wrote, so none can
be skipped or reordered), the step runs ``iters`` chained executions, and
the returned :class:`BuiltOp` drops into every fence, adaptive stopping,
spans, chaos and skew unchanged.  Under ``--fence fused`` the whole step
is one CUDA graph replay.  The driver sweeps a scenario as just another
``(op, algo, nbytes, ...)`` point: ``op`` is the literal ``"scenario"``,
``algo`` carries the scenario name (plus the per-phase arena inner,
``moe-dispatch-combine+ring``).

**Sizing.**  The row's ``nbytes`` is the per-rank working buffer (the
``reduce_scatter`` convention), rounded up to the scenario quantum ``n *
imbalance``; each phase works on the first ``size_frac`` of the buffer,
floored to the quantum.

**Per-phase attribution.**  :func:`phase_plan` prices each phase's
per-rank wire bytes with the bandwidth-optimal models, the share of the
measured step each phase accounts for.

**Per-phase algorithm selection.**  ``--algo <inner>`` swaps every phase
whose (op, inner) pair is registered in the flat arena catalog onto that
schedule; the other phases keep their own, and the label carries
``+<inner>``.
"""

from __future__ import annotations

import torch

from tpu_perf_torch.arena import spmd
from tpu_perf_torch.scenarios import vops
from tpu_perf_torch.scenarios.spec import PhaseSpec, ScenarioSpec
from tpu_perf_torch.topology import ring_permutation

#: the op-column spelling every scenario row carries; decorate_op folds
#: the scenario name in from the algo column (``scenario[<name>]``)
SCENARIO_OP = "scenario"

#: scenario labels join name and per-phase inner with this (the name
#: grammar forbids it, so the split is unambiguous)
_INNER_SEP = "+"


def scenario_algo_label(spec: ScenarioSpec, inner: str = "native") -> str:
    """The algo-column label of one scenario point: the bare name for
    the native composition, ``<name>+<inner>`` under a per-phase arena
    inner."""
    if inner in ("", "native"):
        return spec.name
    return f"{spec.name}{_INNER_SEP}{inner}"


def split_scenario_label(label: str) -> tuple[str, str]:
    """``(name, inner)`` of a scenario algo label."""
    name, _, inner = str(label).partition(_INNER_SEP)
    return name, inner or "native"


def spec_for_label(specs, label: str) -> ScenarioSpec:
    """Resolve a plan slot's algo label back to its spec (the driver's
    build path holds the resolved specs on Options)."""
    name, _ = split_scenario_label(label)
    for s in specs or ():
        if s.name == name:
            return s
    raise ValueError(
        f"no scenario named {name!r} in this job's selection "
        f"({[s.name for s in specs or ()]})"
    )


def scenario_algos_for(opts, n_devices: int | None = None,
                       err=None) -> list[str]:
    """The plan's algo-coordinate expansion for the scenario op: one
    label per selected scenario, validated against ``--algo``.  A
    scenario's ``--algo`` names ONE per-phase inner from the flat arena
    catalog (or ``native``) — families/``all``/hier spellings are loud
    errors, and a pow2-only inner on an incompatible device count fails
    HERE, at plan time, before any kernel has run (the
    algos_for_options contract; ``n_devices`` is the collective axis
    size when the caller knows it — build_scenario_op re-checks)."""
    from tpu_perf_torch.arena import ALGORITHM_NAMES
    from tpu_perf_torch.arena.algorithms import POW2_ONLY
    from tpu_perf_torch.arena.hierarchy import is_hier

    inner = opts.algo
    if inner == "all" or "," in inner:
        raise ValueError(
            f"--algo {inner!r} is not valid for scenarios: a scenario "
            "races ONE per-phase inner per job (run the job once per "
            "inner to race them)"
        )
    if is_hier(inner):
        raise ValueError(
            f"--algo {inner!r} is a hierarchical composition; scenario "
            "phases run over the single collective axis and accept the "
            f"flat catalog inners {ALGORITHM_NAMES} (or native)"
        )
    if inner != "native" and inner not in ALGORITHM_NAMES:
        raise ValueError(
            f"unknown scenario inner algorithm {inner!r}; known: "
            f"{ALGORITHM_NAMES} (or native)"
        )
    if (inner in POW2_ONLY and n_devices is not None
            and n_devices & (n_devices - 1)):
        raise ValueError(
            f"scenario inner {inner!r} needs a power-of-two device "
            f"count (recursive halving/doubling pairs ranks by XOR), "
            f"got {n_devices}"
        )
    if inner == "native":
        return [scenario_algo_label(s) for s in opts.scenario]
    # the loud-inert-knob contract, per scenario: an inner that covers
    # NONE of a scenario's phases compiles the byte-identical native
    # composition, so labeling it +inner would publish a duplicate
    # curve (and a phantom crossover race) under a distinct name —
    # those scenarios keep the bare native label with a note (the
    # imbalance-collapse precedent), and a selection where NO scenario
    # covers the inner is a hard error
    import sys as _sys

    out, covered_any = [], False
    for s in opts.scenario:
        if scenario_inner_covered(s, inner):
            covered_any = True
            out.append(scenario_algo_label(s, inner))
        else:
            print(f"[tpu-perf-torch] scenario {s.name} has no phase with a "
                  f"registered {inner!r} decomposition (phases "
                  f"{[p.op for p in s.phases]}): running the native "
                  f"composition under its bare label",
                  file=err if err is not None else _sys.stderr)
            out.append(scenario_algo_label(s))
    if not covered_any:
        raise ValueError(
            f"--algo {inner!r} covers no phase of any selected "
            f"scenario ({[s.name for s in opts.scenario]}); the inner "
            f"would decorate labels while changing nothing"
        )
    return out


def scenario_inner_covered(spec: ScenarioSpec, inner: str) -> bool:
    """True when at least one phase of ``spec`` has a registered
    (phase op, inner) decomposition in the flat arena catalog — the
    one predicate deciding whether an inner actually changes the
    compiled program."""
    from tpu_perf_torch.arena.algorithms import ARENA_ALGORITHMS

    return any((p.op, inner) in ARENA_ALGORITHMS for p in spec.phases)


def scenario_quantum(n: int, imbalance: int) -> int:
    """The element quantum every scenario buffer/window is rounded to:
    ``n * ratio`` satisfies every phase's granularity at once (block
    splits by n, v-variant counts, a2av hot-block layouts)."""
    return n * max(1, int(imbalance))


def scenario_elems(nbytes: int, n: int, itemsize: int,
                   imbalance: int) -> tuple[int, int]:
    """Per-device element count (and actual nbytes) for a scenario
    point — requested size rounded UP to the quantum, the
    ``payload_elems`` rounding convention."""
    q = scenario_quantum(n, imbalance)
    want = max(1, -(-int(nbytes) // itemsize))
    elems = -(-want // q) * q
    return elems, elems * itemsize


def _windows(spec: ScenarioSpec, elems: int, n: int,
             imbalance: int) -> list[tuple[PhaseSpec, int]]:
    """Each phase's working window ``k``: ``size_frac`` of the buffer,
    floored to the quantum (never below one quantum)."""
    q = scenario_quantum(n, imbalance)
    out = []
    for phase in spec.phases:
        k = max(q, int(elems * phase.size_frac) // q * q)
        out.append((phase, k))
    return out


def _phase_wire_elems(phase: PhaseSpec, k: int, n: int,
                      imbalance: int) -> float:
    """Modeled per-device wire elements of ONE execution of the phase
    over a ``k``-element window (bandwidth-optimal schedules, mean over
    ranks where per-rank volume is uneven) — the attribution model."""
    if phase.op == "allreduce":
        return 2.0 * k * (n - 1) / n
    if phase.op == "all_gather":
        return float(k) * (n - 1)
    if phase.op in ("reduce_scatter", "all_to_all"):
        return float(k) * (n - 1) / n
    if phase.op == "ppermute":
        return float(k)
    if phase.op in ("allgatherv", "reduce_scatter_v"):
        counts = _v_window_counts(phase.op, k, n, imbalance)[0]
        return sum(counts) * (n - 1) / n
    # all_to_all_v: each rank ships (n-1) of its own blocks one way
    blocks, _ = vops.a2av_layout(k, n, imbalance)
    return sum(blocks) * (n - 1) / n


def _v_window_counts(op: str, k: int, n: int, imbalance: int):
    """Counts/offsets of a v-variant phase fitted INSIDE a k-element
    window (the standalone kernels size the buffer from the row's
    nbytes; a phase sizes itself from its window)."""
    weights = vops.imbalance_weights(n, imbalance)
    if op == "allgatherv":
        # contribution = the valid prefix; the max count must fit the
        # window (the carry-back slice is max-count wide)
        c = k // max(weights)
    else:  # reduce_scatter_v: the whole concatenated input must fit
        c = k // sum(weights)
    if c < 1:
        raise ValueError(
            f"{op} phase window of {k} elements is too small for "
            f"imbalance {imbalance} on {n} ranks"
        )
    counts = tuple(c * w for w in weights)
    offsets = tuple(sum(counts[:r]) for r in range(n))
    return counts, offsets


def phase_plan(spec: ScenarioSpec, nbytes: int, n: int, *,
               itemsize: int = 4, imbalance: int = 1) -> list[dict]:
    """The attribution model report renders: one entry per phase with
    its window, repeat count, modeled per-device wire bytes (x repeat),
    and share of the scenario's total modeled wire volume."""
    elems, _ = scenario_elems(nbytes, n, itemsize, imbalance)
    entries = []
    for phase, k in _windows(spec, elems, n, imbalance):
        wire = _phase_wire_elems(phase, k, n, imbalance) * itemsize \
            * phase.repeat
        entries.append({
            "phase": phase.label,
            "op": phase.op,
            "repeat": phase.repeat,
            "window_bytes": k * itemsize,
            "wire_bytes": wire,
        })
    total = sum(e["wire_bytes"] for e in entries)
    for e in entries:
        e["share"] = e["wire_bytes"] / total if total else 0.0
    return entries


def _phase_fn(phase: PhaseSpec, rk, axis, n: int, k: int, imbalance: int,
              inner: str, dtype: torch.dtype):
    """The per-rank transform of one phase over its ``(rows, k)`` window;
    every rank runs the same program."""
    from tpu_perf_torch.arena.algorithms import (
        _A2A, _ALLGATHER, _SUM_ALLREDUCE, _SUM_REDUCE_SCATTER,
    )

    inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)

    def use(table):
        # an inner the catalog lacks for this phase keeps the native one
        return table.get(inner) if inner != "native" else None

    if phase.op == "allreduce":
        fn = use(_SUM_ALLREDUCE)

        def run(y):
            s = fn(y, rk, axis, n) if fn else rk.psum(y, axis)
            return s * inv

    elif phase.op == "all_gather":
        fn = use(_ALLGATHER)

        def run(y):
            g = fn(y, rk, axis, n) if fn else rk.all_gather(y, axis)
            # carry the own window back, the native body's contract
            return spmd.dslice(g, rk.axis_index(axis) * k, k)

    elif phase.op == "reduce_scatter":
        fn = use(_SUM_REDUCE_SCATTER)
        shard = k // n

        def run(y):
            s = fn(y, rk, axis, n) if fn else rk.psum_scatter(y, axis)
            return spmd.dupdate(y, s * inv, rk.axis_index(axis) * shard)

    elif phase.op == "all_to_all":
        fn = use(_A2A)

        def run(y):
            return fn(y, rk, axis, n) if fn else rk.all_to_all(y, axis)

    elif phase.op == "ppermute":
        perm = ring_permutation(n)

        def run(y):
            return rk.ppermute(y, axis, perm)

    elif phase.op == "allgatherv":
        counts, offsets = _v_window_counts(phase.op, k, n, imbalance)
        width = max(counts)

        def run(y):
            g = vops.gatherv(y, rk, axis, n, counts, offsets)
            own = vops.own_window(g, rk, offsets, width, axis)
            return torch.cat([own, y[:, width:]], dim=1)

    elif phase.op == "reduce_scatter_v":
        counts, offsets = _v_window_counts(phase.op, k, n, imbalance)
        total = sum(counts)

        def run(y):
            acc = vops.reduce_scatter_v_sum(y[:, :total].contiguous(), rk,
                                            axis, n, counts, offsets)
            return vops.write_back_own_block(y, acc * inv, counts, offsets,
                                             rk, axis)

    else:  # all_to_all_v
        blocks, roffs = vops.a2av_layout(k, n, imbalance)
        inverse = phase.inverse

        def run(y):
            return vops.a2av(y, rk, axis, n, blocks, roffs, inverse=inverse)

    return run


#: scenario phase ops that reduce their payload (need a float dtype, the
#: FLOAT_ONLY_OPS contract judged per spec)
_REDUCING_PHASES = frozenset({"allreduce", "reduce_scatter",
                              "reduce_scatter_v"})


def build_scenario_op(spec: ScenarioSpec, world, nbytes: int, iters: int, *,
                      dtype: str = "float32", imbalance: int = 1,
                      inner: str = "native", reuse_input=None):
    """One scenario point as a :class:`~tpu_perf_torch.ops.collectives.
    BuiltOp`: every phase chained inside the step's body, ``iters``
    chained steps, the make_fill example input (the sim world's rows, or
    this rank's buffer across processes)."""
    from tpu_perf_torch.arena.algorithms import ALGORITHM_NAMES, POW2_ONLY
    from tpu_perf_torch.arena.spmd import Ranks
    from tpu_perf_torch.ops.collectives import (
        DTYPES, BuiltOp, chained, check_reuse, example_input,
        is_float_dtype,
    )
    from tpu_perf_torch.world import is_dist

    if iters <= 0:
        raise ValueError(f"iters must be positive, got {iters}")
    axes = tuple(world.axis_names)
    if len(axes) != 1:
        raise ValueError(
            f"scenario steps compose single-axis collective phases and "
            f"need one mesh axis, got {axes} (name one with --axes, "
            f"like the pairwise ops)"
        )
    n = world.n
    if inner != "native" and inner not in ALGORITHM_NAMES:
        raise ValueError(
            f"unknown scenario inner algorithm {inner!r}; known: "
            f"{ALGORITHM_NAMES} (or native)"
        )
    if inner in POW2_ONLY and n & (n - 1):
        raise ValueError(
            f"scenario inner {inner!r} needs a power-of-two device "
            f"count (recursive halving/doubling pairs ranks by XOR), "
            f"got {n}"
        )
    if inner != "native" and not scenario_inner_covered(spec, inner):
        raise ValueError(
            f"scenario {spec.name!r} has no phase with a registered "
            f"{inner!r} decomposition (phases "
            f"{[p.op for p in spec.phases]}); the inner would label a "
            f"byte-identical native composition"
        )
    if int(imbalance) != imbalance or imbalance < 1:
        raise ValueError(
            f"imbalance ratio must be an integer >= 1, got {imbalance!r}"
        )
    if imbalance > 1 and not spec.uses_imbalance:
        raise ValueError(
            f"scenario {spec.name!r} has no v-variant phase; imbalance "
            f"{imbalance} would decorate rows while changing nothing "
            f"(the loud-inert-knob contract)"
        )
    if (any(p.op in _REDUCING_PHASES for p in spec.phases)
            and not is_float_dtype(dtype)):
        raise ValueError(
            f"scenario {spec.name!r} reduces its payload "
            f"(phases {[p.op for p in spec.phases]}) and needs a float "
            f"dtype, got {dtype}"
        )
    itemsize = DTYPES[dtype].itemsize
    elems, actual_nbytes = scenario_elems(nbytes, n, itemsize, imbalance)
    rk = Ranks(world)
    axis = axes[0]
    phase_fns = [
        (_phase_fn(phase, rk, axis, n, k, imbalance, inner, DTYPES[dtype]),
         k, phase.repeat)
        for phase, k in _windows(spec, elems, n, imbalance)
    ]

    def body(x):
        # phases chained on the carry: each reads the window the previous
        # one wrote
        for fn, k, repeat in phase_fns:
            for _ in range(repeat):
                y = fn(x[:, :k])
                x = torch.cat([y, x[:, k:]], dim=1) if k < x.shape[1] else y
        return x

    if is_dist(world):
        step = chained(body, iters, lambda x: x.view(1, -1),
                       lambda x: x.reshape(-1))
    else:
        step = chained(body, iters)
    x = example_input(world, elems, dtype)
    if reuse_input is not None:
        x = check_reuse(reuse_input, x)
    return BuiltOp(name=SCENARIO_OP, step=step, example_input=x,
                   nbytes=actual_nbytes, n_devices=n, iters=iters,
                   algo=scenario_algo_label(spec, inner),
                   imbalance=int(imbalance))
