"""Declarative model-step scenario specs (port of
``tpu_perf/scenarios/spec.py``; pure Python).

A *scenario* is a named sequence of collective phases — the
communication shape of one model step — that the composition layer
(``tpu_perf_torch.scenarios.compose``) compiles into ONE measurement step
the driver sweeps like any op.  The spec layer is pure data: a
tiny JSON/CLI schema plus the built-in catalog, with every way a spec
can be wrong failing HERE, before anything compiles.

JSON schema (``tpu-perf-torch scenario my-step.json``)::

    {"name": "my-step",
     "summary": "optional one-liner",
     "phases": [{"op": "allreduce", "repeat": 4, "size_frac": 1.0},
                {"op": "all_to_all_v", "inverse": true}]}

Phase ops: the balanced collectives (``allreduce`` / ``all_gather`` /
``reduce_scatter`` / ``all_to_all`` — native lowering or, under
``--algo``, a registered arena decomposition), the pipeline hop
(``ppermute``, one +1 ring shift), and the v-variants
(``allgatherv`` / ``reduce_scatter_v`` / ``all_to_all_v`` — per-rank
payloads drawn from the scenario point's imbalance ratio;
``inverse: true`` flips ``all_to_all_v`` into the combine direction).
``size_frac`` scales the phase's working window as a fraction of the
scenario's per-device buffer; ``repeat`` chains the phase that many
times (the "x L layers" knob).

Scenario names become the point's algo coordinate (rows read
``op=scenario, algo=<name>``; health/fleet key on the decorated
``scenario[<name>]`` label via ``schema.decorate_op``), so the grammar
forbids the label delimiters.
"""

from __future__ import annotations

import dataclasses
import json

#: every phase op the composition layer implements
PHASE_OPS = ("allreduce", "all_gather", "reduce_scatter", "all_to_all",
             "ppermute", "allgatherv", "reduce_scatter_v", "all_to_all_v")

#: phase ops whose per-rank payloads follow the imbalance ratio
V_PHASE_OPS = ("allgatherv", "reduce_scatter_v", "all_to_all_v")

#: characters a scenario name must not contain — they are the decorated
#: label grammar's delimiters (schema.decorate_op / parse_op_label) and
#: the scenario label's own inner separator
_NAME_FORBIDDEN = "[]@%&+,:"


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One phase of a scenario: ``repeat`` chained executions of ``op``
    over the first ``size_frac`` of the scenario buffer."""

    op: str
    repeat: int = 1
    size_frac: float = 1.0
    inverse: bool = False  # all_to_all_v only: the combine direction

    def __post_init__(self) -> None:
        if self.op not in PHASE_OPS:
            raise ValueError(
                f"unknown scenario phase op {self.op!r}; known: {PHASE_OPS}"
            )
        if self.repeat < 1:
            raise ValueError(
                f"phase repeat must be >= 1, got {self.repeat}"
            )
        if not 0.0 < self.size_frac <= 1.0:
            raise ValueError(
                f"phase size_frac must be in (0, 1], got {self.size_frac}"
            )
        if self.inverse and self.op != "all_to_all_v":
            raise ValueError(
                f"inverse applies to all_to_all_v (the combine "
                f"direction), not {self.op!r}"
            )

    @property
    def label(self) -> str:
        """The attribution table's phase cell: ``allreduce x4`` /
        ``all_to_all_v^-1``."""
        op = f"{self.op}^-1" if self.inverse else self.op
        return f"{op} x{self.repeat}" if self.repeat > 1 else op


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named scenario: the phase sequence plus its label identity."""

    name: str
    phases: tuple[PhaseSpec, ...]
    summary: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("scenario name must not be empty")
        bad = sorted(set(self.name) & set(_NAME_FORBIDDEN))
        if bad:
            raise ValueError(
                f"scenario name {self.name!r} contains label-grammar "
                f"delimiter(s) {bad} (forbidden: {_NAME_FORBIDDEN!r})"
            )
        if not self.phases:
            raise ValueError(f"scenario {self.name!r} has no phases")
        object.__setattr__(self, "phases", tuple(self.phases))

    @property
    def uses_imbalance(self) -> bool:
        """True when any phase's per-rank payloads follow the imbalance
        ratio (the --imbalance axis is meaningful for this scenario)."""
        return any(p.op in V_PHASE_OPS for p in self.phases)


#: the built-in catalog — the three model-step shapes ROADMAP direction
#: 4 names.  report's per-phase attribution resolves row labels against
#: these (a custom JSON scenario renders its step times without the
#: phase breakdown — the rows alone cannot recover a foreign spec).
BUILTIN_SCENARIOS: dict[str, ScenarioSpec] = {
    "tp-allreduce-burst": ScenarioSpec(
        name="tp-allreduce-burst",
        phases=(PhaseSpec(op="allreduce", repeat=4),),
        summary="tensor-parallel allreduce burst: L=4 chained "
                "full-buffer allreduces (one per transformer layer)",
    ),
    "moe-dispatch-combine": ScenarioSpec(
        name="moe-dispatch-combine",
        phases=(PhaseSpec(op="all_to_all_v"),
                PhaseSpec(op="all_to_all_v", inverse=True)),
        summary="MoE expert routing: imbalanced all-to-all dispatch "
                "(the hot expert receives ratio-x tokens) followed by "
                "the combine returning every block to its source",
    ),
    "pipeline-chain": ScenarioSpec(
        name="pipeline-chain",
        phases=(PhaseSpec(op="ppermute", repeat=4),),
        summary="pipeline-parallel hop chain: 4 sequential +1-ring "
                "ppermute activations (one per pipeline stage boundary)",
    ),
}


def _phase_from_json(data: dict, name: str, i: int) -> PhaseSpec:
    if not isinstance(data, dict) or "op" not in data:
        raise ValueError(
            f"scenario {name!r} phase {i}: expected an object with an "
            f"'op' key, got {data!r}"
        )
    known = {"op", "repeat", "size_frac", "inverse"}
    extra = sorted(set(data) - known)
    if extra:
        raise ValueError(
            f"scenario {name!r} phase {i}: unknown key(s) {extra} "
            f"(known: {sorted(known)})"
        )
    return PhaseSpec(
        op=str(data["op"]),
        repeat=int(data.get("repeat", 1)),
        size_frac=float(data.get("size_frac", 1.0)),
        inverse=bool(data.get("inverse", False)),
    )


def scenario_from_json(data: dict) -> ScenarioSpec:
    """Build one ScenarioSpec from its parsed JSON object."""
    if not isinstance(data, dict):
        raise ValueError(f"scenario spec must be a JSON object, got {data!r}")
    name = str(data.get("name", ""))
    phases = data.get("phases")
    if not isinstance(phases, list):
        raise ValueError(
            f"scenario {name!r}: 'phases' must be a list of phase objects"
        )
    return ScenarioSpec(
        name=name,
        phases=tuple(_phase_from_json(p, name, i)
                     for i, p in enumerate(phases)),
        summary=str(data.get("summary", "")),
    )


def load_scenario(path: str) -> ScenarioSpec:
    """Parse one scenario spec file (IOErrors propagate — Options maps
    them to the loud exit-2 ValueError, the fault-spec contract)."""
    with open(path) as fh:
        try:
            data = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"bad scenario spec {path!r}: {e}") from None
    return scenario_from_json(data)


def resolve_scenarios(items) -> tuple[ScenarioSpec, ...]:
    """Normalize a scenario selection — built-in names, spec-file paths,
    or already-resolved ScenarioSpec objects (idempotent, so
    ``dataclasses.replace`` on Options re-runs cleanly) — into specs.
    Unknown names fail here, loudly, naming the catalog."""
    import os

    out: list[ScenarioSpec] = []
    seen: set[str] = set()
    for item in items:
        if isinstance(item, ScenarioSpec):
            spec = item
        elif item in BUILTIN_SCENARIOS:
            spec = BUILTIN_SCENARIOS[item]
        elif isinstance(item, str) and (item.endswith(".json")
                                        or os.path.isfile(item)):
            try:
                spec = load_scenario(item)
            except OSError as e:
                raise ValueError(f"cannot read scenario spec: {e}") from None
        else:
            raise ValueError(
                f"unknown scenario {item!r}; built-ins: "
                f"{sorted(BUILTIN_SCENARIOS)} (or a spec.json path)"
            )
        if spec.name in seen:
            raise ValueError(
                f"scenario {spec.name!r} named twice in one job (each "
                f"plan slot needs a distinct label)"
            )
        seen.add(spec.name)
        out.append(spec)
    if not out:
        raise ValueError("empty scenario selection")
    return tuple(out)
