"""Model-step scenario engine (port of ``tpu_perf/scenarios``; arXiv
2006.13112): v-variant collectives with per-rank payload imbalance, and a
declarative workload layer that composes collective phases into ONE
measurement step the driver sweeps like any op."""

from tpu_perf_torch.scenarios.compose import (  # noqa: F401
    SCENARIO_OP,
    build_scenario_op,
    phase_plan,
    scenario_algo_label,
    scenario_algos_for,
    scenario_elems,
    spec_for_label,
    split_scenario_label,
)
from tpu_perf_torch.scenarios.spec import (  # noqa: F401
    BUILTIN_SCENARIOS,
    PHASE_OPS,
    PhaseSpec,
    ScenarioSpec,
    load_scenario,
    resolve_scenarios,
    scenario_from_json,
)
from tpu_perf_torch.scenarios.vops import (  # noqa: F401
    IMBALANCE_OPS,
    V_OPS,
    imbalance_weights,
    v_body_builder,
    v_counts,
)
