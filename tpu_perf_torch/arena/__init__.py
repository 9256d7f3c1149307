"""Collective-algorithm arena (port of ``tpu_perf/arena``): hand-built
decompositions raced against the native library call.  They are built
from point-to-point permutations (:mod:`tpu_perf_torch.arena.spmd`), so
the race isolates the algorithm; no hand-written kernel is involved."""

from tpu_perf_torch.arena.algorithms import (  # noqa: F401
    ALGORITHM_NAMES,
    ARENA_ALGORITHMS,
    ARENA_COLLECTIVES,
    NATIVE_ALGO,
    ArenaAlgorithm,
    algorithms_for,
    algos_for_op,
    arena_body_builder,
    is_compatible,
)
from tpu_perf_torch.arena.valgos import (  # noqa: F401
    V_ALGORITHMS,
    VHIER_PREFIX,
    VAlgorithm,
    a2av_wire_elems,
    allgatherv_wire_elems,
    is_vhier,
    resolve_vhier,
    seg_wire_elems,
    v_algorithms_for,
    v_algos_for_op,
    v_body_builder_for,
    v_is_compatible,
    vhier_algos_for,
    vhier_body_builder,
    vhier_wire_elems,
)
from tpu_perf_torch.arena.hierarchy import (  # noqa: F401
    HIER_ALGORITHMS,
    HierAlgorithm,
    axis_bytes,
    dcn_bound_bytes,
    flat_dcn_bytes,
    hier_algos_for,
    hier_axis_pairs,
    hier_bases_for,
    hier_body_builder,
    hier_inners,
    is_hier,
    is_hier_compatible,
    mesh_shape_label,
    phase_traffic,
    resolve_hier,
)
