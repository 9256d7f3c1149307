"""Meshes over a world's ranks and multi-process worlds (port of
``tpu_perf/parallel``)."""

from tpu_perf_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_ranks_flat,
)
from tpu_perf_torch.parallel.multihost import (  # noqa: F401
    allreduce_times,
    exchange_ips,
    initialize_distributed,
    leave_world,
    make_hybrid_mesh,
    share_job_id,
)
