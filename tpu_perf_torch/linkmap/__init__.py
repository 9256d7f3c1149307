"""Link-map subsystem (port of ``tpu_perf/linkmap``): per-link probe
sweeps, roofline grading, and sick-link localization.

The triage layer the reference tool exists for — pair endpoints, time
messages, find the sick link — expressed over the mesh: ``plan``
decomposes a named mesh into directed link probes (per-axis neighbor
schedules, or the mpiGraph-style all-pairs tournament), ``probe``
drives them through the timing fences (or the seeded synthetic source)
into an N×N latency/bandwidth matrix, ``grade`` judges every link
against the card's per-direction NVLink roofline and its row/column MAD
peers (``ok | slow | dead``, with the owning coordinates and rank), and
``report`` renders heatmap/markdown/JSON from the durable
``linkmap-*.log`` records.  Across cards a probe is one NVLink
direction; in the single-card sim world it is a memory copy, graded by
its peers alone.
"""

from tpu_perf_torch.linkmap.grade import (  # noqa: F401
    GradeConfig,
    LinkVerdict,
    grade,
    meta_record,
)
from tpu_perf_torch.linkmap.plan import (  # noqa: F401
    LinkProbe,
    Schedule,
    all_links,
    plan_all_pairs,
    plan_mesh_links,
    probe_op_name,
)
from tpu_perf_torch.linkmap.probe import (  # noqa: F401
    LinkmapRecord,
    LinkMapResult,
    LinkProber,
    ProbeResult,
)
from tpu_perf_torch.linkmap.report import (  # noqa: F401
    diff_linkmaps,
    heatmap,
    linkdiff_summary,
    linkdiff_to_markdown,
    linkmap_to_json,
    linkmap_to_markdown,
    load_linkmap_artifact,
    read_linkmap,
    summary_line,
    verdicts_to_markdown,
)
