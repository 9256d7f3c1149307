"""Online fleet-health subsystem (port of ``tpu_perf/health``): streaming
baselines, anomaly detection and health-event telemetry for monitor mode.

Every recorded run feeds a per-(op, nbytes, dtype) streaming baseline
(:mod:`stats`), detectors judge each point against its own history
(:mod:`detect`), verdicts become JSONL events riding the rotating-log and
ingest contract (:mod:`events`), and current gauges land in a Prometheus
textfile (:mod:`exporter`).  :class:`HealthMonitor` (:mod:`monitor`) is
the driver-facing facade.
"""

from tpu_perf_torch.health.detect import (  # noqa: F401
    Finding,
    HealthConfig,
    PointDetector,
    capture_loss_finding,
)
from tpu_perf_torch.health.events import (  # noqa: F401
    HealthEvent,
    events_to_json,
    events_to_markdown,
    read_events,
    summarize_events,
)
from tpu_perf_torch.health.exporter import (  # noqa: F401
    PointGauges,
    TextfileExporter,
    render_textfile,
)
from tpu_perf_torch.health.monitor import HealthMonitor  # noqa: F401
from tpu_perf_torch.health.stats import (  # noqa: F401
    EWMA,
    P2Quantile,
    PointBaseline,
    Welford,
)
