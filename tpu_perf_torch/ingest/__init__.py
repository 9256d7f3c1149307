"""Telemetry ingest pipeline: the kusto_ingest.py workalike (copy of
``tpu_perf/ingest``)."""

from tpu_perf_torch.ingest.pipeline import (  # noqa: F401
    IngestBackend,
    KustoBackend,
    LocalDirBackend,
    NullBackend,
    SubprocessIngest,
    build_backend_from_env,
    eligible_files,
    ingest_command,
    list_quarantined,
    requeue_quarantined,
    run_all_ingest_passes,
    run_ingest_pass,
)
