"""Crossover auto-tuner (port of ``tpu_perf/tuner``): the measure→select
loop closed — `tpu-perf-torch tune` folds arena verdicts into a
versioned selection artifact, `--algo auto` resolves every sweep point
against it at plan time, and `tune --check` gates CI on crossover
drift.  The JAX package's fleet merge of per-host winner tables comes
with the fleet subsystem.  Deterministic zone: everything here is a
pure function of artifact bytes + injected coordinates (no clock, no
rank)."""

from tpu_perf_torch.tuner.artifact import (
    TUNER_SCHEMA_VERSION,
    DriftFinding,
    LoadedSelection,
    SelectionArtifact,
    SelectionEntry,
    TuneRecord,
    build_selection,
    check_drift,
    current_device_kind,
    load_artifact,
    read_artifact,
    write_artifact,
)

__all__ = [
    "TUNER_SCHEMA_VERSION",
    "DriftFinding",
    "LoadedSelection",
    "SelectionArtifact",
    "SelectionEntry",
    "TuneRecord",
    "build_selection",
    "check_drift",
    "current_device_kind",
    "load_artifact",
    "read_artifact",
    "write_artifact",
]
