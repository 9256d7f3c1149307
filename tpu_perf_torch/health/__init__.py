"""Streaming estimators (port of ``tpu_perf/health``): for now the running
moments the adaptive stop rule needs (:class:`~tpu_perf_torch.health.stats.Welford`);
the detectors and the exporter come with the rest of the health
subsystem (ROADMAP)."""

from tpu_perf_torch.health.stats import Welford

__all__ = ["Welford"]
