"""Deterministic fault injection + detector conformance (port of
``tpu_perf/faults``).

The chaos layer that proves the health subsystem detects what it claims
to: ``spec`` (the JSON/CLI fault schedule), ``injector`` (the seeded
per-run perturbation engine the Driver consults), ``conformance`` (the
ledger-vs-events judge behind ``tpu-perf-torch chaos verify``).
"""

from tpu_perf_torch.faults.conformance import (  # noqa: F401
    ConformanceReport,
    read_ledger,
    report_to_json,
    report_to_markdown,
    run_conformance,
)
from tpu_perf_torch.faults.injector import (  # noqa: F401
    FaultInjector,
    InjectedHookFailure,
)
from tpu_perf_torch.faults.spec import (  # noqa: F401
    EXPECTED_EVENT,
    FAULT_KINDS,
    ChaosRecord,
    FaultSpec,
    load_spec,
    parse_fault_arg,
    parse_spec,
)
