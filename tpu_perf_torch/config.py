"""Run configuration for this package's ``run`` slice.

Defaults and validation messages are the JAX package's
(``tpu_perf/config.py``): iters 10 (mpi_perf.c:15), buffer 456131 bytes
(mpi_perf.c:14), one run, the same payload dtypes and fence names.  The
additions are the sim world's rank count and the device.
"""

from __future__ import annotations

import dataclasses
import uuid as _uuid

from tpu_perf_torch.sweep import DEF_BUF_SZ

#: mpi_perf.c:15 — default number of messages per run.
DEF_ITERS = 10
#: mpi_perf.c:16 — log-rotation period, seconds.
LOG_REFRESH_TIME_SEC = 900
#: mpi_perf.c:564 — a min/max/avg heartbeat goes to stderr every this many runs.
STATS_EVERY_RUNS = 1000
#: ranks of the single-card sim world (the JAX tests' 8 virtual devices)
DEF_SIM_RANKS = 8

#: payload dtypes supported by the kernels
SUPPORTED_DTYPES = ("float32", "bfloat16", "float16", "int32", "uint8")

#: how a timed call is fenced (tpu_perf_torch.timing).  The names are the
#: JAX package's; ``fused`` and ``auto`` are not ported yet.
FENCE_MODES = ("block", "readback", "slope", "trace", "fused", "auto")
_UNPORTED_FENCES = ("fused", "auto")


def new_job_id() -> str:
    """Random UUID string, the reference's uuid_generate/unparse
    (mpi_perf.c:335-338)."""
    return str(_uuid.uuid4())


@dataclasses.dataclass
class Options:
    """One benchmark invocation's configuration."""

    logfolder: str | None = None      # -l
    iters: int = DEF_ITERS            # -i
    buff_sz: int = DEF_BUF_SZ         # -b
    num_runs: int = 1                 # -r
    uuid: str = dataclasses.field(default_factory=new_job_id)
    op: str = "pl_allreduce"          # the slice's main path
    sweep: str | None = None          # e.g. "8:1G"; None = single buff_sz point
    dtype: str = "float32"
    log_refresh_sec: int = LOG_REFRESH_TIME_SEC
    stats_every: int = STATS_EVERY_RUNS
    warmup_runs: int = 1              # run 0 skipped as warm-up (mpi_perf.c:545)
    fence: str = "block"              # FENCE_MODES
    sim_ranks: int = DEF_SIM_RANKS    # --sim-ranks
    device: str | None = None         # None = "cuda"; "cpu" only when asked

    def __post_init__(self) -> None:
        if self.iters <= 0:
            raise ValueError(f"iters must be positive, got {self.iters}")
        if self.buff_sz <= 0:
            raise ValueError(f"buff_sz must be positive, got {self.buff_sz}")
        if self.num_runs == -1:
            raise ValueError(
                "daemon mode (-r -1) is not yet ported; see ROADMAP")
        if self.num_runs <= 0:
            raise ValueError(f"num_runs must be positive or -1, got {self.num_runs}")
        if self.fence not in FENCE_MODES:
            raise ValueError(
                f"fence must be one of {'|'.join(FENCE_MODES)}, got {self.fence!r}"
            )
        if self.fence in _UNPORTED_FENCES:
            raise ValueError(
                f"fence {self.fence!r} is not yet ported; see ROADMAP")
        if self.dtype not in SUPPORTED_DTYPES:
            raise ValueError(
                f"unsupported dtype {self.dtype!r}; supported: {SUPPORTED_DTYPES}"
            )
        if self.sim_ranks < 1:
            raise ValueError(
                f"sim_ranks must be >= 1, got {self.sim_ranks}")
        if self.device not in (None, "cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}")
