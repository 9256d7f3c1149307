"""Sick-host drain hook: `fleet report --drain-hook CMD` acts on exit 9
(port of ``tpu_perf/fleet/drain.py``).

The fleet grader names the worst hosts (cross-host MAD, exit 9), but a
verdict that only exits non-zero still needs a human in the loop before
the scheduler stops placing work on a sick host.  The drain hook closes
that gap: for every host the grading flagged, the operator-supplied
command runs once with the host name appended as one shell-quoted
argument (and in ``TPU_PERF_SICK_HOST``), so

    tpu-perf-torch fleet report /fleet --drain-hook 'kubectl drain'

invokes ``kubectl drain host-c`` the moment host-c grades sick.

Safety posture — the hook talks to a scheduler, so it is the one place
this harness mutates the outside world:

* **rate-limited per host**: a ``.drain-state.json`` sidecar in the
  fleet root records each host's last invocation; within
  ``--drain-interval`` (default 1 h) the hook is skipped with a note —
  a cron'd report must not re-drain a host every five minutes.  The
  limit covers failures too (a broken hook hammered every pass helps
  nobody); the state updates whenever the command RUNS.
* **observable**: each execution is a ``drain_hook`` span (when the
  report writes spans), a ``drain`` record in the fleet-*.log rollup,
  and — on failure — a ``drain_fail`` health event, so "did the drain
  actually happen" is queryable next to the verdict that triggered it.
* **never fatal**: a failing hook is reported (and health-evented);
  the report's own verdict and exit code are unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
import subprocess
import sys
import time

from tpu_perf_torch.spans import NULL_TRACER

#: per-fleet rate-limit state, next to the host folders (the fleet root
#: is the one durable location every report invocation shares).  Never
#: matches a family scan shape, so no collector ever reads it as data.
DRAIN_STATE_FILE = ".drain-state.json"


@dataclasses.dataclass(frozen=True)
class DrainOutcome:
    """One sick host's drain verdict this pass."""

    host: str
    action: str          # "invoked" | "rate-limited" | "failed"
    rc: int | None = None
    error: str = ""

    def to_record_fields(self) -> dict:
        return {"host": self.host, "action": self.action,
                "rc": self.rc, "error": self.error}


def load_drain_state(root: str) -> dict[str, float]:
    try:
        with open(os.path.join(root, DRAIN_STATE_FILE)) as fh:
            data = json.load(fh)
        return {str(k): float(v) for k, v in data.items()}
    except (OSError, ValueError, AttributeError, TypeError):
        # missing/corrupt state restarts the limiter — worst case one
        # extra drain per host, which the scheduler tolerates (drains
        # are idempotent by contract)
        return {}


def save_drain_state(root: str, state: dict[str, float]) -> None:
    path = os.path.join(root, DRAIN_STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(state, fh, sort_keys=True)
    os.replace(tmp, path)  # atomic: a killed report never tears it


def run_drain_hooks(
    root: str,
    hosts: list[str],
    cmd: str,
    *,
    interval: float = 3600.0,
    now: float | None = None,
    err=None,
    runner=subprocess.run,
    tracer=NULL_TRACER,
    timeout: float = 60.0,
) -> list[DrainOutcome]:
    """Invoke ``cmd <host>`` once per named host, rate-limited per host
    through the fleet root's state sidecar.  ``now``/``runner`` are
    injectable so the schedule and the execution are testable without
    wall clocks or real subprocesses."""
    err = err if err is not None else sys.stderr
    now = time.time() if now is None else now
    state = load_drain_state(root)
    outcomes: list[DrainOutcome] = []
    dirty = False
    for host in sorted(set(hosts)):
        last = state.get(host)
        if last is not None and now - last < interval:
            outcomes.append(DrainOutcome(host=host, action="rate-limited"))
            print(f"tpu-perf-torch: drain hook for {host} rate-limited "
                  f"({now - last:.0f}s since last invocation < "
                  f"{interval:.0f}s interval)", file=err, flush=True)
            continue
        state[host] = now
        dirty = True
        shell_line = f"{cmd} {shlex.quote(host)}"
        t0 = tracer.now() if tracer.enabled else 0
        rc: int | None = None
        error = ""
        try:
            proc = runner(
                ["/bin/sh", "-c", shell_line],
                env={**os.environ, "TPU_PERF_SICK_HOST": host},
                timeout=timeout,
                capture_output=True,
                text=True,
            )
            rc = proc.returncode
            # relay the hook's output to stderr, never inherit stdout:
            # the report's own stdout is a rendered artifact (--format
            # json is parsed downstream), and a chatty drain command
            # must not corrupt it
            for stream_name in ("stdout", "stderr"):
                text = (getattr(proc, stream_name, None) or "").strip()
                if text:
                    for ln in text.splitlines():
                        print(f"tpu-perf-torch: drain hook [{host}] {ln}",
                              file=err, flush=True)
        except Exception as e:  # noqa: BLE001 — a hook that times out
            # or cannot exec is a FAILED drain, reported like a
            # non-zero exit; the report must never die on its hook
            error = str(e)
        if tracer.enabled:
            attrs = {"host": host, "cmd": cmd}
            if rc is not None:
                attrs["rc"] = rc
            if error or rc:
                attrs["error"] = True
            tracer.emit("drain_hook", t0, tracer.now() - t0, **attrs)
        if error or (rc is not None and rc != 0):
            outcomes.append(DrainOutcome(host=host, action="failed",
                                         rc=rc, error=error))
            print(f"tpu-perf-torch: drain hook FAILED for {host}: "
                  f"{error or f'exit {rc}'} ({shell_line!r})",
                  file=err, flush=True)
        else:
            outcomes.append(DrainOutcome(host=host, action="invoked",
                                         rc=rc))
            print(f"tpu-perf-torch: drain hook invoked for {host} "
                  f"({shell_line!r})", file=err, flush=True)
    if dirty:
        try:
            save_drain_state(root, state)
        except OSError as e:
            # a read-only fleet root loses the limiter, not the drain:
            # say so, so a re-drain next pass is explicable
            print(f"tpu-perf-torch: could not persist drain state: {e} "
                  "(rate limiting degraded for this root)",
                  file=err, flush=True)
    return outcomes
