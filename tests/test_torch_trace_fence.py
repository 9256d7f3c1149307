"""The trace fence on the device's own clock, the profiler's windows, and
a failing ``chip_smoke.py`` that names its phase.

Each leg of a trace pair is one CUDA graph with its start and end events
inside it (``timing.TraceRunner``).  With ``torch.cuda`` stubbed by a
recorder, a measured pair must be one replay a leg and one fence, with no
event recorded and no step launched by the host between a leg's events:
a host stall then cannot enter a leg.  No card is needed.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

from tpu_perf_torch import timing, traceparse

REPO = Path(__file__).resolve().parent.parent


class _Recorder:
    """A stand-in for the CUDA calls of the trace fence: it logs each
    call, and a graph replay stamps the events recorded in its capture
    with the device times ``durations[leg]`` apart."""

    def __init__(self, durations):
        self.log = []
        self.durations = durations
        self.capturing = None
        self.clock = 0.0

    def install(self, monkeypatch):
        rec = self

        class Event:
            def __init__(self, enable_timing=False, external=False):
                assert enable_timing and external
                self.t = None

            def record(self, stream=None):
                rec.log.append(("record", rec.capturing))
                assert rec.capturing is not None, "an event outside a graph"
                rec.capturing.events.append(self)

            def elapsed_time(self, other):
                rec.log.append(("elapsed",))
                return other.t - self.t

        class CUDAGraph:
            def __init__(self):
                self.events = []
                self.leg = None

            def replay(self):
                rec.log.append(("replay", self.leg))
                start, end = self.events
                start.t = rec.clock
                rec.clock += rec.durations[self.leg][0]
                end.t = rec.clock
                rec.durations[self.leg].append(
                    rec.durations[self.leg].pop(0))

        @contextlib.contextmanager
        def graph(g, pool=None, stream=None):
            assert pool is not None and stream is not None
            rec.capturing = g
            rec.log.append(("capture",))
            yield
            rec.log.append(("captured",))
            rec.capturing = None

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        @contextlib.contextmanager
        def stream(s):
            yield

        def spin(cycles):
            rec.log.append(("spin", rec.capturing))

        for name, value in dict(
                Event=Event, CUDAGraph=CUDAGraph, graph=graph, Stream=Stream,
                _sleep=spin,
                stream=stream, current_stream=lambda device=None: Stream(),
                synchronize=lambda device=None: rec.log.append(("sync",)),
                memory_reserved=lambda device=None: 0,
                empty_cache=lambda: None,
                graph_pool_handle=lambda: object()).items():
            monkeypatch.setattr(torch.cuda, name, value)

    def step(self, leg):
        def run(x):
            self.log.append(("step", leg))
            if self.capturing is not None:
                self.capturing.leg = leg
            return x
        return run


class _CardTensor:
    is_cuda = True
    device = "cuda:0"


def _runner(monkeypatch, durations, iters=(5, 20)):
    rec = _Recorder(durations)
    rec.install(monkeypatch)
    runner = timing.TraceRunner(rec.step("lo"), rec.step("hi"), _CardTensor(),
                                *iters)
    return rec, runner


def test_a_trace_visit_puts_no_host_call_inside_a_leg(monkeypatch):
    # lo takes 1 ms of device time, hi 3 ms, at 5 and 20 executions
    rec, runner = _runner(monkeypatch, {"lo": [1.0], "hi": [3.0]})
    runner.warm()
    # the warm-up: one eager run of each leg, then each leg captured: its
    # lead-in spin, then the leg between its own two events; then one
    # unrecorded pair of replays
    captures = rec.log[rec.log.index(("step", "hi")) + 1:]
    assert rec.log[:2] == [("step", "lo"), ("step", "hi")]
    for leg in ("lo", "hi"):
        i = captures.index(("capture",))
        g = runner._graphs[leg][0]
        assert captures[i:i + 6] == [
            ("capture",), ("spin", g), ("record", g), ("step", leg),
            ("record", g), ("captured",)]
        captures = captures[i + 6:]
    assert captures == [("replay", "lo"), ("replay", "hi"), ("sync",)]
    for visit in range(3):
        rec.log.clear()
        per_exec = runner.sample()
        # one replay a leg, one fence after both, then the events' reads:
        # no event recorded and no step launched by the host
        assert rec.log == [("replay", "lo"), ("replay", "hi"), ("sync",),
                           ("elapsed",), ("elapsed",)]
        assert per_exec == pytest.approx((3.0 - 1.0) * 1e-3 / 15)
    assert runner.pairs == 3


def test_a_stall_around_a_replay_stays_out_of_the_leg(monkeypatch):
    # a stall wraps the lo leg's one host call, its replay: the legs are
    # read from the events the replays stamped, so the slope is the same
    rec, runner = _runner(monkeypatch, {"lo": [1.0], "hi": [3.0]})
    runner.warm()
    plain = runner.replay

    def stalled(leg):
        if leg == "lo":
            rec.clock += 50.0  # host time: the device clock runs on
        plain(leg)
        if leg == "lo":
            rec.clock += 50.0

    runner.replay = stalled
    assert runner.pair() == pytest.approx((1e-3, 3e-3))


def test_a_non_positive_trace_pair_still_raises(monkeypatch):
    # on the device clock a longer leg cannot be faster: the guard stays
    rec, runner = _runner(monkeypatch, {"lo": [1.0, 4.0], "hi": [3.0, 3.0]})
    runner.warm()
    with pytest.raises(RuntimeError, match="pair 0 is non-positive"):
        runner.sample()


def test_time_trace_frees_its_graphs_after_its_pairs(monkeypatch):
    rec = _Recorder({"lo": [1.0], "hi": [2.0]})
    rec.install(monkeypatch)
    closed = []
    monkeypatch.setattr(timing.TraceRunner, "close",
                        lambda self: closed.append(self.pairs))
    times = timing.time_trace(rec.step("lo"), rec.step("hi"), _CardTensor(),
                              5, 20, 4, warmup_runs=2)
    assert times.samples == pytest.approx([1e-3 / 15] * 4)
    assert closed == [4]
    # two unrecorded pairs in the warm-up, four measured
    assert rec.log.count(("replay", "lo")) == 6


def test_the_trace_runner_needs_a_card_and_two_trip_counts():
    with pytest.raises(ValueError, match="CUDA"):
        timing.TraceRunner(lambda x: x, lambda x: x, torch.zeros(2), 5, 20)
    with pytest.raises(ValueError, match="iters_hi > iters_lo"):
        timing.TraceRunner(lambda x: x, lambda x: x, _CardTensor(), 5, 5)


def test_a_profiled_window_holds_what_ran_in_it(tmp_path):
    with traceparse.profile_window(str(tmp_path), "w",
                                   torch.device("cpu")) as path:
        torch.ones(64).sum()
    names = {e.get("name") for e in traceparse.read_events(path)}
    assert "aten::sum" in names
    with pytest.raises(traceparse.TraceUnavailableError):
        traceparse.device_summary(path)


# --- chip_smoke.py names the phase that failed ------------------------------


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["phase_build", "phase_daemon"])
def test_a_failing_phase_is_named_and_the_run_prints_no_result(
        monkeypatch, capsys, phase):
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(smoke, "card_rates", lambda: (3.35e12, 67e12))
    ran = []
    order = ["phase_build", "phase_check", "phase_main_path", "phase_fused",
             "phase_fences", "phase_profile", "phase_daemon"]
    for name in order:
        def stub(name=name):
            ran.append(name)
            if name == phase:
                smoke.fail("a kernel disagreed\nsecond line of the message")
            return {} if name in ("phase_build", "phase_main_path") else None
        monkeypatch.setattr(smoke, name, stub)
    assert smoke.main() == 1
    out, err = capsys.readouterr()
    assert ran == order[:order.index(phase) + 1]
    short = phase.removeprefix("phase_").replace("main_path", "paths")
    lines = out.splitlines()
    assert lines[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert lines[-1].startswith(f"chip_smoke: FAILED in phase {short} after ")
    assert lines[-1].endswith(
        "s: RuntimeError: chip_smoke: a kernel disagreed")
    assert '"ok": true' not in out and '"kernels"' not in out
    assert "Traceback" in err and "second line of the message" in err


def test_a_smoke_without_a_card_fails_before_any_phase(monkeypatch, capsys):
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "phase_build", lambda: pytest.fail("ran"))
    assert smoke.main() == 1
    out, _ = capsys.readouterr()
    assert out == ""


def test_the_smoke_prints_its_phases_failure_not_a_setup_failure(
        monkeypatch, capsys):
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_smi():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(smoke, "card_line", no_smi)
    assert smoke.main() == 1
    out, _ = capsys.readouterr()
    assert out.startswith("chip_smoke: FAILED in phase setup after ")
    assert "FileNotFoundError: nvidia-smi" in out
    assert io.StringIO(out).read().count("\n") == 1
