"""The trace fence on the device's own clock, the profiler's windows, and
a failing ``chip_smoke.py`` that names its phase.

Each leg of a trace pair is one CUDA graph with its start and end events
inside it (``timing.TraceRunner``), the lo leg behind the trace gate
(``timing.TraceGate``).  With ``torch.cuda`` and the gate stubbed by a
recorder, a measured pair must be one replay a leg, the gate's opening
and one fence, with no event recorded and no step launched by the host
between a leg's events: a host stall then cannot enter a leg.  The
recorder's card starts a graph when its replay is submitted unless a
closed gate holds it, and a host preempted halfway through submitting a
graph that already runs stalls it: behind the gate such a stall enters
neither leg.  No card is needed.
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
        # graphs submitted but held behind a closed gate, in stream order
        self.pending = []
        # host ms a submission is preempted halfway, by leg
        self.preempt = {}
        # device ms a lo leg waits at its first collective for the last
        # rank's replay to start (across processes)
        self.skew = 0.0

    def install(self, monkeypatch):
        rec = self

        class Gate:
            def __init__(self, device):
                pass

            def wait(self):
                rec.log.append(("gate", rec.capturing))
                if rec.capturing is not None:
                    rec.capturing.gated = True

            def open(self):
                rec.log.append(("open",))
                held, rec.pending = rec.pending, []
                for g in held:
                    g.run(started=False)

        monkeypatch.setattr(timing, "TraceGate", Gate)

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
                self.gated = False
                self.aligned = False

            def replay(self):
                rec.log.append(("replay", self.leg))
                if self.gated or rec.pending:
                    # the card holds it (and what follows on its stream)
                    # until the gate opens: by then it is all submitted
                    rec.pending.append(self)
                    rec.clock += rec.preempt.get(self.leg, 0.0)
                else:
                    self.run(started=True)

            def run(self, started):
                start, end = self.events
                # the wait for the last rank: before the start event when
                # the leg's head met the ranks, else inside the leg
                wait = rec.skew if self.leg == "lo" else 0.0
                rec.clock += wait if self.aligned else 0.0
                start.t = rec.clock
                rec.clock += 0.0 if self.aligned else wait
                rec.clock += rec.durations[self.leg][0]
                if started:
                    # the card runs the part submitted so far, then waits
                    # for the preempted host to submit the rest
                    rec.clock += rec.preempt.get(self.leg, 0.0)
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

    def align(self):
        """The ranks' meeting (``DistWorld.rendezvous``)."""
        self.log.append(("align", self.capturing))
        if self.capturing is not None:
            self.capturing.aligned = True

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
    # the warm-up: one eager run of each leg and one eager open gate, then
    # each leg captured: the lo leg's gate, its lead-in spin, then the leg
    # between its own two events; then one unrecorded pair of replays
    assert rec.log[:5] == [("step", "lo"), ("step", "hi"), ("open",),
                           ("gate", None), ("sync",)]
    captures = rec.log[5:]
    for leg, head in (("lo", ["gate", "spin"]), ("hi", ["spin"])):
        i = captures.index(("capture",))
        g = runner._graphs[leg][0]
        want = [("capture",), *[(h, g) for h in head], ("record", g),
                ("step", leg), ("record", g), ("captured",)]
        assert captures[i:i + len(want)] == want
        captures = captures[i + len(want):]
    assert captures == [("replay", "lo"), ("replay", "hi"), ("open",),
                        ("sync",)]
    for visit in range(3):
        rec.log.clear()
        per_exec = runner.sample()
        # one replay a leg, the gate's opening, one fence after both, then
        # the events' reads: no event recorded and no step launched by
        # the host
        assert rec.log == [("replay", "lo"), ("replay", "hi"), ("open",),
                           ("sync",), ("elapsed",), ("elapsed",)]
        assert per_exec == pytest.approx((3.0 - 1.0) * 1e-3 / 15)
    assert runner.pairs == 3


def test_a_host_preempted_mid_submission_stalls_no_gated_leg(monkeypatch):
    # the host is preempted for 50 ms halfway through submitting each leg:
    # behind the gate the card starts lo only once both legs are on its
    # queue, so neither leg waits for the host
    rec, runner = _runner(monkeypatch, {"lo": [1.0], "hi": [3.0]})
    runner.warm()
    rec.preempt = {"lo": 50.0, "hi": 50.0}
    for _ in range(3):
        assert runner.pair() == pytest.approx((1e-3, 3e-3))
        assert runner.sample() == pytest.approx((3.0 - 1.0) * 1e-3 / 15)


def test_without_the_gate_a_preempted_submission_stalls_the_lo_leg(
        monkeypatch):
    # the fence before the gate: the card starts lo at its replay and waits
    # inside it for the rest of the submission, and the pair goes
    # non-positive
    rec, runner = _runner(monkeypatch, {"lo": [1.0], "hi": [3.0]})
    monkeypatch.setattr(runner, "head", runner.lead_in)
    runner.warm()
    rec.preempt = {"lo": 50.0}
    with pytest.raises(RuntimeError, match="non-positive"):
        runner.sample()


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


def test_across_processes_each_leg_meets_the_ranks_before_its_start(
        monkeypatch):
    # a rank whose replay starts 5 ms before the last rank's waits for it
    # at its lo leg's first collective; its hi leg starts in step with
    # the peers.  Without the meeting the wait lands inside the lo leg
    # and the pair goes non-positive
    rec = _Recorder({"lo": [1.0], "hi": [3.0]})
    rec.install(monkeypatch)

    def runner(align):
        return timing.TraceRunner(rec.step("lo"), rec.step("hi"),
                                  _CardTensor(), 5, 20, align=align)

    loose = runner(None)
    loose.warm()
    rec.skew = 5.0
    with pytest.raises(RuntimeError, match="non-positive"):
        loose.sample()
    rec.skew = 0.0
    rec.log.clear()
    met = runner(rec.align)
    met.warm()
    # the meeting runs once eagerly (its communicator), then in each
    # leg's head after the gate and before the lead-in and start event
    assert rec.log[:3] == [("step", "lo"), ("step", "hi"), ("align", None)]
    captures = rec.log[3:]
    for leg, head in (("lo", ["gate", "align", "spin"]),
                      ("hi", ["align", "spin"])):
        i = captures.index(("capture",))
        g = met._graphs[leg][0]
        want = [("capture",), *[(h, g) for h in head], ("record", g),
                ("step", leg), ("record", g), ("captured",)]
        assert captures[i:i + len(want)] == want
        captures = captures[i + len(want):]
    rec.skew = 5.0
    for _ in range(3):
        assert met.pair() == pytest.approx((1e-3, 3e-3))
        assert met.sample() == pytest.approx((3.0 - 1.0) * 1e-3 / 15)


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
    # two unrecorded pairs in the warm-up, four measured, each opening the
    # gate once
    assert rec.log.count(("replay", "lo")) == 6
    assert rec.log.count(("open",)) == 1 + 6


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


def test_a_world_whose_port_was_taken_starts_once_more(capsys):
    # the four-card worlds pick a free port, then torchrun binds it: a
    # port taken in between (EADDRINUSE) is tried once more on another;
    # any other failure, or a second taken port, is the smoke's failure
    smoke = _smoke()
    ports = []

    def taken_once(port):
        ports.append(port)
        if len(ports) == 1:
            smoke.fail("torchrun: process 0 exited 1: ... EADDRINUSE ...")
        return "ran"

    assert smoke._on_free_port(taken_once, "a world") == "ran"
    assert len(ports) == 2
    assert "once more on another" in capsys.readouterr().err

    def always_taken(port):
        smoke.fail("EADDRINUSE")

    def broken(port):
        smoke.fail("process 0 exited 1: a rank disagreed")

    for launch in (always_taken, broken):
        with pytest.raises(RuntimeError):
            smoke._on_free_port(launch, "a world")
