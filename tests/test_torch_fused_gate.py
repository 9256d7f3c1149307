"""The fused fence's gate (``timing.FusedRunner``, ``timing.FUSED_GATE``).

A fused chunk is one CUDA graph replay whose events bracket each run on
the device's clock.  The card starts a graph while the host still
submits it, so a host thread preempted halfway through a replay left the
card waiting inside the first run: on an H100 80GB HBM3 (700 W) a
fault-free 4 KiB ``monitor --health`` soak raised 11 spikes in 20000
visits that way, 13 and 4 regressions with every host core busy
(``python -m tpu_perf_torch.tools.soak_spikes``).  The graph's first node
is now the trace fence's gate, which the host opens once the replay
call has returned.  With ``torch.cuda`` stubbed by a recorder whose card
holds a gated graph until the gate opens and stalls an ungated one by
the host's preemption, a gated chunk's runs keep their device times and
an ungated one's first run takes the stall.  No card is needed.
"""

import contextlib
import types

import pytest
import torch

from tpu_perf_torch import timing


class _Card:
    """A stand-in for the CUDA calls of the fused fence."""

    def __init__(self, durations):
        self.log = []
        self.durations = durations  # device ms a run
        self.clock = 0.0
        self.capturing = None
        self.pending = []
        self.preempt = 0.0  # host ms a replay's submission is preempted

    def install(self, monkeypatch):
        card = self

        class Gate:
            def __init__(self, device):
                pass

            def wait(self):
                card.log.append(("gate", card.capturing is not None))
                if card.capturing is not None:
                    card.capturing.gated = True

            def open(self):
                card.log.append(("open",))
                held, card.pending = card.pending, []
                for g in held:
                    g.run(started=False)

        monkeypatch.setattr(timing, "TraceGate", Gate)

        class Event:
            def __init__(self, enable_timing=False, external=False):
                assert enable_timing and external
                self.t = None

            def record(self, stream=None):
                assert card.capturing is not None, "an event outside a graph"
                card.log.append(("record",))
                card.capturing.events.append(self)

            def elapsed_time(self, other):
                return other.t - self.t

        class CUDAGraph:
            def __init__(self):
                self.events = []
                self.gated = False

            def replay(self):
                card.log.append(("replay",))
                if self.gated:
                    # held by the gate until the host opens it: by then
                    # the whole graph is on the card's queue
                    card.pending.append(self)
                    card.clock += card.preempt
                else:
                    self.run(started=True)

            def run(self, started):
                self.events[0].t = card.clock
                for i, ev in enumerate(self.events[1:]):
                    card.clock += card.durations[i % len(card.durations)]
                    if started and i == 0:
                        # the card ran what was submitted, then waited
                        # for the preempted host to submit the rest
                        card.clock += card.preempt
                    ev.t = card.clock

        @contextlib.contextmanager
        def graph(g, pool=None, stream=None):
            card.capturing = g
            yield
            card.capturing = None

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        @contextlib.contextmanager
        def stream(s):
            yield

        for name, value in dict(
                Event=Event, CUDAGraph=CUDAGraph, graph=graph, Stream=Stream,
                stream=stream, current_stream=lambda device=None: Stream(),
                synchronize=lambda device=None: card.log.append(("sync",))
        ).items():
            monkeypatch.setattr(torch.cuda, name, value)


class _CardTensor:
    is_cuda = True
    device = "cuda:0"

    def clone(self):
        return self

    def copy_(self, other):
        return self


def _runner(monkeypatch, durations, reps=4):
    card = _Card(durations)
    card.install(monkeypatch)

    def program(x, on_run=None):
        for i in range(reps):
            if on_run is not None:
                on_run(i)
        return x

    point = timing.FusedPoint(op="pl_allreduce", plan=(reps,),
                              programs={reps: program})
    built = types.SimpleNamespace(example_input=_CardTensor())
    return card, timing.FusedRunner(point, built)


def test_a_fused_graph_starts_behind_the_gate(monkeypatch):
    card, runner = _runner(monkeypatch, [1.0, 2.0])
    runner.warm()
    # the eager gate launch (open, its module loaded) before capture; in
    # the capture the gate comes before the first event
    i = card.log.index(("gate", True))
    assert card.log[i + 1] == ("record",)
    assert ("gate", False) in card.log[:i]
    card.log.clear()
    runner.chunk(4)
    # one replay, the gate's opening, one fence
    assert card.log == [("replay",), ("open",), ("sync",)]


def test_a_preempted_submission_stalls_no_gated_run(monkeypatch):
    card, runner = _runner(monkeypatch, [1.0, 2.0])
    runner.warm()
    card.preempt = 50.0
    for _ in range(3):
        assert runner.chunk(4) == pytest.approx([1e-3, 2e-3, 1e-3, 2e-3])


def test_without_the_gate_a_preempted_submission_stalls_the_first_run(
        monkeypatch):
    # the fence before the gate: the stall enters the first run, the
    # fault-free soak's spike
    monkeypatch.setattr(timing, "FUSED_GATE", False)
    card, runner = _runner(monkeypatch, [1.0, 2.0])
    runner.warm()
    assert runner.gate is None
    card.preempt = 50.0
    times = runner.chunk(4)
    assert times[0] == pytest.approx(51e-3)
    assert times[1:] == pytest.approx([2e-3, 1e-3, 2e-3])


def test_the_gate_is_freed_with_the_graphs(monkeypatch):
    card, runner = _runner(monkeypatch, [1.0])
    runner.warm()
    assert runner.gate is not None
    runner.close()
    assert runner.gate is None and not runner._graphs
