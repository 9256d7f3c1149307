"""Host cost of the stream engine's pieces, one at a time, on the card.

``bench``'s ``dispatch_overhead`` prices one ``hbm_stream`` execution at
8 B three ways; this tool splits the stream engine's way into what a lane
dispatch and its fence do on the host, each piece timed over ``--reps``
back-to-back calls (host clock, the card's work synchronized once after
the loop):

* ``step``: the step alone on the current stream (two kernel launches);
* ``stream_ctx``: the step under ``torch.cuda.stream(lane)``;
* ``on_lane``: the step with the lane made current the engine's way
  (``engine._on``: the raw current stream read and set back);
* ``record_stream``: ``x.record_stream(lane)`` alone;
* ``event_record``: one ``Event.record(lane)``;
* ``dispatch``: ``StreamEngine.dispatch`` then ``fence`` on one lane
  (the whole lane round trip, fence included);
* ``host_loop``: the step and a ``torch.cuda.synchronize()``, the block
  fence's round trip.

Run on a machine with a card::

    python -m tpu_perf_torch.tools.engine_overhead [--reps 2000] [--bytes 8]

It prints one JSON line of microseconds a call, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import time


def _per_call_us(fn, reps: int) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def measure(nbytes: int = 8, reps: int = 2000) -> dict:
    import torch

    from tpu_perf_torch.bench import card_label
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.streams.engine import StreamEngine, _on
    from tpu_perf_torch.world import SimWorld, resolve_device

    dev = resolve_device()
    built = build_op("hbm_stream", SimWorld(1, dev), nbytes, 1)
    x, step = built.example_input, built.step
    lane = torch.cuda.Stream(dev)
    lane.wait_stream(torch.cuda.current_stream(dev))
    event = torch.cuda.Event()
    engine = StreamEngine(1)

    def in_ctx():
        with torch.cuda.stream(lane):
            step(x)

    def round_trip():
        engine.dispatch(0, step, x)
        engine.fence(0)

    def host_loop():
        step(x)
        torch.cuda.synchronize(dev)

    out = {
        "step": _per_call_us(lambda: step(x), reps),
        "stream_ctx": _per_call_us(in_ctx, reps),
        "on_lane": _per_call_us(lambda: _on(lane, step, x), reps),
        "record_stream": _per_call_us(lambda: x.record_stream(lane), reps),
        "event_record": _per_call_us(lambda: event.record(lane), reps),
        "dispatch": _per_call_us(round_trip, reps),
        "host_loop": _per_call_us(host_loop, reps),
    }
    return {"nbytes": built.nbytes, "reps": reps, "us_a_call": out,
            "card": card_label(dev)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bytes", type=int, default=8)
    p.add_argument("--reps", type=int, default=2000)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.bytes, args.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
