"""What ``--spans`` costs a host-timed run, split by where the cost lies.

A finite ``run`` of one point is timed four ways, in turns, ``--rounds``
times each:

* ``off``: no tracer;
* ``memory``: ``--spans`` without a log folder (records kept in memory:
  the spans' bookkeeping, no file write);
* ``log``: ``--spans`` into the ``spans-*.log`` family, the fence span's
  record written after the run's end clock read (what the port ships);
* ``inside``: the same with that record written at the span's close,
  inside the timed window (the JAX tracer's write time).

Each variant's rows give their p50 ``lat_us``.  Run on a machine with a
card::

    python -m tpu_perf_torch.tools.spans_tax [--op pl_allreduce] [-b 4K]
        [-r 500] [--fence block] [--rounds 2]

It prints one JSON line: each variant's p50s in microseconds, with the
card's name and power limit (``--device cpu`` rehearses the control flow;
its numbers are the CPU's).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile

VARIANTS = ("off", "memory", "log", "inside")


@contextlib.contextmanager
def _writes_inside():
    """Every span written at its close, as the JAX tracer writes it."""
    from tpu_perf_torch.spans import SpanTracer

    plain = SpanTracer.span

    def undeferred(self, kind, *, defer=False, **kw):
        return plain(self, kind, **kw)

    SpanTracer.span = undeferred
    try:
        yield
    finally:
        SpanTracer.span = plain


def _p50(op: str, nbytes: int, runs: int, fence: str, variant: str,
         device: str | None, folder: str) -> float:
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.driver import Driver

    opts = Options(op=op, buff_sz=nbytes, num_runs=runs, fence=fence,
                   spans=variant != "off", device=device,
                   logfolder=None if variant == "memory" else folder)
    with _writes_inside() if variant == "inside" else contextlib.nullcontext():
        rows = Driver(opts).run()
    lats = sorted(r.lat_us for r in rows)
    return lats[len(lats) // 2]


def measure(op: str = "pl_allreduce", nbytes: int = 4096, runs: int = 500,
            fence: str = "block", rounds: int = 2,
            device: str | None = None) -> dict:
    out: dict[str, list[float]] = {v: [] for v in VARIANTS}
    with tempfile.TemporaryDirectory(prefix="spans_tax-") as root:
        for i in range(rounds):
            for v in VARIANTS:
                out[v].append(round(_p50(op, nbytes, runs, fence, v, device,
                                         f"{root}/{v}{i}"), 3))
    return out


def main(argv: list[str] | None = None) -> int:
    from tpu_perf_torch.sweep import parse_size

    p = argparse.ArgumentParser(prog="python -m tpu_perf_torch.tools.spans_tax",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--op", default="pl_allreduce")
    p.add_argument("-b", "--size", default="4K")
    p.add_argument("-r", "--runs", type=int, default=500)
    p.add_argument("--fence", default="block")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = p.parse_args(argv)
    got = measure(args.op, parse_size(args.size), args.runs, args.fence,
                  args.rounds, args.device)
    from tpu_perf_torch.bench import card_label
    from tpu_perf_torch.world import resolve_device

    card = card_label(resolve_device(args.device))
    print(json.dumps({"op": args.op, "nbytes": parse_size(args.size),
                      "runs": args.runs, "fence": args.fence,
                      "lat_us_p50": got, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
