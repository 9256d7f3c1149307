"""Headline benchmark on one card (port of ``tpu_perf/bench.py``'s
one-device headline).  Prints ONE JSON line::

    {"metric": ..., "value": N, "unit": "GB/s", "vs_peak": N,
     "card": {...}, "metrics": [{...}, ...]}

On one card the honest headline is the local memory roofline: the
``pl_hbm_stream`` Triton kernel's bus bandwidth (read + write of the
buffer per execution) on a one-rank world, which measures the card
itself; ``hbm_stream`` (plain PyTorch operations) rides beside it.
``metrics`` also carries the ring all-reduce's sim-world busbw at 4 MiB
per rank x 8 ranks — a number about the card's memory system under the
ring schedule, not about any link.  Every number is labelled with the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

from tpu_perf_torch.config import Options
from tpu_perf_torch.runner import run_point
from tpu_perf_torch.world import SimWorld, resolve_device

#: H100 SXM device-memory rate (NVIDIA data sheet), GB/s
H100_HBM_GBPS = 3350.0

#: stream headline: (bytes, iters, runs) on one rank
STREAM_POINT = (256 * 1024**2, 20, 5)
#: ring all-reduce: (sim ranks, bytes per rank, iters, runs)
ALLREDUCE_POINT = (8, 4 * 1024**2, 20, 5)


def card_label(device) -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": "not measured"}
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, _, limit = out.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def _p50_busbw(op: str, world: SimWorld, nbytes: int, iters: int,
               runs: int) -> dict:
    fence = "trace" if world.device.type == "cuda" else "slope"
    opts = Options(op=op, iters=iters, num_runs=runs, warmup_runs=2,
                   fence=fence, sim_ranks=world.n,
                   device=world.device.type)
    point = run_point(opts, world, nbytes)
    rows = point.rows(opts.uuid, backend=world.backend)
    busbw = sorted(r.busbw_gbps for r in rows)[len(rows) // 2]
    return {"op": op, "backend": world.backend, "n_devices": world.n,
            "nbytes": point.nbytes, "iters": iters, "runs": runs,
            "fence": fence, "busbw_gbps_p50": busbw}


def main(device: str | None = None) -> dict:
    dev = resolve_device(device)
    card = card_label(dev)
    nbytes, iters, runs = STREAM_POINT
    metrics = [_p50_busbw(op, SimWorld(1, dev), nbytes, iters, runs)
               for op in ("pl_hbm_stream", "hbm_stream")]
    n, nbytes, iters, runs = ALLREDUCE_POINT
    metrics.append(_p50_busbw("pl_allreduce", SimWorld(n, dev), nbytes,
                              iters, runs))
    for m in metrics:
        m["card"] = card
    head = metrics[0]
    payload = {
        "metric": "pl_hbm_stream_busbw_p50",
        "value": head["busbw_gbps_p50"],
        "unit": "GB/s",
        "vs_peak": head["busbw_gbps_p50"] / H100_HBM_GBPS,
        "card": card,
        "metrics": metrics,
    }
    print(json.dumps(payload))
    return payload
