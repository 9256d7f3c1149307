#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``tpu_perf_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python3 chip_smoke.py

Phases, each printing what it found (any failure raises and the script
exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from the sources in this checkout (one nvcc per
   CUDA source, all started together; the Triton kernel compiles at its
   first launch) and print the build time;
3. hold each kernel against its plain PyTorch version on the card: ring
   reduce-scatter and ring all-gather (both modes) at 5 and 8 ranks, and
   the stream kernel, over several dtypes and ragged / multi-tile shapes;
4. drive the port's run path through its CLI (``run --op pl_allreduce
   --sweep 4K:256M``, then the other five ops of the slice) with the
   launch counters reset just before each run and read just after, parse
   the rows back, and check the outputs against the selftest models;
5. time each kernel at the main path's largest shape beside its bound,
   its plain version and one PyTorch library call computing the same
   function, and print them as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX and nothing of the JAX package ``tpu_perf``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


#: H100 SXM published rates (NVIDIA data sheet): device memory and float32
#: operations outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SWEEP = "4K:256M"
ITERS, RUNS = 5, 3
MAIN_BYTES = 256 * 1024**2  # the sweep's largest point, per rank
HEADLINE_BYTES = 4 * 1024**2

#: kernel-vs-plain tolerances: |kernel - plain| <= atol + rtol * |plain|.
#: Both sides do the same arithmetic with the same roundings, so the cases
#: are expected to agree exactly; the float rtol still allows one rounding
#: of difference (16-bit floats: one unit in the last place), so that a
#: compiler's reassociation is reported by max_abs_err, not a failure.
RTOL = {"float32": 1e-6, "bfloat16": 8e-3, "float16": 1e-3,
        "int32": 0.0, "uint8": 0.0}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def max_abs_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def check_close(what: str, got, want, dtype: str) -> float:
    import torch

    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite output")
    bad = (g - w).abs() > RTOL[dtype] * w.abs()
    err = max_abs_err(got, want)
    if bad.any():
        fail(f"{what}: {int(bad.sum())} of {g.numel()} elements off "
             f"(max abs err {err:.3e}, rtol {RTOL[dtype]})")
    return err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_build() -> None:
    import torch

    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.stream_triton import stream

    nvcc_s = _build.build_all()
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        stream(torch.ones(3, 5, dtype=dt, device="cuda"))
    torch.cuda.synchronize()
    print(f"build: nvcc (2 sources, parallel) {nvcc_s:.1f} s, "
          f"triton first launches {time.perf_counter() - t0:.1f} s")


def phase_check() -> None:
    import torch

    from tpu_perf_torch.ops.collectives import DTYPES, make_fill, to_tensor
    from tpu_perf_torch.ops.pallas_ring import (
        ring_all_gather, ring_all_gather_plain, ring_reduce_scatter,
        ring_reduce_scatter_plain,
    )
    from tpu_perf_torch.ops.stream_triton import stream, stream_plain

    def fill(shape, dtype):
        total = 1
        for s in shape:
            total *= s
        return to_tensor(make_fill(total, dtype).reshape(shape), dtype, "cuda")

    n_checks = 0
    for n in (5, 8):
        # 1001: the scalar path; 4096: 16-byte vectors; 2**20 + 64: more
        # units than the kernels' grid, so the grid-stride loop turns
        for chunk in (1001, 4096, 2**20 + 64):
            for dtype in ("float32", "bfloat16", "float16"):
                x = fill((n, n * chunk), dtype)
                got = ring_reduce_scatter(x)
                want = torch.empty_like(x)
                ring_reduce_scatter_plain(
                    x, want, x.new_empty((n, n - 1, chunk)))
                check_close(f"ring_reduce_scatter n={n} chunk={chunk} {dtype}",
                            got, want, dtype)
                n_checks += 1
            for dtype in ("float32", "bfloat16", "int32", "uint8"):
                for src_full in (False, True):
                    shape = (n, n * chunk) if src_full else (n, chunk)
                    x = fill(shape, dtype)
                    got = ring_all_gather(x, src_full=src_full)
                    want = x.new_empty((n, n * chunk))
                    ring_all_gather_plain(x, want, src_full)
                    check_close(f"ring_all_gather n={n} chunk={chunk} "
                                f"src_full={src_full} {dtype}", got, want, dtype)
                    n_checks += 1
    for dtype in DTYPES:
        for shape in ((1, 1), (8, 1000003), (1, 3 * 2**22 + 5)):
            x = fill(shape, dtype)
            check_close(f"stream {shape} {dtype}", stream(x),
                        stream_plain(x), dtype)
            n_checks += 1
    torch.cuda.synchronize()
    print(f"check: {n_checks} kernel-vs-plain cases agree within the stated "
          f"tolerances {RTOL}")


#: op -> (kernels its run must launch, sim ranks)
PATHS = {
    "pl_allreduce": (("ring_reduce_scatter", "ring_all_gather"), 8),
    "allreduce": ((), 8),
    "pl_reduce_scatter": (("ring_reduce_scatter",), 8),
    "pl_all_gather": (("ring_all_gather",), 8),
    "hbm_stream": ((), 1),
    "pl_hbm_stream": (("stream",), 1),
}


def phase_main_path() -> dict:
    import glob
    import math
    import tempfile

    import torch

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import sizes_for
    from tpu_perf_torch.schema import ResultRow
    from tpu_perf_torch.selftest import format_results, run_selftest
    from tpu_perf_torch.world import SimWorld

    dev = torch.device("cuda", torch.cuda.current_device())
    launches: dict[str, dict[str, int]] = {}
    sizes = sizes_for(Options(sweep=SWEEP))
    n_sizes = len(sizes)
    for op, (needs, ranks) in PATHS.items():
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke-{op}-") as logdir:
            kernels.reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["run", "--op", op, "--sweep", SWEEP, "-i",
                           str(ITERS), "-r", str(RUNS), "-l", logdir,
                           "--sim-ranks", str(ranks)])
            wall = time.perf_counter() - t0
            got, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
            rows = []
            for path in sorted(glob.glob(os.path.join(logdir, "tpu-*.log"))):
                with open(path) as fh:
                    rows += [ResultRow.from_csv(ln) for ln in fh if ln.strip()]
        if rc != 0:
            fail(f"run --op {op} exited {rc}")
        missing = [k for k in needs if got[k] == 0]
        if missing:
            fail(f"run --op {op}: kernels {missing} never launched ({got})")
        extra = [k for k, v in got.items() if v and k not in needs]
        if extra:
            fail(f"run --op {op}: launched kernels {extra} off its path")
        if any(plain.values()):
            fail(f"run --op {op}: plain versions called {plain}")
        backend = "torch-sim" if ranks > 1 else "torch"
        if len(rows) != n_sizes * RUNS:
            fail(f"run --op {op}: {len(rows)} rows, want {n_sizes * RUNS}")
        for r in rows:
            if (r.op != op or r.backend != backend or r.n_devices != ranks
                    or r.iters != ITERS or not math.isfinite(r.busbw_gbps)
                    or r.busbw_gbps <= 0):
                fail(f"run --op {op}: bad row {r}")
        big = max(rows, key=lambda r: (r.nbytes, -r.time_ms))
        small = min(rows, key=lambda r: (r.nbytes, r.lat_us))
        print(f"path: run --op {op} --sweep {SWEEP} --sim-ranks {ranks}: "
              f"{len(rows)} rows in {wall:.1f} s, launches "
              f"{ {k: got[k] for k in needs} }, plain calls 0; largest point "
              f"{big.nbytes} B busbw {big.busbw_gbps:.1f} GB/s, smallest "
              f"point {small.nbytes} B lat {small.lat_us:.1f} us ({backend})")
        launches[op] = got
        # the run's outputs at the sweep's ends, the same op built at the
        # same flags on the same fill, against the selftest's numpy model
        for nbytes in (min(sizes), max(sizes)):
            results = run_selftest(SimWorld(ranks, dev), ops=[op],
                                   nbytes=nbytes, iters=ITERS)
            if any(r.status != "ok" for r in results):
                fail(f"run --op {op} output at {nbytes} B:\n"
                     f"{format_results(results)}")
            print(f"path: run --op {op} output at {nbytes} B/rank, "
                  f"iters={ITERS}: {results[0].detail} against the selftest "
                  "model")
    return launches


def phase_selftest() -> None:
    import torch

    from tpu_perf_torch.selftest import format_results, run_selftest
    from tpu_perf_torch.world import SimWorld

    dev = torch.device("cuda", torch.cuda.current_device())
    for n, dtype, iters in ((8, "float32", 3), (5, "float32", 1),
                            (8, "bfloat16", 3), (8, "int32", 3)):
        results = run_selftest(SimWorld(n, dev), nbytes=1 << 20,
                               dtype=dtype, iters=iters)
        if any(r.status == "fail" for r in results):
            fail(f"selftest n={n} {dtype}:\n{format_results(results)}")
        ok = sum(r.status == "ok" for r in results)
        print(f"selftest: n={n} {dtype} iters={iters}: {ok} ops match the "
              "numpy models")


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` of device-memory traffic and ``ops``
    float32 operations, with both counts kept for the printout."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _kernel_rows(per_rank_bytes: int, launches: dict) -> list[dict]:
    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import (
        ring_all_gather, ring_all_gather_plain, ring_reduce_scatter,
        ring_reduce_scatter_plain,
    )
    from tpu_perf_torch.ops.stream_triton import (
        stream, stream_constants, stream_plain,
    )
    from tpu_perf_torch.world import SimWorld

    dev = torch.device("cuda", torch.cuda.current_device())
    out = []

    # ring reduce-scatter at the pl_allreduce path's input
    x = build_op("pl_allreduce", SimWorld(8, dev), per_rank_bytes, 1).example_input
    n = x.shape[0]
    chunk = x.shape[1] // n
    isz = x.element_size()
    red = ring_reduce_scatter(x)
    want = torch.empty_like(x)
    ring_reduce_scatter_plain(x, want, x.new_empty((n, n - 1, chunk)))
    err = check_close("ring_reduce_scatter at path shape", red, want, "float32")
    del want
    # the function's own bytes: x read once, each rank's reduced chunk
    # written once; (n-1) adds per reduced element
    bound = _bound((x.numel() + n * chunk) * isz, n * (n - 1) * chunk)
    stage = x.new_empty((n, n - 1, chunk))
    plain_out = torch.empty_like(x)
    out.append({
        "name": "ring_reduce_scatter", "route": "cuda",
        "source": "tpu_perf_torch/csrc/ring_reduce_scatter.cu",
        "replaces": "tpu_perf/ops/pallas_ring.py:599",
        "launches": launches["pl_allreduce"]["ring_reduce_scatter"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ring_reduce_scatter(x), 10),
        "plain_ms": cuda_ms(
            lambda: ring_reduce_scatter_plain(x, plain_out, stage), 3, 1),
        **bound,
        "library_ms": cuda_ms(lambda: x.view(n, n, chunk).sum(0), 10),
        "shape": [n, n * chunk], "dtype": "float32",
    })
    del stage, plain_out

    # ring all-gather (src_full) at the pl_allreduce path's phase-2 input
    got = ring_all_gather(red, src_full=True)
    want = red.new_empty((n, n * chunk))
    ring_all_gather_plain(red, want, True)
    err = check_close("ring_all_gather at path shape", got, want, "float32")
    del got

    def gather_library():
        own = red.view(n, n, chunk).diagonal(0, 0, 1).T
        return own.unsqueeze(0).expand(n, n, chunk).reshape(n, n * chunk)

    # each rank's own chunk read once, the gathered rows written once
    bound = _bound((n * chunk + n * n * chunk) * isz, 0)
    out.append({
        "name": "ring_all_gather", "route": "cuda",
        "source": "tpu_perf_torch/csrc/ring_all_gather.cu",
        "replaces": "tpu_perf/ops/pallas_ring.py:481",
        "launches": launches["pl_allreduce"]["ring_all_gather"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ring_all_gather(red, src_full=True), 10),
        "plain_ms": cuda_ms(lambda: ring_all_gather_plain(red, want, True), 3, 1),
        **bound,
        "library_ms": cuda_ms(gather_library, 10),
        "shape": [n, n * chunk], "dtype": "float32",
    })
    del x, red, want

    # stream at the pl_hbm_stream path's input (one rank: the card itself)
    x = build_op("pl_hbm_stream", SimWorld(1, dev), per_rank_bytes, 1).example_input
    err = check_close("stream at path shape", stream(x), stream_plain(x),
                      "float32")
    scale, shift = (c.to(dev) for c in stream_constants(x.dtype))
    # x read once, y written once; one multiply and one add per element
    bound = _bound(2 * x.numel() * x.element_size(), 2 * x.numel())
    out.append({
        "name": "stream", "route": "triton",
        "source": "tpu_perf_torch/ops/stream_triton.py",
        "replaces": "tpu_perf/ops/pallas_ring.py:166",
        "launches": launches["pl_hbm_stream"]["stream"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: stream(x), 10),
        "plain_ms": cuda_ms(lambda: stream_plain(x), 10),
        **bound,
        "library_ms": cuda_ms(lambda: torch.addcmul(shift, x, scale), 10),
        "shape": list(x.shape), "dtype": "float32",
    })
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    # the port itself; in a directory without the repository this import
    # fails and the script exits non-zero before printing any result
    import tpu_perf_torch  # noqa: F401

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t_start = time.perf_counter()
    phase_build()
    phase_check()
    launches = phase_main_path()
    phase_selftest()
    for label, per_rank in (("4MiB", HEADLINE_BYTES), ("256MiB", MAIN_BYTES)):
        rows = _kernel_rows(per_rank, launches)
        for k in rows:
            print(f"kernel @{label}/rank: {k['name']} {k['shape']}: "
                  f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
                  f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
                  f"({k['bound_by']}: {k['bytes']} B at 3.35 TB/s, "
                  f"{k['ops']} f32 ops at 67 TFLOP/s), "
                  f"{k['bound_ms'] / k['ms']:.1%} of bound")
    print(f"total: {time.perf_counter() - t_start:.1f} s, card: {smi}")
    # the JSON line reports the main path's largest shape, the last rows
    for k in rows:
        for extra in ("shape", "dtype", "bytes", "ops"):
            del k[extra]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
