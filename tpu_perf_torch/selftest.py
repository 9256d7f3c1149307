"""Payload-correctness selftest (port of ``tpu_perf/selftest.py`` for this
slice's ops).

Every op is executed on the sim world and its output compared element-wise
against a numpy model of the op composed ``iters`` times — the same models
the JAX package uses, copied here, on the same ``make_fill`` input.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


def _mean_all(x: np.ndarray) -> np.ndarray:
    return np.broadcast_to(x.mean(axis=0), x.shape)


def _reduce_scatter(x: np.ndarray) -> np.ndarray:
    # ring carry convention: rank d ends with the mean of chunk d over
    # ranks, tiled n times over the whole buffer
    n = x.shape[0]
    chunks = x.reshape(n, n, -1)
    red = chunks.mean(axis=0)
    return np.stack([np.tile(red[d], n) for d in range(n)])


def _identity(x: np.ndarray) -> np.ndarray:
    return x


def _hbm_stream(x: np.ndarray) -> np.ndarray:
    return x * 1.0000001 + 1e-7


#: op -> model of ONE application on the (n_ranks, per_rank) global array
EXPECTATIONS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "allreduce": _mean_all,
    "hbm_stream": _hbm_stream,
    "pl_all_gather": _identity,  # gather + take-own-shard carry
    "pl_reduce_scatter": _reduce_scatter,
    "pl_allreduce": _mean_all,
    "pl_hbm_stream": _hbm_stream,
}

#: integer-dtype model overrides (the ops whose body is dtype-dependent)
_EXPECTATIONS_INT = {
    "hbm_stream": lambda x: x + 1,
    "pl_hbm_stream": lambda x: x + 1,
}

_RTOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}


@dataclasses.dataclass(frozen=True)
class SelftestResult:
    op: str
    status: str  # "ok" | "skip" | "fail"
    detail: str = ""


def run_selftest(world, *, ops: list[str] | None = None, nbytes: int = 4096,
                 dtype: str = "float32", iters: int = 1) -> list[SelftestResult]:
    """Validate each op's payload numerics on ``world``; never raises per
    op — failures land in the result list so every op is checked."""
    from tpu_perf_torch.ops.collectives import (
        FLOAT_ONLY_OPS, build_op, is_float_dtype,
    )
    from tpu_perf_torch.world import from_world

    known = sorted(EXPECTATIONS)
    todo = ops if ops is not None else known
    unknown = [op for op in todo if op not in known]
    if unknown:
        raise ValueError(f"unknown op(s) {unknown}; known: {known}")
    is_int = not is_float_dtype(dtype)
    rtol = _RTOL.get(dtype, 1e-5)
    results: list[SelftestResult] = []
    for op in todo:
        if is_int and op in FLOAT_ONLY_OPS:
            results.append(SelftestResult(op, "skip", "float dtypes only"))
            continue
        if op in ("pl_allreduce", "pl_reduce_scatter") and world.n < 2:
            results.append(SelftestResult(op, "skip", "needs at least 2 ranks"))
            continue
        model = (_EXPECTATIONS_INT.get(op, EXPECTATIONS[op]) if is_int
                 else EXPECTATIONS[op])
        try:
            built = build_op(op, world, nbytes, iters=iters, dtype=dtype)
            x_native = from_world(built.example_input)
            out = from_world(built.step(built.example_input)).astype(np.float64)
            n = built.n_devices
            # integers compose in the native dtype so wraparound matches
            want = (x_native if is_int
                    else x_native.astype(np.float64)).reshape(n, -1)
            for _ in range(iters):
                want = model(want)
            want = want.astype(np.float64)
            got = out.reshape(n, -1)
            err = np.abs(got - want)
            bad = ~np.isfinite(got) | (err > rtol * np.abs(want) + rtol)
            worst = float(np.nanmax(err)) if np.isfinite(err).any() else float("nan")
            if not bad.any():
                results.append(SelftestResult(op, "ok", f"max abs err {worst:.2e}"))
            else:
                results.append(SelftestResult(
                    op, "fail", f"{int(bad.sum())}/{got.size} elements off "
                                f"(max abs err {worst:.2e})"))
        except Exception as e:  # noqa: BLE001 — one op's failure must not
            # mask the others; the point is a complete report
            results.append(SelftestResult(op, "fail", f"{type(e).__name__}: {e}"))
    return results


def format_results(results: list[SelftestResult]) -> str:
    width = max((len(r.op) for r in results), default=4)
    lines = []
    for r in results:
        tag = {"ok": "OK  ", "skip": "SKIP", "fail": "FAIL"}[r.status]
        lines.append(f"{r.op:<{width}}  {tag}  {r.detail}")
    n_ok = sum(r.status == "ok" for r in results)
    n_skip = sum(r.status == "skip" for r in results)
    n_fail = sum(r.status == "fail" for r in results)
    lines.append(f"{n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return "\n".join(lines)
