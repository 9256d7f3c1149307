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
    red = x.reshape(n, n, -1).mean(axis=0)
    return np.tile(red, n)  # row d: red[d], n times


def _reduce_scatter_inplace(x: np.ndarray) -> np.ndarray:
    # library carry convention: rank d keeps its buffer with only its own
    # chunk replaced by the mean of chunk d over ranks
    n = x.shape[0]
    chunks = x.reshape(n, n, -1).copy()
    red = chunks.mean(axis=0)
    for d in range(n):
        chunks[d, d] = red[d]
    return chunks.reshape(n, -1)


def _all_to_all(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    return x.reshape(n, n, -1).transpose(1, 0, 2).reshape(n, -1)


def _broadcast(x: np.ndarray) -> np.ndarray:
    return np.broadcast_to(x[0], x.shape)


def _pingpong(x: np.ndarray) -> np.ndarray:
    # payload there and back: group 0 (first half) gets its payload back,
    # group 1 ends at zero (ppermute zero-fills the ranks it does not target)
    out = np.zeros_like(x)
    out[: x.shape[0] // 2] = x[: x.shape[0] // 2]
    return out


def _pingpong_unidir(x: np.ndarray) -> np.ndarray:
    # group 0 keeps its buffer and receives its own first element back as
    # the 1-element ack; group 1's ack slot is zeroed (no inbound ack)
    out = x.copy()
    out[x.shape[0] // 2:, 0] = 0
    return out


def _exchange(x: np.ndarray) -> np.ndarray:
    half = x.shape[0] // 2
    return np.concatenate([x[half:], x[:half]])


def _ring(x: np.ndarray) -> np.ndarray:
    return np.roll(x, 1, axis=0)


def _halo(x: np.ndarray) -> np.ndarray:
    # each rank ends with [left neighbour's right edge, right neighbour's
    # left edge]
    n, elems = x.shape
    h = elems // 2
    out = np.empty_like(x)
    for d in range(n):
        out[d] = np.concatenate([x[(d - 1) % n][elems - h:], x[(d + 1) % n][:h]])
    return out


def _identity(x: np.ndarray) -> np.ndarray:
    return x


def _hbm_stream(x: np.ndarray) -> np.ndarray:
    return x * 1.0000001 + 1e-7


def _hbm_read(x: np.ndarray) -> np.ndarray:
    # per rank: slot 0 <- mean(max(row, row[0])); the rest untouched
    m = np.maximum(x, x[:, :1])
    out = x.copy()
    out[:, 0] = m.mean(axis=1)
    return out


def _hbm_write(x: np.ndarray) -> np.ndarray:
    # per rank: the whole row becomes f(row[0])
    return np.broadcast_to(x[:, :1] * 1.0000001 + 1e-7, x.shape).copy()


def _hbm_triad(x: np.ndarray) -> np.ndarray:
    # first half <- a*k1 + b*k2 in place; second half untouched
    h = x.shape[1] // 2
    out = x.copy()
    out[:, :h] = x[:, :h] * 1.0000001 + x[:, h:] * 1e-7
    return out


def _hbm_triad_int(x: np.ndarray) -> np.ndarray:
    # wrapping add in the native dtype (integer models compose natively)
    h = x.shape[1] // 2
    out = x.copy()
    out[:, :h] = x[:, :h] + x[:, h:]
    return out


def _ortho(m: int, _cache={}) -> np.ndarray:
    # the models' own copy of the ops' orthogonal matrix, so the check
    # does not lean on the code it checks
    if m not in _cache:
        rng = np.random.default_rng(7)
        q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        _cache[m] = q
    return _cache[m]


def _mxu_gemm(x: np.ndarray) -> np.ndarray:
    n, elems = x.shape
    m = int(elems ** 0.5)
    y = (x.reshape(n, m, m) @ _ortho(m)).reshape(n, -1)
    return y * 1.0000001 + 1e-7  # the body's wrap-add


def _overlap_ring(x: np.ndarray) -> np.ndarray:
    from tpu_perf_torch.ops.collectives import _overlap_split

    n, elems = x.shape
    r, m = _overlap_split(elems)
    moved = np.roll(x[:, :r], 1, axis=0)
    done = (x[:, r:].reshape(n, m, m) @ _ortho(m)).reshape(n, -1)
    return np.concatenate([moved, done * 1.0000001 + 1e-7], axis=1)


def _pl_hbm_write_for(dtype: str) -> Callable[[np.ndarray], np.ndarray]:
    """The kernel tiles each row's first DMA block over the row; the block
    scales with the NATIVE itemsize, which must come from the measurement
    dtype, not from the model array (floats compose in float64)."""
    from tpu_perf_torch.ops.collectives import DTYPES
    from tpu_perf_torch.ops.pallas_ring import hbm_dma_block_elems

    itemsize = DTYPES[dtype].itemsize

    def model(x: np.ndarray) -> np.ndarray:
        block = hbm_dma_block_elems(itemsize, x.shape[1])
        nfull, rem = divmod(x.shape[1], block)
        full = np.tile(x[:, :block], nfull)
        # the trailing partial block is the seed block's first rem elements
        return np.concatenate([full, x[:, :rem]], axis=1) if rem else full

    return model


#: op -> model of ONE application on the (n_ranks, per_rank) global array
EXPECTATIONS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "allreduce": _mean_all,
    "hier_allreduce": _mean_all,
    "barrier": _mean_all,
    "all_gather": _identity,  # gather + take-own-shard carry
    "reduce_scatter": _reduce_scatter_inplace,
    "all_to_all": _all_to_all,
    "broadcast": _broadcast,
    "broadcast_psum": _broadcast,
    "exchange": _exchange,
    "halo": _halo,
    "pingpong": _pingpong,
    "pingpong_unidir": _pingpong_unidir,
    "ppermute": _exchange,
    "ring": _ring,
    "pl_ring": _ring,
    "pl_exchange": _exchange,
    # round trip: both groups end with their own payload (group 1 keeps it
    # by the local copy), so any wrong dispatch fails
    "pl_pingpong": _identity,
    "pl_barrier": _identity,  # barrier + the 1-element copy
    "hbm_read": _hbm_read,
    "hbm_stream": _hbm_stream,
    "hbm_triad": _hbm_triad,
    "hbm_write": _hbm_write,
    "pl_all_gather": _identity,  # gather + take-own-shard carry
    "pl_reduce_scatter": _reduce_scatter,
    "pl_allreduce": _mean_all,
    "pl_hbm_copy": _identity,  # a copy is an exact identity
    "pl_hbm_read": _identity,  # the read sweep writes nothing
    # placeholder for totality; run_selftest takes the real model from
    # _EXPECTATIONS_BY_DTYPE
    "pl_hbm_write": _pl_hbm_write_for("float32"),
    "pl_hbm_stream": _hbm_stream,
    # gather + take-own-shard carry, like pl_all_gather
    "pl_all_gather_bidir": _identity,
    "pl_all_to_all": _all_to_all,  # chunk transpose, like the library op
    "mxu_gemm": _mxu_gemm,
    "overlap_ring": _overlap_ring,
}

#: integer-dtype model overrides (the ops whose body is dtype-dependent)
_EXPECTATIONS_INT = {
    "hbm_stream": lambda x: x + 1,
    "pl_hbm_stream": lambda x: x + 1,
    "hbm_write": lambda x: np.broadcast_to(x[:, :1] + 1, x.shape).copy(),
    "hbm_triad": _hbm_triad_int,
}

#: ops whose model depends on the measurement dtype itself (not just on
#: int against float): op -> factory(dtype) -> model.  Checked first.
_EXPECTATIONS_BY_DTYPE = {
    "pl_hbm_write": _pl_hbm_write_for,
}

_RTOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
#: the matmul ops' floors (the JAX package's, by device).  On the CPU an
#: m-deep product accumulates about m * eps of rounding against the
#: float64 model.  On the card the floor is the JAX package's accelerator
#: one: a bfloat16 chain of 3 products at m = 768 reaches 3.25e-2 max abs
#: against the model, whose q is unrounded while every iteration rounds
#: its output to bfloat16 (the JAX package's own selftest reads the same
#: on its CPU devices); a wrong product is off by O(1) either way.  TF32
#: stays off, so a float32 product is a float32 product on the card.
_MATMUL_OPS = ("mxu_gemm", "overlap_ring")
_MATMUL_RTOL_CPU = 1e-3
_MATMUL_RTOL_CARD = 3e-2

#: elements per float64 piece of the comparison (16 MiB): a gigabyte
#: output is compared piece by piece, reusing the same memory, instead of
#: through several float64 temporaries the size of the whole buffer
_CMP_PIECE = 1 << 21


def _compare(got: np.ndarray, want: np.ndarray, rtol: float) -> tuple[int, float]:
    """(elements off, max abs err) of ``got`` against ``want``, both
    ``(n, cols)``, in float64: off where not finite or where
    ``|got - want| > rtol * |want| + rtol`` (allclose with atol = rtol)."""
    n, cols = got.shape
    step = max(1, _CMP_PIECE // n)
    n_bad, worst = 0, float("nan")
    for lo in range(0, cols, step):
        g = got[:, lo:lo + step].astype(np.float64)
        w = np.asarray(want[:, lo:lo + step], dtype=np.float64)
        err = np.abs(g - w)
        n_bad += int((~np.isfinite(g) | (err > rtol * np.abs(w) + rtol)).sum())
        finite = err[np.isfinite(err)]
        if finite.size:
            worst = float(finite.max()) if np.isnan(worst) else max(worst, float(finite.max()))
    return n_bad, worst


@dataclasses.dataclass(frozen=True)
class SelftestResult:
    op: str
    status: str  # "ok" | "skip" | "fail"
    detail: str = ""


#: the ops whose pair permutation needs an even rank count
_EVEN_OPS = ("pingpong", "pingpong_unidir", "exchange", "ppermute",
             "pl_exchange", "pl_pingpong")
#: the ops that need a peer
_TWO_OR_MORE_OPS = ("pl_reduce_scatter", "pl_allreduce", "pl_barrier")
#: the ops that run over one mesh axis (ppermute schedules, the kernels)
_ONE_AXIS_OPS = ("pingpong", "pingpong_unidir", "exchange", "ppermute",
                 "ring", "halo", "broadcast", "overlap_ring")


def _skip_reason(op: str, n: int, axes: tuple[str, ...] = ("x",)
                 ) -> str | None:
    """The constraint an n-rank world over mesh ``axes`` fails, if any
    (the JAX package's reasons)."""
    if op == "hier_allreduce":
        return None if len(axes) == 2 else "needs a 2-axis (dcn, ici) mesh"
    if len(axes) != 1 and (op in _ONE_AXIS_OPS or op.startswith("pl_")):
        return "needs a single-axis mesh"
    if op in _EVEN_OPS and n % 2:
        return "needs an even device count"
    if op in _TWO_OR_MORE_OPS and n < 2:
        return "needs at least 2 devices"
    return None


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
    base_rtol = _RTOL.get(dtype, 1e-5)
    results: list[SelftestResult] = []
    for op in todo:
        floor = (_MATMUL_RTOL_CARD if world.device.type == "cuda"
                 else _MATMUL_RTOL_CPU)
        rtol = max(base_rtol, floor if op in _MATMUL_OPS else 0.0)
        reason = _skip_reason(op, world.n, world.axis_names)
        if reason:
            results.append(SelftestResult(op, "skip", reason))
            continue
        if is_int and op in FLOAT_ONLY_OPS:
            results.append(SelftestResult(op, "skip", "float dtypes only"))
            continue
        if op in _EXPECTATIONS_BY_DTYPE:
            model = _EXPECTATIONS_BY_DTYPE[op](dtype)
        else:
            model = (_EXPECTATIONS_INT.get(op, EXPECTATIONS[op]) if is_int
                     else EXPECTATIONS[op])
        try:
            built = build_op(op, world, nbytes, iters=iters, dtype=dtype)
            n = built.n_devices
            # a clone: the in-place instruments update their input, and on
            # the CPU from_world shares the tensor's memory
            x_native = from_world(built.example_input.clone()).reshape(n, -1)
            got = from_world(built.step(built.example_input)).reshape(n, -1)
            # integers compose in the native dtype so wraparound matches
            want = x_native if is_int else x_native.astype(np.float64)
            for _ in range(iters):
                want = model(want)
            n_bad, worst = _compare(got, want, rtol)
            if not n_bad:
                results.append(SelftestResult(op, "ok", f"max abs err {worst:.2e}"))
            else:
                results.append(SelftestResult(
                    op, "fail", f"{n_bad}/{got.size} elements off "
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
