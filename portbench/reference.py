"""The plain reference: what each op's working buffer holds after ``k``
chained executions, worked out again from the benchmark's own input in
plain PyTorch and NumPy, and the widest relative gap between that and
the buffer the timed path produced.

It imports nothing of the program.  What it freezes of the program is
the semantics each op is documented to carry from one execution to the
next (``tpu_perf_torch/ops/pallas_ring.py``'s plain versions and
``ops/collectives.py``'s triad body), which is the benchmark's to hold
the program to:

* ``pl_allreduce``: chunk c of every rank becomes the sum of chunk c over
  the ranks, added from rank c+1 round to rank c, each add rounded to
  float32, times 1/n (the mean; the port's documented carry);
* ``pl_reduce_scatter``: rank d's whole row becomes n copies of that
  scaled sum of chunk d;
* ``pl_all_to_all``: chunk d of rank s goes to slot s of rank d (a
  transpose: an even count of executions returns the input, so a visit
  of it has to hold an odd count to show anything);
* ``pl_hbm_copy`` returns its input (into a buffer of its own);
* ``pl_hbm_write``: each row's first block (2 MiB of float32) tiled over
  the row;
* ``pl_hbm_stream``: ``x * 1.0000001 + 1e-7``, both constants rounded to
  float32 first and each operation rounded;
* ``hbm_triad``: the first half ``a <- a * 1.0000001 + b * 1e-7`` (the
  product ``b * 1e-7`` rounded first), the second half ``b`` unchanged.

The state of the structural ops is worked out in full, block by block,
by replaying the execution until the state repeats (the map is
deterministic, so from a repeat on the orbit is periodic and the rest of
the ``k`` executions are skipped exactly).  The elementwise ops have no
repeat within a run (each execution raises every value), so they are
replayed execution by execution on a sample of positions drawn from the
seed, with each row's edges, in NumPy.  The configurations state float32
and the reference computes in float32.
"""

from __future__ import annotations

import numpy as np
import torch

#: the stream body's constants, rounded to float32 first
STREAM_SCALE = np.float32(1.0000001)
STREAM_SHIFT = np.float32(1e-7)
#: pl_hbm_write's block: the JAX package's stream tile, 524288 float32
WRITE_BLOCK_ELEMS = 524288
#: positions the elementwise ops compare, beside each row's edges
SAMPLE = 4096
#: states a replay keeps to find a repeat
HISTORY = 64
#: bytes of input a block of a structural op holds
BLOCK_BYTES = 32 << 20

COLLECTIVES = ("pl_allreduce", "pl_reduce_scatter", "pl_all_to_all")
IDENTITIES = ("pl_hbm_copy",)
ELEMENTWISE = ("pl_hbm_stream", "hbm_triad")
OPS = COLLECTIVES + IDENTITIES + ("pl_hbm_write",) + ELEMENTWISE
#: ops whose state returns after two executions
PERIOD_TWO = ("pl_all_to_all",)


def replay(step, state: torch.Tensor, k: int) -> torch.Tensor:
    """``state`` after ``k`` applications of ``step``.  The first
    :data:`HISTORY` states are kept; once a new state equals kept state
    p, the orbit repeats with period i - p and state k is read back."""
    seen = [state]
    for i in range(1, k + 1):
        state = step(state)
        if len(seen) == i and i <= HISTORY:
            for p, old in enumerate(seen):
                if torch.equal(old, state):
                    return seen[p + (k - i) % (i - p)]
            seen.append(state)
    return state


def _ring_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` is ``(n ranks, n chunks, b)``; row c of the result is chunk
    c summed from rank c+1 round to rank c, one rounded add at a time."""
    n = x.shape[0]
    c = torch.arange(n, device=x.device)
    acc = x[(c + 1) % n, c]
    for j in range(2, n + 1):
        acc = acc + x[(c + j) % n, c]
    return acc


def _inv(n: int) -> float:
    return float(np.float32(1.0 / n))


def allreduce_step(x: torch.Tensor) -> torch.Tensor:
    v = _ring_sum(x) * _inv(x.shape[0])
    return v.unsqueeze(0).expand_as(x).clone()


def reduce_scatter_step(x: torch.Tensor) -> torch.Tensor:
    s = _ring_sum(x) * _inv(x.shape[0])
    return s.unsqueeze(1).expand_as(x).clone()


def all_to_all_step(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1).contiguous()


_STEPS = {"pl_allreduce": allreduce_step,
          "pl_reduce_scatter": reduce_scatter_step,
          "pl_all_to_all": all_to_all_step}


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative gap; a value that is not a number is infinite."""
    d = (got.to(torch.float32) - want).abs() / want.abs().clamp_min(1e-30)
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def sample_positions(seed: int, length: int) -> np.ndarray:
    """:data:`SAMPLE` positions in ``[0, length)`` drawn from ``seed``,
    with both ends; every position when the row is no longer."""
    if length <= SAMPLE + 2:
        return np.arange(length)
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, length, SAMPLE)
    return np.unique(np.concatenate([pos, [0, length - 1]]))


def stream_replay(a: np.ndarray, k: int) -> np.ndarray:
    a = a.astype(np.float32).copy()
    for _ in range(k):
        np.multiply(a, STREAM_SCALE, out=a)
        np.add(a, STREAM_SHIFT, out=a)
    return a


def triad_replay(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    a = a.astype(np.float32).copy()
    bk = b.astype(np.float32) * STREAM_SHIFT
    for _ in range(k):
        np.multiply(a, STREAM_SCALE, out=a)
        np.add(a, bk, out=a)
    return a


def max_rel_gap(op: str, x0: torch.Tensor, got: torch.Tensor, k: int, *,
                rows: list[int], seed: int) -> float:
    """The widest relative gap between ``got`` and what ``op``'s working
    buffer holds after ``k`` executions from the input ``x0``.

    ``x0`` is the whole world's float32 input, ``(n ranks, elems)`` (one
    row for the local ops); ``got`` holds rows ``rows`` of the program's
    buffer, ``(len(rows), elems)``, on the same device; ``seed`` draws
    the elementwise ops' sample."""
    if op not in OPS:
        raise ValueError(f"no reference for {op!r}; known: {OPS}")
    if k < 1:
        raise ValueError(f"the buffer went through {k} executions")
    n, elems = x0.shape
    got = got.reshape(len(rows), elems)
    if op in IDENTITIES:
        return max(_gap(got[:, lo:lo + _cols(n)], x0[rows, lo:lo + _cols(n)])
                   for lo in range(0, elems, _cols(n)))
    if op == "pl_hbm_write":
        block = min(WRITE_BLOCK_ELEMS, elems)
        out = 0.0
        for lo in range(0, elems, _cols(n)):
            idx = torch.arange(lo, min(elems, lo + _cols(n)),
                               device=x0.device) % block
            out = max(out, _gap(got[:, lo:lo + _cols(n)], x0[:, idx][rows]))
        return out
    if op in COLLECTIVES:
        chunk = elems // n
        xs, gs = x0.view(n, n, chunk), got.view(len(rows), n, chunk)
        b = max(1, _cols(n) // n)
        out = 0.0
        for lo in range(0, chunk, b):
            want = replay(_STEPS[op], xs[:, :, lo:lo + b].contiguous(), k)
            out = max(out, _gap(gs[:, :, lo:lo + b], want[rows]))
        return out
    if op == "pl_hbm_stream":
        pos = sample_positions(seed, elems)
        idx = torch.from_numpy(pos).to(x0.device)
        want = stream_replay(x0[:, idx][rows].cpu().numpy(), k)
        return _gap(got[:, idx].cpu(), torch.from_numpy(want))
    # hbm_triad: the first half replayed on the sample, the second whole
    half = elems // 2
    pos = sample_positions(seed, half)
    idx = torch.from_numpy(pos).to(x0.device)
    a = x0[:, idx][rows].cpu().numpy()
    b = x0[:, idx + half][rows].cpu().numpy()
    out = _gap(got[:, idx].cpu(), torch.from_numpy(triad_replay(a, b, k)))
    return max(out, *(_gap(got[:, lo:lo + _cols(n)], x0[rows, lo:lo + _cols(n)])
                      for lo in range(half, elems, _cols(n))))


def _cols(n: int) -> int:
    # columns of an (n, elems) float32 state that fill a block
    return max(1, BLOCK_BYTES // (4 * n))
