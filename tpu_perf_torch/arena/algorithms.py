"""Hand-built collective decompositions, raced against the native library
call (port of ``tpu_perf/arena/algorithms.py``).

The harness measures each library collective as a black box; the
optimized-collective literature is about choosing the decomposition:
latency-optimal algorithms (fewest rounds) win at small messages,
bandwidth-optimal ones (least bytes per link) at large, and the crossover
is an empirical fact of the card and its links.  These are the JAX
package's decompositions, built from point-to-point permutations
(:mod:`tpu_perf_torch.arena.spmd`: a row permutation in the sim world, a
``batch_isend_irecv`` across processes), so the existing harness sweeps
them head to head against the native call per (op, nbytes, world).

Algorithm catalog (``ARENA_ALGORITHMS``; rounds r, message sizes for a
per-rank buffer of m bytes on n ranks):

=========  ============================  =========================  =====
algorithm  construction                  rounds x bytes/round       n
=========  ============================  =========================  =====
ring       reduce_scatter + allgather    2(n-1) x m/n               any
           over the +1 ring
rhd        recursive halving / doubling  log2(n) x m/2^k halving,   2^k
                                         log2(n) x m*2^k/n doubling
bruck      Bruck allgather: round k      ceil(log2 n) x 2^k blocks  any
           ships the first 2^k blocks    + one local rotation
           to rank-2^k
binomial   binomial-tree reduce to rank  2*ceil(log2 n) x m         any
           0 + binomial broadcast back
=========  ============================  =========================  =====

``all_to_all`` joins with the shifted-exchange ring (n-1 rounds, one 1/n
block a rank a round).

Numerics: the movement algorithms (the allgather family, all_to_all) are
bit-identical to the native op; the reducing ones compute the same mean
in another association order, so they match the JAX package's same
algorithm exactly where the arithmetic is exact and the native op within
the dtype's rounding.

Every algorithm is written in the stacked per-device view: ``x`` is a
``(rows, ...)`` tensor, per-rank choices are :func:`spmd.where` on the
axis index, and every rank runs every permutation (the JAX package's R2
lockstep contract).  Round counts and permutations derive only from the
static rank count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_perf_torch.arena import spmd
from tpu_perf_torch.topology import ring_permutation

#: the algorithm name native rows carry implicitly (the row renders it as
#: the empty algo column, so pre-arena rows stay byte-identical)
NATIVE_ALGO = "native"

#: the collectives the arena decomposes (the ops whose native bodies live
#: in ops.collectives under the same names)
ARENA_COLLECTIVES = ("allreduce", "all_gather", "reduce_scatter",
                     "all_to_all")


def _pad_to_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each rank's ``(m,)`` buffer zero-padded to a multiple of n and
    reshaped ``(n, chunk)``: an allreduce payload is not rounded to the
    rank count (the native op has no such constraint), so the block
    algorithms pad virtually; the pad rides the transport and is sliced
    off by the caller."""
    rows, m = x.shape
    chunk = -(-m // n)
    if chunk * n != m:
        x = torch.cat([x, x.new_zeros(rows, chunk * n - m)], dim=1)
    return x.reshape(rows, n, chunk)


# --- ring: the bandwidth-optimal 2(n-1)-round pipeline ---------------


def _ring_reduce_block(xb, rk, axis, n):
    """The ring reduce-scatter phase: ``xb`` is each rank's ``(n,
    chunk)`` input; after n-1 neighbour hops (+1 ring) returns the
    fully-reduced block ``idx`` (unscaled sum).  Step s sends the running
    partial for block (idx-1-s) to rank idx+1 and folds the received
    partial into the local copy of block (idx-2-s)."""
    if n == 1:
        return xb[:, 0]
    idx = rk.axis_index(axis)
    perm = ring_permutation(n)
    acc = spmd.dget(xb, (idx - 1) % n)
    for step in range(n - 1):
        recv = rk.ppermute(acc, axis, perm)
        acc = spmd.dget(xb, (idx - 2 - step) % n) + recv
    return acc


def _ring_gather_blocks(block, rk, axis, n):
    """The ring allgather phase: every rank contributes its ``block``
    (row ``idx``); n-1 hops later every rank holds the full ``(n,
    chunk)`` assembly."""
    idx = rk.axis_index(axis)
    rows = block.shape[0]
    buf = block.new_zeros(rows, n, *block.shape[1:])
    ar = spmd.rows_index(rk)
    buf[ar, idx] = block
    if n == 1:
        return buf
    send = block
    perm = ring_permutation(n)
    for step in range(n - 1):
        recv = rk.ppermute(send, axis, perm)
        buf[ar, (idx - 1 - step) % n] = recv
        send = recv
    return buf


def _ring_allreduce_sum(x, rk, axis, n):
    m = x.shape[1]
    xb = _pad_to_blocks(x, n)
    block = _ring_reduce_block(xb, rk, axis, n)
    return _ring_gather_blocks(block, rk, axis, n).reshape(
        x.shape[0], -1)[:, :m]


def _ring_allgather(x, rk, axis, n):
    return _ring_gather_blocks(x, rk, axis, n).reshape(x.shape[0], -1)


def _ring_reduce_scatter_sum(x, rk, axis, n):
    # reduce_scatter payloads are already rounded to a multiple of n
    # (ops.payload_elems), as the native reduce_scatter's are
    return _ring_reduce_block(x.reshape(x.shape[0], n, -1), rk, axis, n)


# --- rhd: recursive halving / doubling (power-of-two worlds) ---------


def _halving_reduce(x, rk, axis, n):
    """Recursive-halving reduce-scatter: log2(n) rounds, each exchanging
    half the remaining buffer with the partner at rank distance h (n/2,
    n/4, ..., 1).  Returns block ``idx`` (unscaled sum)."""
    idx = rk.axis_index(axis)
    buf = x
    h = n // 2
    while h >= 1:
        perm = [(i, i ^ h) for i in range(n)]
        half = buf.shape[1] // 2
        lower, upper = buf[:, :half], buf[:, half:]
        in_upper = (idx // h) % 2  # 1: my block is in the upper half
        send = spmd.where(in_upper == 0, upper, lower)
        keep = spmd.where(in_upper == 0, lower, upper)
        recv = rk.ppermute(send, axis, perm)
        buf = keep + recv
        h //= 2
    return buf


def _doubling_allgather(x, rk, axis, n):
    """Recursive-doubling allgather: log2(n) rounds with partner distance
    1, 2, 4, ...; each round doubles the held segment, ordered by rank
    bit so the final buffer is blocks 0..n-1 in order."""
    idx = rk.axis_index(axis)
    buf = x
    h = 1
    while h < n:
        perm = [(i, i ^ h) for i in range(n)]
        recv = rk.ppermute(buf, axis, perm)
        mine_lower = (idx // h) % 2 == 0
        buf = spmd.where(mine_lower, torch.cat([buf, recv], dim=1),
                         torch.cat([recv, buf], dim=1))
        h *= 2
    return buf


def _rhd_allreduce_sum(x, rk, axis, n):
    m = x.shape[1]
    xb = _pad_to_blocks(x, n).reshape(x.shape[0], -1)
    return _doubling_allgather(_halving_reduce(xb, rk, axis, n), rk, axis,
                               n)[:, :m]


def _rhd_allgather(x, rk, axis, n):
    return _doubling_allgather(x, rk, axis, n)


def _rhd_reduce_scatter_sum(x, rk, axis, n):
    return _halving_reduce(x, rk, axis, n)


# --- bruck: latency-optimal allgather (any n) ------------------------


def _bruck_blocks(x, rk, axis, n):
    """Bruck's concatenation allgather, unrotated: round k ships the first
    min(2^k, n-2^k) accumulated blocks to rank idx-2^k, appending what
    arrives from idx+2^k; after ceil(log2 n) rounds position p holds
    block (idx+p) mod n."""
    buf = x.new_zeros(x.shape[0], n, *x.shape[1:])
    buf[:, 0] = x
    k = 1
    while k < n:
        cnt = min(k, n - k)
        perm = [(i, (i - k) % n) for i in range(n)]
        recv = rk.ppermute(buf[:, :cnt].contiguous(), axis, perm)
        buf[:, k:k + cnt] = recv
        k *= 2
    return buf


def _bruck_allgather(x, rk, axis, n):
    idx = rk.axis_index(axis)
    # position p holds block (idx+p): one local rotation restores rank
    # order (jnp.roll by idx: out[q] = buf[(q - idx) mod n])
    blocks = _bruck_blocks(x, rk, axis, n)
    q = (torch.arange(n, device=x.device)[None, :] - idx[:, None]) % n
    ar = spmd.rows_index(rk)[:, None]
    return blocks[ar, q].reshape(x.shape[0], -1)


def _bruck_allreduce_sum(x, rk, axis, n):
    # allgather, then a local reduce: every rank gathers all n
    # contributions in ceil(log2 n) rounds and sums them, position by
    # position in the dtype as XLA's reduce does (the sum is
    # rotation-invariant, so the unrotated stack is summed directly)
    blocks = _bruck_blocks(x, rk, axis, n)
    acc = blocks[:, 0]
    for p in range(1, n):
        acc = acc + blocks[:, p]
    return acc


# --- ring all_to_all: n-1 shifted exchange rounds (any n) ------------


def _ring_all_to_all(x, rk, axis, n):
    """Shifted-exchange all-to-all: round ``s`` every rank ships its
    block for destination ``idx+s`` directly via the +s rotation; n-1
    rounds, each moving one 1/n block a rank (output block ``j`` is the
    piece source ``j`` addressed to this rank, as the native op's)."""
    idx = rk.axis_index(axis)
    rows = x.shape[0]
    xb = x.reshape(rows, n, -1)
    out = torch.zeros_like(xb)
    ar = spmd.rows_index(rk)
    out[ar, idx] = spmd.dget(xb, idx)  # own block: no hop
    for s in range(1, n):
        perm = [(i, (i + s) % n) for i in range(n)]
        send = spmd.dget(xb, (idx + s) % n)
        recv = rk.ppermute(send, axis, perm)
        out[ar, (idx - s) % n] = recv
    return out.reshape(rows, -1)


# --- binomial: latency-optimal reduce + broadcast trees (any n) ------


def _binomial_reduce(x, rk, axis, n):
    """Binomial-tree reduce to rank 0: round k pairs rank i+k -> i for i
    in multiples of 2k.  A rank no pair addresses receives zeros, so the
    fold is unconditional."""
    y = x
    k = 1
    while k < n:
        perm = [(i + k, i) for i in range(0, n - k, 2 * k)]
        recv = rk.ppermute(y, axis, perm)
        y = y + recv
        k *= 2
    return y


def _binomial_broadcast(y, rk, axis, n):
    """Binomial-tree broadcast from rank 0 (round k sends [0, 2^k) ->
    [2^k, 2^(k+1)))."""
    idx = rk.axis_index(axis)
    k = 1
    while k < n:
        perm = [(i, i + k) for i in range(k) if i + k < n]
        recv = rk.ppermute(y, axis, perm)
        y = spmd.where((idx >= k) & (idx < min(2 * k, n)), recv, y)
        k *= 2
    return y


def _binomial_allreduce_sum(x, rk, axis, n):
    return _binomial_broadcast(_binomial_reduce(x, rk, axis, n), rk, axis,
                               n)


def _binomial_reduce_scatter_sum(x, rk, axis, n):
    # reduce the whole buffer down and up the tree, keep the own shard
    idx = rk.axis_index(axis)
    full = _binomial_allreduce_sum(x, rk, axis, n)
    shard = x.shape[1] // n
    return spmd.dslice(full, idx * shard, shard)


# --- registry --------------------------------------------------------

#: transport functions per (collective, algo).  Reducing entries return
#: the UNSCALED sum (the body scales by 1/n as the native bodies do);
#: allgather entries return the gathered ``(rows, n*shard)`` buffer.
_SUM_ALLREDUCE = {
    "ring": _ring_allreduce_sum,
    "rhd": _rhd_allreduce_sum,
    "bruck": _bruck_allreduce_sum,
    "binomial": _binomial_allreduce_sum,
}
_ALLGATHER = {
    "ring": _ring_allgather,
    "rhd": _rhd_allgather,
    "bruck": _bruck_allgather,
}
_SUM_REDUCE_SCATTER = {
    "ring": _ring_reduce_scatter_sum,
    "rhd": _rhd_reduce_scatter_sum,
    "binomial": _binomial_reduce_scatter_sum,
}
_A2A = {
    "ring": _ring_all_to_all,
}

#: algorithms whose pairing math needs a power-of-two rank count
POW2_ONLY = frozenset({"rhd"})


def _make_body_builder(collective: str, algo: str) -> Callable:
    """A builder ``(rk, axis, n, elems, dtype) -> body`` wrapping the
    algorithm in the native op's carry convention (the mean for
    allreduce, the own shard back for all_gather, the own chunk updated
    in place for reduce_scatter, the exchanged buffer for all_to_all), so
    the step drops into ``build_op``'s chain unchanged.  ``body`` maps
    the ``(rows, elems)`` carry to the next one."""

    def make(rk, axis, n, elems, dtype):
        inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)
        if collective == "allreduce":
            fn = _SUM_ALLREDUCE[algo]

            def body(x):
                return fn(x, rk, axis, n) * inv

        elif collective == "all_gather":
            fn = _ALLGATHER[algo]

            def body(x):
                # gather, then carry the own shard back (the native
                # body's contract)
                g = fn(x, rk, axis, n)
                idx = rk.axis_index(axis)
                return spmd.dslice(g, idx * x.shape[1], x.shape[1])

        elif collective == "all_to_all":
            fn = _A2A[algo]

            def body(x):
                return fn(x, rk, axis, n)

        else:  # reduce_scatter
            fn = _SUM_REDUCE_SCATTER[algo]

            def body(x):
                s = fn(x, rk, axis, n) * inv
                idx = rk.axis_index(axis)
                return spmd.dupdate(x, s, idx * s.shape[1])

        return body

    return make


@dataclasses.dataclass(frozen=True)
class ArenaAlgorithm:
    """One registered (collective, algorithm) decomposition."""

    collective: str
    algo: str
    builder: Callable  # (rk, axis, n, elems, dtype) -> body
    pow2_only: bool = False
    summary: str = ""


def _build_registry() -> dict[tuple[str, str], ArenaAlgorithm]:
    summaries = {
        "ring": "reduce_scatter + allgather over the +1 ring "
                "(bandwidth-optimal, 2(n-1) rounds)",
        "rhd": "recursive halving/doubling (bandwidth-optimal at "
               "log2(n) rounds; power-of-two meshes)",
        "bruck": "Bruck doubling-block allgather + local rotation "
                 "(latency-optimal, ceil(log2 n) rounds)",
        "binomial": "binomial-tree reduce + broadcast (latency-optimal "
                    "small-message variant)",
    }
    reg: dict[tuple[str, str], ArenaAlgorithm] = {}
    for coll, table in (("allreduce", _SUM_ALLREDUCE),
                        ("all_gather", _ALLGATHER),
                        ("reduce_scatter", _SUM_REDUCE_SCATTER),
                        ("all_to_all", _A2A)):
        for algo in table:
            reg[(coll, algo)] = ArenaAlgorithm(
                collective=coll, algo=algo,
                builder=_make_body_builder(coll, algo),
                pow2_only=algo in POW2_ONLY,
                summary=summaries[algo],
            )
    return reg


#: the registry: (collective, algorithm) -> ArenaAlgorithm
ARENA_ALGORITHMS: dict[tuple[str, str], ArenaAlgorithm] = _build_registry()

#: every registered algorithm name, stable order
ALGORITHM_NAMES: tuple[str, ...] = tuple(sorted(
    {a for _, a in ARENA_ALGORITHMS}))


def algorithms_for(collective: str) -> tuple[str, ...]:
    """Registered algorithm names for one collective (sorted)."""
    return tuple(sorted(a for c, a in ARENA_ALGORITHMS if c == collective))


def is_compatible(collective: str, algo: str, n_devices: int) -> bool:
    entry = ARENA_ALGORITHMS.get((collective, algo))
    if entry is None:
        return False
    return not (entry.pow2_only and n_devices & (n_devices - 1))


def arena_body_builder(collective: str, algo: str, n_devices: int
                       ) -> Callable:
    """The body builder for one (collective, algorithm) pair; raises the
    loud, specific error for every way the pair can be wrong."""
    if collective not in ARENA_COLLECTIVES:
        raise ValueError(
            f"op {collective!r} has no arena decompositions; arena "
            f"collectives: {ARENA_COLLECTIVES}"
        )
    entry = ARENA_ALGORITHMS.get((collective, algo))
    if entry is None:
        raise ValueError(
            f"no {algo!r} decomposition registered for {collective!r}; "
            f"registered: {algorithms_for(collective)}"
        )
    if entry.pow2_only and n_devices & (n_devices - 1):
        raise ValueError(
            f"{collective}@{algo} needs a power-of-two device count "
            f"(recursive halving/doubling pairs ranks by XOR), got "
            f"{n_devices}"
        )
    return entry.builder


def algos_for_op(op: str, n_devices: int, err=None) -> list[str]:
    """Every registered algorithm compatible with ``op`` at this rank
    count: the ``--algo all`` expansion.  Incompatible pow2-only
    algorithms are skipped with a note on ``err`` (an explicit ``--algo
    rhd`` still fails loudly through arena_body_builder)."""
    out = []
    for algo in algorithms_for(op):
        if is_compatible(op, algo, n_devices):
            out.append(algo)
        elif err is not None:
            print(f"[tpu-perf-torch] arena: skipping {op}@{algo} "
                  f"(needs a power-of-two device count, have "
                  f"{n_devices})", file=err)
    return out
