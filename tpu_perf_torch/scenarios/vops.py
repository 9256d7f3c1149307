"""V-variant collectives: uneven per-rank payloads, lockstep by
construction (port of ``tpu_perf/scenarios/vops.py``).

Every other collective the harness sweeps is balanced, but MoE expert
routing and ragged serving batches make per-rank payloads uneven (arXiv
2006.13112).  These are the JAX package's v-variants, written in the
stacked per-device view of :mod:`tpu_perf_torch.arena.spmd`:

* ``allgatherv`` -- ring allgather where rank ``r`` contributes
  ``counts[r]`` elements (row ``nbytes`` = the gathered total);
* ``reduce_scatter_v`` -- ring reduce-scatter where rank ``j`` receives
  the reduced ``counts[j]``-element block (row ``nbytes`` = the per-rank
  input buffer);
* ``all_to_all_v`` -- the imbalanced all-to-all (and its inverse) the MoE
  dispatch/combine scenario composes;
* ``seg_allreduce`` -- the segmented allreduce: the first ``ceil(n /
  ratio)`` of n segments reduced, the rest carried untouched.

**Imbalance model.**  Counts derive from the static rank count and one
ratio (``--imbalance``): every rank carries one base chunk except the
LAST rank, which carries ``ratio`` chunks (the hot expert; also the skew
axis' straggler).

**Lockstep.**  Per-rank payload sizes are static Python ints drawn from
the counts table; ranks whose block shares a size share one permutation
that lists exactly the ranks moving data that round; every rank runs
every permutation (across processes, every rank derives the same
``v_counts`` and so posts matched sends and receives), and a rank outside
a size group reads and writes back a clamped don't-care window that the
per-rank select discards.
"""

from __future__ import annotations

import torch

from tpu_perf_torch.arena import spmd

#: the standalone v-variant kernels build_op resolves through this
#: module: the PR-15 pair, the promoted standalone all_to_all_v (the
#: scenario-internal a2av machinery as a first-class op), and the
#: generalized segmented allreduce (arXiv 2004.09362's
#: gradient-compression shape: reduce the selected segment prefix,
#: carry the rest untouched — its --imbalance coordinate is the
#: DENSITY ratio, selecting ceil(n/ratio) of n segments)
V_OPS = ("allgatherv", "reduce_scatter_v", "all_to_all_v",
         "seg_allreduce")

#: ops that accept the --imbalance axis (compose.py adds "scenario")
IMBALANCE_OPS = V_OPS


def imbalance_weights(n: int, ratio: int) -> tuple[int, ...]:
    """Per-rank chunk weights for ``ratio`` on ``n`` ranks: one base
    chunk everywhere, ``ratio`` chunks on the LAST rank (the hot seat —
    the same rank the skew axis prices as the straggler)."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if int(ratio) != ratio or ratio < 1:
        raise ValueError(
            f"imbalance ratio must be an integer >= 1 (max/min per-rank "
            f"payload), got {ratio!r}"
        )
    if n == 1:
        return (int(ratio),)
    return (1,) * (n - 1) + (int(ratio),)


def v_counts(op: str, nbytes: int, n: int, itemsize: int,
             ratio: int) -> tuple[tuple[int, ...], tuple[int, ...], int, int]:
    """Per-rank element counts for ``op`` at row size ``nbytes``.

    Returns ``(counts, offsets, elems_per_device, actual_nbytes)`` —
    ``elems_per_device`` is the static shard every device holds (the
    max count: smaller contributions ride the valid prefix), and
    ``actual_nbytes`` reports the op's size semantics after rounding
    (allgatherv: the gathered total; reduce_scatter_v /
    ``all_to_all_v`` / ``seg_allreduce``: the per-device input
    buffer), exactly like ``ops.payload_elems``.

    Per op, the table means:

    * ``allgatherv`` / ``reduce_scatter_v`` — per-rank contribution /
      destination counts (the hot LAST rank carries ``ratio`` chunks).
    * ``all_to_all_v`` — per-SOURCE block sizes (source ``r`` ships
      one ``counts[r]`` block to every destination) and the
      destination-side receive offsets, source order (``a2av``'s
      layout, promoted).
    * ``seg_allreduce`` — the SELECTED segments: the payload splits
      into ``n`` equal segments and ``ratio`` is the density knob,
      selecting the first ``ceil(n / ratio)`` of them (a contiguous
      prefix — pinned here because the bodies reduce ``sum(counts)``
      elements in one slice); ``ratio == 1`` is the full allreduce.
    """
    if op not in V_OPS:
        raise ValueError(f"not a v-variant op: {op!r} (v-ops: {V_OPS})")
    want = max(1, -(-int(nbytes) // itemsize))
    if op == "seg_allreduce":
        seg = max(1, -(-want // n))
        k = -(-n // int(ratio))  # selected segments: the density knob
        counts = (seg,) * k
        offsets = tuple(j * seg for j in range(k))
        return counts, offsets, n * seg, n * seg * itemsize
    weights = imbalance_weights(n, ratio)
    if op == "all_to_all_v":
        maxw = max(weights)
        # each source ships n equal per-destination blocks; the static
        # per-device buffer must hold the HOT source's send layout
        b = max(1, want // (n * maxw))
        blocks = tuple(b * w for w in weights)
        roffsets = tuple(sum(blocks[:r]) for r in range(n))
        elems = n * b * maxw
        return blocks, roffsets, elems, elems * itemsize
    unit = sum(weights)
    c = max(1, -(-want // unit))
    counts = tuple(c * w for w in weights)
    offsets = tuple(sum(counts[:r]) for r in range(n))
    total = sum(counts)
    # the static per-device shard: allgatherv holds its contribution in
    # a max-count window (smaller ranks use the valid prefix);
    # reduce_scatter_v's input is the whole concatenated destination
    # layout (the reduce_scatter per-device-buffer convention)
    elems = max(counts) if op == "allgatherv" else total
    return counts, offsets, elems, total * itemsize


def _count_groups(counts) -> list[tuple[int, list[int]]]:
    """Origins grouped by block size (static), smallest first: one
    ppermute per (round, size) instead of one per origin."""
    groups: dict[int, list[int]] = {}
    for j, c in enumerate(counts):
        groups.setdefault(int(c), []).append(j)
    return sorted(groups.items())




def own_window(g, rk, offsets, width, axis):
    """The carry-back slice: the ``width`` window of ``g`` at each rank's
    own offset (the native body's carry-the-own-shard-back contract at
    uneven offsets)."""
    return spmd.dslice(g, spmd.take(offsets, rk.axis_index(axis)), width)


def write_back_own_block(x, s, counts, offsets, rk, axis):
    """``x`` with each rank's own block (``counts[idx]`` elements at
    ``offsets[idx]``) replaced by the valid prefix of ``s``, per size
    group (a copy; the reduce_scatter_v in-place-update contract)."""
    idx = rk.axis_index(axis)
    offs = spmd.take(offsets, idx)
    x = x.clone()
    for c, dests in _count_groups(counts):
        cur = spmd.dslice(x, offs, c)
        merged = spmd.where(spmd.member(idx, dests), s[:, :c], cur)
        spmd.dwrite(x, merged, offs)
    return x


def _ordered_groups(counts, largest_first):
    """The per-round issue order of the size groups: smallest-first by
    default (the PR-15 native schedule), largest-first for the
    ``sortring`` arena variant — the hot block leads the round so its
    long wire occupancy overlaps the small-group bookkeeping instead
    of trailing it.  Same groups, same permutations, same bytes:
    numerics are order-invariant (disjoint destinations)."""
    groups = _count_groups(counts)
    return list(reversed(groups)) if largest_first else groups


def gatherv(x, rk, axis, n, counts, offsets, *, largest_first=False):
    """Ring allgatherv: ``x`` holds each rank's contribution in its first
    ``counts[idx]`` elements; returns the gathered ``(rows,
    sum(counts))`` assembly in rank order.  At round ``s`` origin ``r``'s
    block moves one hop, from rank ``(r+s) % n`` to ``(r+s+1) % n``;
    ``largest_first`` flips the per-round size-group order (the
    ``sortring`` variant)."""
    total = sum(counts)
    idx = rk.axis_index(axis)
    out = x.new_zeros(x.shape[0], total)
    # seed: every rank places its own block at its own offset
    for r in range(n):
        o, c = offsets[r], counts[r]
        out[:, o:o + c] = spmd.where(idx == r, x[:, :c], out[:, o:o + c])
    for s in range(n - 1):
        for c, origins in _ordered_groups(counts, largest_first):
            perm = [(int((r + s) % n), int((r + s + 1) % n))
                    for r in origins]
            # the block I forward: origin (idx - s)
            send = spmd.dslice(out, spmd.take(offsets, (idx - s) % n), c)
            recv = rk.ppermute(send, axis, perm)
            # the block I receive: origin (idx - 1 - s)
            o_recv = spmd.take(offsets, (idx - 1 - s) % n)
            cur = spmd.dslice(out, o_recv, c)
            is_dst = spmd.member(idx, [d for _, d in perm])
            spmd.dwrite(out, spmd.where(is_dst, recv, cur), o_recv)
    return out


def reduce_scatter_v_sum(x, rk, axis, n, counts, offsets, *,
                         largest_first=False):
    """Ring reduce-scatter-v: ``x`` is each rank's ``(sum(counts),)``
    input (destination ``j``'s block at ``offsets[j]``); returns the
    UNSCALED reduced own block, zero-padded to ``max(counts)``.  The
    partial for destination ``j`` is born at rank ``(j+1) % n`` and hops
    the +1 ring, each host folding in its local block."""
    idx = rk.axis_index(axis)
    maxc = max(counts)
    groups = _ordered_groups(counts, largest_first)
    acc = x.new_zeros(x.shape[0], maxc)
    # init: the partial I send at round 0 is my local block for
    # destination (idx - 1)
    for c, dests in groups:
        holders = [int((j + 1) % n) for j in dests]
        blk = spmd.dslice(x, spmd.take(offsets, (idx - 1) % n), c)
        acc = spmd.where(spmd.member(idx, holders), spmd.pad_to(blk, maxc),
                         acc)
    for s in range(n - 1):
        new_acc = x.new_zeros(x.shape[0], maxc)
        for c, dests in groups:
            perm = [(int((j + 1 + s) % n), int((j + 2 + s) % n))
                    for j in dests]
            recv = rk.ppermute(acc[:, :c].contiguous(), axis, perm)
            # receivers fold their local block for the arriving
            # destination (idx - 2 - s) into the partial
            local = spmd.dslice(x, spmd.take(offsets, (idx - 2 - s) % n),
                                c)
            receivers = [d for _, d in perm]
            new_acc = spmd.where(spmd.member(idx, receivers),
                                 spmd.pad_to(recv + local, maxc), new_acc)
        acc = new_acc
    return acc


def a2av(x, rk, axis, n, blocks, roffsets, *, inverse=False):
    """Imbalanced all-to-all (MoE dispatch) and its inverse (combine).

    Forward: source ``r``'s payload is ``n`` equal blocks of
    ``blocks[r]`` elements; destination ``d`` receives one block per
    source, placed in source order at ``roffsets``.  Inverse: every rank
    returns each received block to its source, at the source's
    per-destination layout.  The tail beyond the layouts is carried
    through untouched.  Per round ``s`` sources shift their block for
    destination ``(src + s) % n``, grouped by block size."""
    idx = rk.axis_index(axis)
    out = x.clone()
    groups = _count_groups(blocks)
    for s in range(n):
        for b, srcs in groups:
            if not inverse:
                send = spmd.dslice(x, ((idx + s) % n) * b, b)
                if s == 0:
                    recv, receivers = send, srcs  # own block: no hop
                else:
                    perm = [(int(r), int((r + s) % n)) for r in srcs]
                    recv = rk.ppermute(send, axis, perm)
                    receivers = [d for _, d in perm]
                o_recv = spmd.take(roffsets, (idx - s) % n)
            else:
                # return the block received from source (idx - s) to it;
                # it lands at the source's slot for this rank
                send = spmd.dslice(x, spmd.take(roffsets, (idx - s) % n),
                                   b)
                if s == 0:
                    recv, receivers = send, srcs
                else:
                    perm = [(int((r + s) % n), int(r)) for r in srcs]
                    recv = rk.ppermute(send, axis, perm)
                    receivers = srcs
                o_recv = ((idx + s) % n) * b
            cur = spmd.dslice(out, o_recv, b)
            spmd.dwrite(out, spmd.where(spmd.member(idx, receivers), recv,
                                        cur), o_recv)
    return out


def a2av_layout(k: int, n: int, ratio: int) -> tuple[tuple[int, ...],
                                                     tuple[int, ...]]:
    """Block sizes and receive offsets for an a2av over a ``k``-element
    working buffer: ``blocks[r]`` is source ``r``'s per-destination
    block, ``roffsets`` the destination-side placement (source order).
    Needs ``k >= n * ratio`` so the hot source's payload fits."""
    weights = imbalance_weights(n, ratio)
    b = k // (n * max(weights))
    if b < 1:
        raise ValueError(
            f"a2av needs at least n*ratio = {n * max(weights)} elements "
            f"per device, got {k}"
        )
    blocks = tuple(b * w for w in weights)
    roffsets = tuple(sum(blocks[:r]) for r in range(n))
    return blocks, roffsets


def _axis_of(axes):
    # a tuple of axis names linearizes row-major, so the one-axis
    # schedule runs unchanged over a whole multi-axis mesh
    return axes[0] if len(axes) == 1 else tuple(axes)


def v_body_builder(op: str):
    """A builder for a v-variant kernel: ``make(rk, axes, n, elems,
    counts, offsets, dtype) -> body``, wrapping the schedule in the
    native op's carry contract (gather -> carry the own window back;
    reduce-scatter -> fold the own reduced block into the carry)."""
    if op == "allgatherv":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            axis = _axis_of(axes)

            def body(x):
                g = gatherv(x, rk, axis, n, counts, offsets)
                return own_window(g, rk, offsets, elems, axis)

            return body

        return make
    if op == "reduce_scatter_v":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            axis = _axis_of(axes)
            inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)

            def body(x):
                s = reduce_scatter_v_sum(x, rk, axis, n, counts,
                                         offsets) * inv
                return write_back_own_block(x, s, counts, offsets, rk,
                                            axis)

            return body

        return make
    if op == "all_to_all_v":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            axis = _axis_of(axes)

            def body(x):
                # the exchanged buffer IS the carry
                return a2av(x, rk, axis, n, counts, offsets)

            return body

        return make
    if op == "seg_allreduce":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            axis = _axis_of(axes)
            w = sum(counts)  # the selected contiguous prefix
            inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)

            def body(x):
                # reduce the selected segments, carry the tail untouched
                y = rk.psum(x[:, :w].contiguous(), axis) * inv
                return torch.cat([y, x[:, w:]], dim=1)

            return body

        return make
    raise ValueError(f"not a v-variant op: {op!r} (v-ops: {V_OPS})")
