"""Optimized irregular-payload schedules: the v-variant arena registry
(port of ``tpu_perf/arena/valgos.py``).

The v-side twin of :mod:`tpu_perf_torch.arena.algorithms`: hand-built
uneven-payload decompositions (arXiv 2006.13112; arXiv 2004.09362's
segmented allreduce), all static permutation schedules derived from the
counts table and the rank count only, with the carry and sizing of every
arena algorithm, written in the stacked per-device view of
:mod:`tpu_perf_torch.arena.spmd`.

Schedule catalog (``V_ALGORITHMS``; n ranks, counts table c_r):

=============== ========== ==============================================
op              algo       construction
=============== ========== ==============================================
allgatherv      sortring   the per-origin ring with size groups issued
                           largest-first each round
allgatherv      doubling   Bruck-style doubling in absolute offsets:
                           ceil(log2 n) rounds vs the ring's n-1
allgatherv      vhier      on a 2-axis (slow, fast) mesh: the slow-axis
                           v-exchange first (per-slot counts padded to
                           the slice-wise max), then the fast-axis
                           v-gather of the bundles; keyed per mesh-axis
                           tuple like ``hier-*``
reduce_scatter_v sortring  the reduce ring, size groups largest-first
all_to_all_v    ring       store-and-forward +1 ring: origin r's run
                           shrinks one block a hop
all_to_all_v    doubling   Bruck all-to-all on blocks padded to the max
                           block: ceil(log2 n) stacked-slot rounds
seg_allreduce   ring/rhd/  the flat allreduce transports on the selected
                bruck/     segment prefix; the tail rides the carry
                binomial
=============== ========== ==============================================

Movement algorithms are bit-identical to the native v-schedule; reducing
ones match within the reduction order's rounding.  The wire models
(``*_wire_elems``) count the elements crossing the wire per execution,
summed over ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_perf_torch.arena import spmd
from tpu_perf_torch.arena.algorithms import _SUM_ALLREDUCE, POW2_ONLY
from tpu_perf_torch.topology import format_axis_tuple, parse_axis_tuple

#: the hierarchical v-composition's name prefix (bare request ``vhier``;
#: resolved rows carry the keyed ``vhier:dcn=2+ici=4`` spelling)
VHIER_PREFIX = "vhier"


def _vops():
    from tpu_perf_torch.scenarios import vops

    return vops


# --- sortring: the per-origin ring, big blocks first -----------------


def _sortring_gatherv(x, rk, axis, n, counts, offsets):
    return _vops().gatherv(x, rk, axis, n, counts, offsets,
                           largest_first=True)


def _sortring_reduce_scatter_v(x, rk, axis, n, counts, offsets):
    return _vops().reduce_scatter_v_sum(x, rk, axis, n, counts, offsets,
                                        largest_first=True)


# --- doubling: Bruck-style allgatherv in absolute offsets ------------


def _doubling_gatherv(x, rk, axis, n, counts, offsets):
    """Bruck-style doubling allgatherv: rank i's held window after round k
    is origins [i, i+2^(k+1)), cyclically contiguous in the absolute
    layout, so round k ships one slice of static width per sender group
    (senders grouped by their window's sum).  ceil(log2 n) rounds."""
    total = sum(counts)
    idx = rk.axis_index(axis)
    rows = x.shape[0]
    out = x.new_zeros(rows, total)
    for r in range(n):
        o, c = offsets[r], counts[r]
        out[:, o:o + c] = spmd.where(idx == r, x[:, :c], out[:, o:o + c])
    pos = torch.arange(total, device=x.device)[None, :]
    w = 1
    while w < n:
        cnt = min(w, n - w)  # origins shipped this round (Bruck's cap)
        wsum = [sum(counts[(i + t) % n] for t in range(cnt))
                for i in range(n)]
        groups: dict[int, list[int]] = {}
        for i, width in enumerate(wsum):
            groups.setdefault(width, []).append(i)
        for width, senders in sorted(groups.items()):
            perm = [(int(s), int((s - w) % n)) for s in senders]
            # the sent window starts at the sender's own offset; the
            # doubled view makes the cyclic wrap a plain slice
            xx = torch.cat([out, out], dim=1)
            send = spmd.dslice(xx, spmd.take(offsets, idx), width)
            recv = rk.ppermute(send, axis, perm)
            is_dst = spmd.member(idx, [d for _, d in perm])
            # receivers fold origins [idx+w, idx+w+cnt) in at their
            # offset, wrapping through the doubled view
            o = spmd.take(offsets, (idx + w) % n)
            cur = spmd.dslice(xx, o, width)
            spmd.dwrite(xx, spmd.where(is_dst, recv, cur), o)
            wrap = (o + width - total).clamp(min=0)[:, None]
            folded = torch.where(pos < wrap, xx[:, total:], xx[:, :total])
            out = spmd.where(is_dst, folded, out)
        w *= 2
    return out


# --- all_to_all_v ring: store-and-forward, one block peeled per hop --


def _ring_a2av(x, rk, axis, n, blocks, roffsets):
    """Store-and-forward a2av over the +1 ring: origin r's outgoing run
    (its n-1 destination blocks in cyclic order) hops the ring; at round
    t rank (r+t) peels its own block off the front and forwards the
    remaining (n-1-t) blocks."""
    vops = _vops()
    idx = rk.axis_index(axis)
    rows = x.shape[0]
    maxb = max(blocks)
    groups = vops._count_groups(blocks)
    out = x.clone()
    # own block (destination = self) never travels
    o_own = spmd.take(roffsets, idx)
    for b, srcs in groups:
        blk = spmd.dslice(x, idx * b, b)
        cur = spmd.dslice(out, o_own, b)
        spmd.dwrite(out, spmd.where(spmd.member(idx, srcs), blk, cur),
                    o_own)
    if n == 1:
        return out
    # my outgoing run: destinations idx+1 .. idx+n-1, cyclically
    # contiguous in the first n*b of the send layout (doubled view)
    run = x.new_zeros(rows, (n - 1) * maxb)
    for b, srcs in groups:
        xx = torch.cat([x[:, :n * b], x[:, :n * b]], dim=1)
        mine = spmd.dslice(xx, ((idx + 1) % n) * b, (n - 1) * b)
        run = spmd.where(spmd.member(idx, srcs),
                         spmd.pad_to(mine, run.shape[1]), run)
    for t in range(1, n):
        new_run = torch.zeros_like(run)
        for b, origins in groups:
            width = (n - t) * b
            senders = [int((o + t - 1) % n) for o in origins]
            perm = [(s, int((s + 1) % n)) for s in senders]
            recv = rk.ppermute(run[:, :width].contiguous(), axis, perm)
            is_dst = spmd.member(idx, [d for _, d in perm])
            # the peeled head is origin (idx - t)'s block for me
            o_out = spmd.take(roffsets, (idx - t) % n)
            cur = spmd.dslice(out, o_out, b)
            spmd.dwrite(out, spmd.where(is_dst, recv[:, :b], cur), o_out)
            if width > b:
                rest = spmd.pad_to(recv[:, b:], run.shape[1])
                new_run = spmd.where(is_dst, rest, new_run)
        run = new_run
    return out


# --- all_to_all_v doubling: Bruck a2a on padded slots ----------------


def _doubling_a2av(x, rk, axis, n, blocks, roffsets):
    """Bruck all-to-all on blocks padded to the max block: a local
    rotation puts my block for destination (idx+j) in slot j; round k
    ships every slot whose index has bit k set to rank idx+k; after the
    rounds slot j holds the block FROM source (idx-j), placed at the
    receive layout by size group."""
    vops = _vops()
    idx = rk.axis_index(axis)
    rows = x.shape[0]
    maxb = max(blocks)
    groups = vops._count_groups(blocks)
    buf = x.new_zeros(rows, n, maxb)
    for b, srcs in groups:
        slots = torch.stack(
            [spmd.pad_to(spmd.dslice(x, ((idx + j) % n) * b, b), maxb)
             for j in range(n)], dim=1)
        buf = spmd.where(spmd.member(idx, srcs), slots, buf)
    k = 1
    while k < n:
        send_rows = [j for j in range(n) if j & k]
        perm = [(i, int((i + k) % n)) for i in range(n)]
        recv = rk.ppermute(buf[:, send_rows].contiguous(), axis, perm)
        buf[:, send_rows] = recv
        k *= 2
    out = x.clone()
    for j in range(n):
        for b, srcs in groups:
            # slot j came from source (idx - j)
            dsts = [int((s + j) % n) for s in srcs]
            o = spmd.take(roffsets, (idx - j) % n)
            cur = spmd.dslice(out, o, b)
            spmd.dwrite(out, spmd.where(spmd.member(idx, dsts),
                                        buf[:, j, :b], cur), o)
    return out


# --- vhier: the hierarchical allgatherv composition ------------------


def is_vhier(algo: str) -> bool:
    """True for the hierarchical v-composition family (bare ``vhier``
    or a keyed ``vhier:<axis-tuple>`` spelling)."""
    return algo == VHIER_PREFIX or algo.startswith(VHIER_PREFIX + ":")


def _vhier_base_and_key(algo: str) -> tuple[str, str | None]:
    if ":" not in algo:
        return algo, None
    base, key = algo.split(":", 1)
    return base, key


def resolve_vhier(op: str, algo: str, axes, sizes) -> str:
    """Validate a vhier request against the mesh and return the KEYED
    name (``vhier:dcn=2+ici=4``) rows and CompileSpecs carry — the
    resolve_hier contract, v-flavoured.  Raises the loud, specific
    error for every way the request can be wrong."""
    base, key = _vhier_base_and_key(algo)
    if base != VHIER_PREFIX:
        raise ValueError(f"not a vhier algorithm: {algo!r}")
    if op != "allgatherv":
        raise ValueError(
            f"no hierarchical v-composition registered for {op!r}; "
            f"vhier composes allgatherv (cross-slice v-exchange over "
            f"the slow axis, then the in-slice gather)"
        )
    axes = tuple(axes)
    sizes = tuple(int(s) for s in sizes)
    if len(axes) == 1:
        raise ValueError(
            f"vhier needs a 2-axis (slow, fast) mesh and the "
            f"collective axis is flat ({axes[0]}={sizes[0]}): there is "
            f"no slow hop to minimize — run the flat v-schedules there"
        )
    if len(axes) != 2:
        raise ValueError(
            f"vhier composes exactly two phases and needs exactly two "
            f"mesh axes (slow, fast), got {axes}"
        )
    pairs = tuple(zip(axes, sizes))
    keyed = format_axis_tuple(pairs)
    if key is not None and parse_axis_tuple(key) != pairs:
        raise ValueError(
            f"{algo!r} is keyed for another mesh; this job's "
            f"collective axes are {keyed}"
        )
    return f"{VHIER_PREFIX}:{keyed}"


def _vhier_gatherv_builder(rk, axes, axis_sizes, n, elems, counts, offsets,
                           dtype):
    """The vhier allgatherv body: the slow axis first on the small
    per-rank shards (per-slot counts padded to the slice-wise max: the
    pad crosses the slow axis once), then the fast-axis gather of the
    cross-slice bundles, then a local position-major to rank-major
    reorder."""
    vops = _vops()
    slow, fast = axes
    S, F = axis_sizes
    c_base = min(counts)
    total = sum(counts)
    dcn_counts = tuple(max(counts[s * F + j] for j in range(F))
                       for s in range(S))
    dcn_offs = tuple(sum(dcn_counts[:s]) for s in range(S))
    t_widths = tuple(sum(counts[s * F + j] for s in range(S))
                     for j in range(F))
    ici_offs = tuple(sum(t_widths[:j]) for j in range(F))

    def body(x):
        bundle = vops.gatherv(x, rk, slow, S, dcn_counts, dcn_offs)
        asm = vops.gatherv(bundle, rk, fast, F, t_widths, ici_offs)
        g = x.new_zeros(x.shape[0], total)
        for s in range(S):
            for j in range(F):
                src = ici_offs[j] + s * c_base
                dst = offsets[s * F + j]
                wdt = counts[s * F + j]
                g[:, dst:dst + wdt] = asm[:, src:src + wdt]
        idx = rk.axis_index(tuple(axes))
        return spmd.dslice(g, spmd.take(offsets, idx), elems)

    return body


def vhier_body_builder(op: str, algo: str) -> Callable:
    """The body builder for a resolved vhier algorithm:
    ``make(axes, axis_sizes, n, elems, counts, offsets) -> body``."""
    base, _ = _vhier_base_and_key(algo)
    if base != VHIER_PREFIX or op != "allgatherv":
        raise ValueError(
            f"no hierarchical v-composition {algo!r} for {op!r}"
        )
    return _vhier_gatherv_builder


def vhier_algos_for(op: str, mesh_axes, err=None) -> list[str]:
    """The multi-axis ``--algo all`` expansion for a v-op: the keyed
    vhier composition where one is registered, with a skip note where
    none is (the hier_algos_for loudness contract)."""
    pairs = tuple((str(a), int(s)) for a, s in mesh_axes)
    if op != "allgatherv":
        if err is not None:
            print(f"[tpu-perf-torch] arena: {op} has no hierarchical "
                  f"v-composition; racing the native v-schedule only "
                  f"on the multi-axis mesh", file=err)
        return []
    names = tuple(a for a, _ in pairs)
    sizes = tuple(s for _, s in pairs)
    return [resolve_vhier(op, VHIER_PREFIX, names, sizes)]


# --- seg_allreduce: the generalized (segmented) allreduce ------------


def _seg_arena_builder(algo: str):
    """A flat allreduce transport on the selected segment prefix."""
    fn = _SUM_ALLREDUCE[algo]

    def make(rk, axes, n, elems, counts, offsets, dtype):
        (axis,) = axes
        w = sum(counts)
        inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)

        def body(x):
            y = fn(x[:, :w].contiguous(), rk, axis, n) * inv
            return torch.cat([y, x[:, w:]], dim=1)

        return body

    return make


# --- registry --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAlgorithm:
    """One registered (v-op, algorithm) decomposition.  ``builder`` has
    the v-op signature ``(rk, axes, n, elems, counts, offsets, dtype) ->
    body``."""

    op: str
    algo: str
    builder: Callable
    pow2_only: bool = False
    summary: str = ""


def _flat_v_builder(op: str, transport: Callable) -> Callable:
    """Wrap a v-transport in the op's native carry contract."""
    vops_mod = _vops()

    if op == "allgatherv":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            (axis,) = axes

            def body(x):
                g = transport(x, rk, axis, n, counts, offsets)
                return vops_mod.own_window(g, rk, offsets, elems, axis)

            return body

        return make
    if op == "reduce_scatter_v":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            (axis,) = axes
            inv = torch.tensor(1.0 / n, dtype=dtype, device=rk.device)

            def body(x):
                s = transport(x, rk, axis, n, counts, offsets) * inv
                return vops_mod.write_back_own_block(x, s, counts, offsets,
                                                     rk, axis)

            return body

        return make
    if op == "all_to_all_v":

        def make(rk, axes, n, elems, counts, offsets, dtype):
            (axis,) = axes

            def body(x):
                return transport(x, rk, axis, n, counts, offsets)

            return body

        return make
    raise ValueError(f"no flat v-wrapper for {op!r}")


def _build_registry() -> dict[tuple[str, str], VAlgorithm]:
    reg: dict[tuple[str, str], VAlgorithm] = {}
    reg[("allgatherv", "sortring")] = VAlgorithm(
        "allgatherv", "sortring",
        _flat_v_builder("allgatherv", _sortring_gatherv),
        summary="per-origin ring, size groups issued largest-first "
                "(hot block leads the critical path)")
    reg[("allgatherv", "doubling")] = VAlgorithm(
        "allgatherv", "doubling",
        _flat_v_builder("allgatherv", _doubling_gatherv),
        summary="Bruck-style doubling in absolute offsets "
                "(ceil(log2 n) rounds — the small-message regime)")
    reg[("reduce_scatter_v", "sortring")] = VAlgorithm(
        "reduce_scatter_v", "sortring",
        _flat_v_builder("reduce_scatter_v", _sortring_reduce_scatter_v),
        summary="reduce ring, size groups issued largest-first")
    reg[("all_to_all_v", "ring")] = VAlgorithm(
        "all_to_all_v", "ring",
        _flat_v_builder("all_to_all_v", _ring_a2av),
        summary="store-and-forward +1 ring (neighbor hops only; "
                "n(n-1)/2 block-hops of wire)")
    reg[("all_to_all_v", "doubling")] = VAlgorithm(
        "all_to_all_v", "doubling",
        _flat_v_builder("all_to_all_v", _doubling_a2av),
        summary="Bruck a2a on max-padded slots (ceil(log2 n) rounds; "
                "pays the pad at high ratios)")
    for algo in sorted(_SUM_ALLREDUCE):
        reg[("seg_allreduce", algo)] = VAlgorithm(
            "seg_allreduce", algo, _seg_arena_builder(algo),
            pow2_only=algo in POW2_ONLY,
            summary=f"flat {algo} allreduce transport on the selected "
                    f"segment prefix")
    return reg


#: the registry: (v-op, algorithm) -> VAlgorithm.  build_op resolves a
#: v-op's ``algo != "native"`` through here (vhier through
#: resolve_vhier), so every harness surface works on v-arena steps
#: unchanged.
V_ALGORITHMS: dict[tuple[str, str], VAlgorithm] = _build_registry()


def v_algorithms_for(op: str) -> tuple[str, ...]:
    """Registered flat v-algorithm names for one v-op (sorted)."""
    return tuple(sorted(a for o, a in V_ALGORITHMS if o == op))


def v_is_compatible(op: str, algo: str, n_devices: int) -> bool:
    entry = V_ALGORITHMS.get((op, algo))
    if entry is None:
        return False
    return not (entry.pow2_only and n_devices & (n_devices - 1))


def v_body_builder_for(op: str, algo: str, n_devices: int) -> Callable:
    """The body builder for one (v-op, algorithm) pair — raises the
    loud, specific error for every way the pair can be wrong (the
    arena_body_builder contract for the v-side registry)."""
    from tpu_perf_torch.scenarios.vops import V_OPS

    if op not in V_OPS:
        raise ValueError(
            f"op {op!r} has no v-variant decompositions; v-ops: {V_OPS}"
        )
    entry = V_ALGORITHMS.get((op, algo))
    if entry is None:
        raise ValueError(
            f"no {algo!r} v-decomposition registered for {op!r}; "
            f"registered: {v_algorithms_for(op)}"
            + (f" (plus the keyed {VHIER_PREFIX} composition on a "
               f"2-axis mesh)" if op == "allgatherv" else "")
        )
    if entry.pow2_only and n_devices & (n_devices - 1):
        raise ValueError(
            f"{op}@{algo} needs a power-of-two device count "
            f"(recursive halving/doubling pairs ranks by XOR), got "
            f"{n_devices}"
        )
    return entry.builder


def v_algos_for_op(op: str, n_devices: int, err=None) -> list[str]:
    """Every registered flat v-algorithm compatible with ``op`` at
    this device count — the single-axis ``--algo all`` expansion for
    v-ops.  Incompatible pow2-only entries are skipped with a note
    (the algos_for_op loudness contract)."""
    out = []
    for algo in v_algorithms_for(op):
        if v_is_compatible(op, algo, n_devices):
            out.append(algo)
        elif err is not None:
            print(f"[tpu-perf-torch] arena: skipping {op}@{algo} "
                  f"(needs a power-of-two device count, have "
                  f"{n_devices})", file=err)
    return out


# --- wire-bytes models (imbalance-aware) -----------------------------


def allgatherv_wire_elems(algo: str, counts) -> int:
    """Total elements crossing the wire for one allgatherv execution
    (summed over devices and rounds).  The ring families move each
    origin's block n-1 hops; doubling ships each round's
    cyclically-contiguous windows — fewer rounds, the same asymptotic
    volume, and the delta at a given counts table is the model the
    bench instrument prices."""
    n = len(counts)
    if algo in ("native", "ring", "sortring"):
        return (n - 1) * sum(counts)
    if algo == "doubling":
        total = 0
        w = 1
        while w < n:
            cnt = min(w, n - w)
            total += sum(sum(counts[(i + t) % n] for t in range(cnt))
                         for i in range(n))
            w *= 2
        return total
    raise ValueError(f"no allgatherv wire model for algo {algo!r}")


def vhier_wire_elems(counts, axis_sizes) -> tuple[int, int]:
    """(slow_axis_elems, fast_axis_elems) for one vhier allgatherv
    execution: phase A runs F parallel v-rings over the slow axis on
    the PADDED per-slot table; phase B runs S parallel v-rings over
    the fast axis on the true bundle widths."""
    S, F = axis_sizes
    dcn_counts = tuple(max(counts[s * F + j] for j in range(F))
                       for s in range(S))
    t_widths = tuple(sum(counts[s * F + j] for s in range(S))
                     for j in range(F))
    slow_elems = F * (S - 1) * sum(dcn_counts)
    fast_elems = S * (F - 1) * sum(t_widths)
    return slow_elems, fast_elems


def a2av_wire_elems(algo: str, blocks) -> int:
    """Total elements crossing the wire for one all_to_all_v
    execution.  native: each source ships n-1 blocks directly; ring:
    origin r's run shrinks one block per hop (sum_t (n-t) b_r =
    n(n-1)/2 b_r); doubling: every round ships the bit-selected slots
    at the PADDED width from every rank — the identities the CI gate
    asserts."""
    n = len(blocks)
    if algo == "native":
        return (n - 1) * sum(blocks)
    if algo == "ring":
        return sum(blocks) * n * (n - 1) // 2
    if algo == "doubling":
        maxb = max(blocks)
        slots = 0
        k = 1
        while k < n:
            slots += sum(1 for j in range(n) if j & k)
            k *= 2
        return n * maxb * slots
    raise ValueError(f"no all_to_all_v wire model for algo {algo!r}")


def seg_wire_elems(algo: str, selected_elems: int, n: int) -> int:
    """Total elements crossing the wire for one seg_allreduce
    execution on ``selected_elems`` selected elements — exactly the
    flat allreduce transport's volume at the selected width (the
    unselected tail never touches the wire): the proportionality the
    CI identity asserts against the full-buffer allreduce."""
    w = int(selected_elems)
    if n <= 1:
        return 0
    if algo in ("native", "ring"):
        # ring allreduce: 2(n-1) chunk-hops per device on the
        # n-rounded chunk (native's CPU/TPU lowering is modeled as the
        # bandwidth-optimal ring, the nccl-tests convention)
        chunk = -(-w // n)
        return n * 2 * (n - 1) * chunk
    if algo == "rhd":
        # halving then doubling: each phase moves w(n-1)/n per device
        chunk = -(-w // n)
        return 2 * n * (n - 1) * chunk
    if algo == "bruck":
        # allgather-based: round k ships min(k, n-k) full-width blocks
        blocks = 0
        k = 1
        while k < n:
            blocks += min(k, n - k)
            k *= 2
        return n * w * blocks
    if algo == "binomial":
        # binomial reduce + broadcast: n-1 full-width edges each way
        return 2 * (n - 1) * w
    raise ValueError(f"no seg_allreduce wire model for algo {algo!r}")
