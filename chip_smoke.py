#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``tpu_perf_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python3 chip_smoke.py

Phases, each printing what it found (any failure raises and the script
exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from the sources in this checkout (one nvcc per
   CUDA source, all started together with the gather's designs, each
   built from an edited copy of the sources; the Triton kernel compiles
   at its first launch) and print the build time;
3. hold each kernel against its plain PyTorch version on the card: the
   direct reduce-scatter at 2, 5 and 8 ranks and at the path's shape
   (unscaled, and with the carries' 1/5 and 1/8 scale, owned chunk alone
   and tiled over the row), the two gather entries (the gather in both
   modes, the bidirectional gather) at 1, 2, 5 and 8 ranks, at their
   tiles' edges, odd chunks and from sources one element into their
   storage, the stream kernel, the
   three bulk-copy kernels (copy, read sweep, write sweep) at 1, 5 and 8
   ranks, the point-to-point kernels (ring, exchange, pingpong with its
   stage, barrier) at 2, 5, 6 and 8 ranks, the cluster barrier at 9, 64
   and 256 ranks, and the collective kernels (all-to-all, and the
   bidirectional all-gather over its whole gathered buffer) at 1, 2,
   5 and 8 ranks, over several dtypes and ragged / unaligned / multi-block
   shapes up to 2 GiB, the row-copy kernels (copy, ring, exchange) also at
   their tiles' edges (one tile, one tile plus a word or an element, more
   tiles than twice the CTAs the card holds) and the copy from a view one
   element into its storage (source and output misaligned to each other),
   with no bit of difference;
   then show that 1000 chained barriers at 8 and 64
   ranks return their input and that 257 ranks are refused at the wrapper,
   that pingpong's return leg waits for its payload (two inputs in turn
   through a stage that holds a sentinel), that 1000 chained round
   trips at 8 ranks return their input and leave the pair counters at
   zero, and that 1000 chained copies, ring shifts, exchanges and both
   gathers return their input (the gathers: its gather), leave their tile
   counters at zero and replay from a CUDA graph to the eager result;
4. drive the port's run paths through its CLI (``run --op pl_allreduce
   --sweep 4K:256M``, the other five ops of the first slice, the six
   local memory ops at one rank, the eleven point-to-point ops at eight,
   the seven collectives at eight, then the reference's default ``run``
   and its ``-u`` and ``-x``) with
   the launch counters reset just before each run and read just after,
   check each kernel's launches per execution over the op's own sizes,
   parse the rows back, and check the outputs against the selftest
   models;
5. drive the fences, the daemon and the report through the CLI:
   ``run --op pl_allreduce --fence fused`` over the same sweep and every
   other ``pl_*`` op and ``allreduce`` fused at 4 KiB and 16 MiB a rank
   (the launches are the warm-up's and the capture's only, and each
   point's CUDA graph, replayed twice, must equal its eager chain),
   printing ``pl_allreduce``'s fused and block lat_us at 4 KiB and busbw
   at 256 MiB side by side; ``--fence auto`` (must resolve to trace) and
   ``--measure-dispatch`` (``overhead_us`` > 0 under block and readback,
   0 under slope); ``--profile-dir`` traces of ``pl_allreduce`` at 4 KiB
   and 256 MiB under block and fused, with each window's device time and
   idle share; a ``monitor --fence fused`` daemon rotating its logs every
   second into a ``TPU_PERF_INGEST=local:`` sink (the rotated files must
   arrive there and leave the log folder, no row lost); a ``monitor
   --fence trace`` daemon at 4 KiB, 300 visits and 100 with a 2 ms host
   stall around the lo leg's graph replay (every pair positive, the
   stalled lo legs within 10% of the plain ones, its lat_us beside the
   fused fence's), and the trace graphs' memory at 8 x 256 MiB; the
   fleet-health monitor and its chaos judge (``health``): the JAX
   acceptance soak on ``--synthetic`` run on the card and on the CPU (the
   ``chaos-*.log`` ledgers byte-identical, the same events, ``chaos
   verify`` 5/5), a real-timing ``chaos --fence fused`` soak of
   ``pl_allreduce`` at 4 KiB and 16 MiB with a fault of every kind and a
   ``corrupt`` one through the selftest, under ``--spans`` and
   ``--health-textfile`` (verify exits 0, every row, event and ledger
   entry joins one run span, the Chrome trace validates, the textfile
   holds a gauge set a point, the two kernels' launches are the warm-ups',
   the captures' and the corrupt pass's), then, printed and not gated, a
   fault-free ``monitor --health`` of 5000 visits at 4 KiB under fused and
   trace (events by kind, distinct sample values) and ``--spans``' cost to
   lat_us at 4 KiB under block and fused; ``report``,
   ``--compare-pallas`` and ``--format json`` over the block paths' logs;
   then the rest of the reference's run surface: ``run -x --window W`` at
   the default buffer for W = 1, 8 and 256 (rows at one nbytes, iters
   10·W, the output equal to the plain windowed exchange computed by
   rows), a ``monitor --fence fused`` daemon over an eight-op family (15
   points, each visited within one of the others, JSON heartbeats whose
   points sum to their samples, no row lost to the ``local:`` sink), the
   repo's C baseline (``run --backend mpi``, the port's shim build) and
   the port's windowed exchange paired by ``report --compare``, ``--hosts
   --dry-run`` printing one ``mpirun`` line, ``-f`` / ``-n`` / ``-p``
   against the sim world (``-n 3`` refused before any kernel) and ``-d``;
   then the compute instruments: ``run --op mxu_gemm --sim-ranks 1`` at m
   = 4096 in float32 and bfloat16 (the output at ``-i 1`` against a plain
   ``x @ q * a + b``, TFLOP/s against the card's peak for the dtype, one
   device op an iteration in a ``--profile-dir`` trace), ``grid --spec
   mxu`` over two sizes in each dtype, and ``overlap_ring`` at 8 ranks at
   4 MiB and 256 MiB a rank beside ``ring`` and ``mxu_gemm`` at its own m
   (the share of the ring hidden under the product, and its fused graph,
   the side stream a parallel branch, against the eager chain); the stream
   engine: ``run --streams 4`` over a six-op family (the serial run's rows
   and launches, lanes 1–4), the counter race (``pl_ring`` beside
   ``pl_exchange``, two sizes of the gather, the copy beside itself, on two
   lanes 50 times, every output exact and each lane's counters zero), the
   pingpong race beside a copy load in a process of its own under a
   wall-clock limit, and ``contend`` on ``allreduce`` and ``pl_allreduce``
   under ``mxu_gemm``, ``hbm_stream`` and ``pl_hbm_copy``, rendered by
   ``report``'s interference matrix; and ``bench`` once (its JSON line,
   the JAX one-device labels, each ratio against the detected card's
   entry); then the multi-rank world: ``run --distributed`` in an NCCL
   world of one (this process, torchrun's variables set for one rank)
   over the library collectives and ``ring`` (rows with backend torch,
   ``dist.get_backend()`` nccl, no kernel of the port), then each ``pl_*``
   op a world of one runs (``pl_allreduce``, ``pl_ring``,
   ``pl_all_to_all``, both gathers, the four local memory ops) under the
   block fence over 4K:16M and fused at 4 KiB and 16 MiB, each run's
   launches its path's and no plain call, and each op's output at the
   sweep's ends, eager and from a graph, its plain versions' chain;
   ``hier_allreduce`` on a 2 x 4 ``(dcn, ici)`` mesh of the sim world
   against its selftest model; worlds of 2 and 4 processes sharing the
   card through CUDA IPC, every ``pl_*`` op at 4108 B and 16 MiB bit for
   bit the sim kernels' chain with its launches; the barrier of one from
   graphs beside NCCL's; and the peer kernels' loopback in a process of
   its own under a wall-clock limit (n = 2, 4, 8 rank buffers as n
   allocations, each rank's launch on its own stream: every peer kernel
   against its plain version in float32, bfloat16 and int32, with and
   without a tail; 50 chained ``pl_allreduce`` executions and 20 replays
   of each rank's captured graph; every peer op's own steps, eager and
   from graphs, bit for bit the sim kernels' chain; then their times at 8
   x 256 MiB beside the sim kernels');
6. run ``grid --spec hbm`` over the eight local memory ops at 256 MiB and
   1 GiB and print its verdict table, and show the read sweep's time
   growing with the bytes it reads;
7. time each kernel at the main path's largest shape beside its bound
   (from the card's published rates in ``tpu_perf_torch.chips``), its
   plain version and one PyTorch library call (the row gather ``x[idx]``
   for ring and exchange, with ``index_select`` and ``torch.roll`` beside it;
   the barrier, the copy, ring and exchange also from a CUDA graph of 100
   chained launches, the barrier beside an empty kernel's; the
   reduce-scatter in both modes, beside the carries it replaced; the
   gathers beside a broadcast ``copy_`` into a preallocated output, each
   design of ``tpu_perf_torch.tools.gather_designs`` and the own-shard
   carry of ``pl_all_gather``), and print them as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  A phase that raises
ends the run with one ``chip_smoke: FAILED in phase <name> after <s> s:
<type>: <message>`` line, exit code 1 and no result line.  The script
imports nothing of JAX and nothing of the JAX package ``tpu_perf``.

Across the cards of one host (never in the default run, which needs one
card)::

    python3 -c "import chip_smoke as c; c.across_cards(4)"
    python3 -c "import chip_smoke as c; c.cards_chaos(4)"   # the skew soak
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


SWEEP = "4K:256M"
ITERS, RUNS = 5, 3
MAIN_BYTES = 256 * 1024**2  # the sweep's largest point, per rank
HEADLINE_BYTES = 4 * 1024**2
#: the local memory ops, judged by one grid on the card
GRID_OPS = ("hbm_stream,pl_hbm_stream,hbm_read,hbm_write,hbm_triad,"
            "pl_hbm_copy,pl_hbm_read,pl_hbm_write")

#: resident blocks an H100 SM holds at most: a persistent grid never has
#: more than this many CTAs per SM
MAX_CTAS_PER_SM = 32

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


def card_rates() -> tuple[float, float]:
    """(device-memory bytes/s, float32 operations/s) of this card, from
    the port's table of published peaks; a card not in it fails."""
    import torch

    from tpu_perf_torch.chips import card_spec

    spec = card_spec(torch.cuda.get_device_name(0))
    return spec.hbm_gbps * 1e9, spec.f32_tflops * 1e12


def phase_build() -> dict:
    """Build every kernel, and the gather's designs beside them (each from
    an edited copy of its sources, all nvcc started together); returns
    the designs' C entries by name."""
    import torch

    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.stream_triton import stream
    from tpu_perf_torch.tools import gather_designs
    from tpu_perf_torch.tools.row_copy_designs import finish_variants

    t0 = time.perf_counter()
    jobs = gather_designs.start(gather_designs.designs_dir())
    _build.build_all()
    designs = finish_variants(jobs)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        stream(torch.ones(3, 5, dtype=dt, device="cuda"))
    torch.cuda.synchronize()
    print(f"build: nvcc ({len(_build._ENTRIES)} sources and {len(designs)} "
          f"gather designs, parallel) {nvcc_s:.1f} s, "
          f"triton first launches {time.perf_counter() - t0:.1f} s")
    return designs


def phase_check() -> None:
    import torch

    from tpu_perf_torch.ops.collectives import (
        DTYPES, build_op, make_fill, to_tensor,
    )
    from tpu_perf_torch.ops.pallas_ring import (
        direct_reduce_scatter, direct_reduce_scatter_plain, mean_scale,
    )
    from tpu_perf_torch.ops.stream_triton import stream, stream_plain
    from tpu_perf_torch.world import SimWorld

    def fill(shape, dtype):
        total = 1
        for s in shape:
            total *= s
        return to_tensor(make_fill(total, dtype).reshape(shape), dtype, "cuda")

    n_checks = 0
    # 1001: the scalar path; 4096: 16-byte vectors; 2**20 + 64: more units
    # than the kernels' grid, so the grid-stride loop turns
    chunks = (1001, 4096, 2**20 + 64)
    for n in (2, 5, 8):
        for chunk in chunks:
            for dtype in ("float32", "bfloat16", "float16"):
                x = fill((n, n * chunk), dtype)
                check_close(f"direct_reduce_scatter n={n} chunk={chunk} "
                            f"{dtype}", direct_reduce_scatter(x),
                            direct_reduce_scatter_plain(x), dtype)
                n_checks += 1
                if n == 2:
                    continue
                # the carries' epilogue: 1/n rounded to the dtype (not a
                # power of two at 5), the owned chunk alone (pl_allreduce)
                # and tiled over the row (pl_reduce_scatter)
                scale = mean_scale(n, DTYPES[dtype])
                for tiles in (1, n):
                    check_close(f"direct_reduce_scatter n={n} chunk={chunk} "
                                f"{dtype} scale={scale} tiles={tiles}",
                                direct_reduce_scatter(x, scale=scale,
                                                      tiles=tiles),
                                direct_reduce_scatter_plain(x, scale, tiles),
                                dtype)
                    n_checks += 1
    # the pl_allreduce path's own input, 8 ranks x 256 MiB: unscaled, and
    # as both carries launch it
    x = build_op("pl_allreduce", SimWorld(8, torch.device("cuda")), MAIN_BYTES,
                 1).example_input
    inv = mean_scale(8, x.dtype)
    for scale, tiles in ((1.0, 1), (inv, 1), (inv, 8)):
        check_close(f"direct_reduce_scatter {tuple(x.shape)} float32 "
                    f"scale={scale} tiles={tiles}",
                    direct_reduce_scatter(x, scale=scale, tiles=tiles),
                    direct_reduce_scatter_plain(x, scale, tiles), "float32")
        n_checks += 1
    del x
    n_checks += check_gather_kernels(fill, chunks)
    for dtype in DTYPES:
        for shape in ((1, 1), (8, 1000003), (1, 3 * 2**22 + 5)):
            x = fill(shape, dtype)
            check_close(f"stream {shape} {dtype}", stream(x),
                        stream_plain(x), dtype)
            n_checks += 1
    n_checks += check_bulk_kernels(fill)
    n_checks += check_p2p_kernels(fill)
    n_checks += check_collective_kernels(fill)
    torch.cuda.synchronize()
    print(f"check: {n_checks} kernel-vs-plain cases agree within the stated "
          f"tolerances {RTOL}")
    check_barrier_chains(fill)
    check_pingpong_order(fill)
    check_row_copy_chains(fill)
    check_peer_tile_kernels(fill)
    check_peer_gather_kernels()


def check_gather_kernels(fill, chunks) -> int:
    """Both gather entries against their plain versions, exactly, at 1, 2,
    5 and 8 ranks in float32, bfloat16, int32 and uint8: the gather in
    both modes and the bidirectional gather, at ``chunks`` elements a
    chunk, one element either side of a tile (two for the bidirectional
    entry, whose chunks are even), and odd chunks in the 16-bit and 8-bit
    types (odd half-chunks for the bidirectional entry); then from sources
    one element into their storage (misaligned to the fresh output).
    Returns the number of cases."""
    from tpu_perf_torch.ops.collectives import DTYPES
    from tpu_perf_torch.ops.pallas_ring import (
        ROW_COPY_TILE_BYTES, direct_all_gather, direct_all_gather_bidir,
        direct_all_gather_bidir_plain, direct_all_gather_plain,
    )

    def cases(x, chunk, what):
        # the gather of own chunks x (n, chunk), and the bidirectional
        # gather where the chunk is even; returns the cases checked
        check_exact(f"direct_all_gather {what}", direct_all_gather(x),
                    direct_all_gather_plain(x))
        if chunk % 2 == 0:
            check_exact(f"direct_all_gather_bidir {what}",
                        direct_all_gather_bidir(x),
                        direct_all_gather_bidir_plain(x))
        return 1 + (chunk % 2 == 0)

    n_checks = 0
    for n in (1, 2, 5, 8):
        for dtype in ("float32", "bfloat16", "int32", "uint8"):
            tile = ROW_COPY_TILE_BYTES // DTYPES[dtype].itemsize
            sizes = sorted({*chunks, tile - 2, tile - 1, tile, tile + 1,
                            tile + 2, 2 * 501, 3 * tile + 1})
            for chunk in sizes:
                what = f"({n}, {chunk}) {dtype}"
                n_checks += cases(fill((n, chunk), dtype), chunk, what)
                x = fill((n, n * chunk), dtype)
                check_exact(f"direct_all_gather src_full ({n}, {n * chunk}) "
                            f"{dtype}", direct_all_gather(x, src_full=True),
                            direct_all_gather_plain(x, src_full=True))
                n_checks += 1
            # one element into the storage: the words narrow to the dtype
            for chunk in (tile, tile + 2, 5 * tile + 4):
                what = f"({n}, {chunk}) {dtype} at storage offset 1"
                x = fill((n * chunk + 1,), dtype)[1:].view(n, chunk)
                n_checks += cases(x, chunk, what)
                x = fill((n * n * chunk + 1,), dtype)[1:].view(n, n * chunk)
                check_exact(f"direct_all_gather src_full {what}",
                            direct_all_gather(x, src_full=True),
                            direct_all_gather_plain(x, src_full=True))
                n_checks += 1
    return n_checks


def tile_edge_elems(tile_bytes: int, isz: int, n: int) -> tuple[int, ...]:
    """Per-rank element counts at a row-copy kernel's tile edges: one tile,
    one tile plus one 16-byte word, one tile plus one element (the row
    moves in narrower words), and more tiles over the n rows than twice
    the CTAs the card can hold (a ragged last tile)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_row = -(-(2 * MAX_CTAS_PER_SM * sms + 5) // n)
    tile = tile_bytes // isz
    return (tile, tile + 16 // isz, tile + 1, (per_row - 1) * tile + 3)


def check_bulk_kernels(fill) -> int:
    """The three bulk-copy kernels against their plain versions; returns
    the number of cases."""
    import torch

    from tpu_perf_torch.ops.collectives import DTYPES, build_op
    from tpu_perf_torch.ops.pallas_ring import (
        ROW_COPY_TILE_BYTES, hbm_copy, hbm_copy_plain,
        hbm_dma_block_elems, hbm_write, hbm_write_plain,
    )
    from tpu_perf_torch.world import SimWorld

    n_checks = 0
    for n in (1, 5, 8):
        for dtype in ("float32", "bfloat16", "uint8"):
            isz = DTYPES[dtype].itemsize
            # the copy: the default 456131-byte buffer (rows start at
            # 16-byte unaligned offsets when n > 1), one element, a
            # row of many tiles with a ragged end, and the tiles' edges
            for elems in (-(-456131 // isz), 1, 2**22 + 3,
                          *tile_edge_elems(ROW_COPY_TILE_BYTES, isz, n)):
                x = fill((n, elems), dtype)
                check_exact(f"hbm_copy ({n}, {elems}) {dtype}", hbm_copy(x),
                            hbm_copy_plain(x))
                n_checks += 1
            # a contiguous view one element into its storage: source and
            # output (fresh, aligned) are misaligned to each other, so the
            # tiles go a byte a thread; one tile, a tile and an element,
            # and a row of many tiles with a ragged end
            tile = ROW_COPY_TILE_BYTES // isz
            for elems in (tile, tile + 1, 5 * tile + 3):
                x = fill((n * elems + 1,), dtype)[1:].view(n, elems)
                check_exact(f"hbm_copy ({n}, {elems}) {dtype} at storage "
                            "offset 1", hbm_copy(x), hbm_copy_plain(x))
                n_checks += 1
            # the read and write sweeps: one 4 KiB DMA tile (a one-element
            # request, rounded), and three blocks plus a 4 KiB rem tail
            block = hbm_dma_block_elems(isz, 2**40)
            for elems in (4096 // isz, 3 * block + 4096 // isz):
                x = fill((n, elems), dtype)
                blk = hbm_dma_block_elems(isz, elems)
                check_close(f"hbm_write ({n}, {elems}) block {blk} {dtype}",
                            hbm_write(x, blk), hbm_write_plain(x, blk), dtype)
                check_read(f"hbm_read ({n}, {elems}) {dtype}", x, dtype)
                n_checks += 2
    # 1 GiB, one rank: 512 write blocks, 32768 read and copy pieces; the
    # fill is made on the card, as the run path makes it
    x = build_op("pl_hbm_write", SimWorld(1, torch.device("cuda")), 2**30,
                 1).example_input
    blk = hbm_dma_block_elems(4, x.shape[1])
    check_close("hbm_write (1, 2**28) float32", hbm_write(x, blk),
                hbm_write_plain(x, blk), "float32")
    check_read("hbm_read (1, 2**28) float32", x, "float32")
    check_exact("hbm_copy (1, 2**28) float32", hbm_copy(x), hbm_copy_plain(x))
    return n_checks + 3


def check_p2p_kernels(fill) -> int:
    """The point-to-point kernels against their plain versions; returns the
    number of cases."""
    import torch

    from tpu_perf_torch.ops.collectives import DTYPES
    from tpu_perf_torch.ops.pallas_ring import (
        ROW_COPY_TILE_BYTES, barrier, barrier_plain, pair_exchange,
        pair_exchange_plain, pingpong, pingpong_plain, ring_shift,
        ring_shift_plain,
    )

    n_checks = 0
    for n in (2, 5, 6, 8):
        for dtype in ("float32", "bfloat16", "uint8"):
            isz = DTYPES[dtype].itemsize
            # the default 456131-byte buffer (rows start 16-byte unaligned
            # when n > 1; odd rows for uint8), one element, and a multi-MiB
            # row with a ragged end
            for elems in (-(-456131 // isz), 1, 2**22 + 3):
                x = fill((n, elems), dtype)
                what = f"({n}, {elems}) {dtype}"
                check_exact(f"ring {what}", ring_shift(x), ring_shift_plain(x))
                check_close(f"barrier {what}", barrier(x), barrier_plain(x),
                            dtype)
                n_checks += 2
                if n % 2:
                    continue
                check_exact(f"exchange {what}", pair_exchange(x),
                            pair_exchange_plain(x))
                out, stage = pingpong(x)
                want_out, want_stage = torch.empty_like(x), torch.empty_like(x)
                pingpong_plain(x, want_out, want_stage)
                check_close(f"pingpong {what}", out, want_out, dtype)
                # the stage rows the kernel writes: group 0's payload
                check_close(f"pingpong stage {what}", stage[n // 2:],
                            want_stage[n // 2:], dtype)
                n_checks += 3
            x = fill((n, 1), dtype)
            check_close(f"barrier ({n}, 1) {dtype}", barrier(x),
                        barrier_plain(x), dtype)
            n_checks += 1
            # the row shift at its tiles' edges
            for elems in tile_edge_elems(ROW_COPY_TILE_BYTES, isz, n):
                x = fill((n, elems), dtype)
                what = f"({n}, {elems}) {dtype}"
                check_exact(f"ring {what}", ring_shift(x), ring_shift_plain(x))
                n_checks += 1
                if n % 2 == 0:
                    check_exact(f"exchange {what}", pair_exchange(x),
                                pair_exchange_plain(x))
                    n_checks += 1
    # the cluster barrier's other layouts: 8 CTAs of 2, 8 and 32 warps
    for n in (9, 64, 256):
        for dtype in ("float32", "uint8"):
            x = fill((n, 1001), dtype)
            check_close(f"barrier ({n}, 1001) {dtype}", barrier(x),
                        barrier_plain(x), dtype)
            n_checks += 1
    return n_checks


def check_collective_kernels(fill) -> int:
    """The all-to-all and the bidirectional all-gather against their plain
    versions; returns the number of cases."""
    from tpu_perf_torch.ops.collectives import DTYPES
    from tpu_perf_torch.ops.pallas_ring import (
        all_to_all, all_to_all_plain, direct_all_gather_bidir,
        direct_all_gather_bidir_plain,
    )

    n_checks = 0
    for n in (1, 2, 5, 8):
        for dtype in ("float32", "bfloat16", "uint8"):
            isz = DTYPES[dtype].itemsize
            elems = -(-456131 // isz)
            # the default 456131-byte buffer per rank (chunks start 16-byte
            # unaligned), one-element chunks, and a multi-MiB chunk with a
            # ragged end
            for chunk in (-(-elems // n), 1, 2**20 + 3):
                x = fill((n, n * chunk), dtype)
                check_close(f"all_to_all ({n}, {n * chunk}) {dtype}",
                            all_to_all(x), all_to_all_plain(x), dtype)
                n_checks += 1
            # the default buffer as the gathered total (odd half-chunks in
            # bfloat16 and uint8), the smallest chunk, and a multi-MiB
            # chunk with a ragged half; the whole gathered buffer, not the
            # carry, which takes only the own chunk back
            default = max(2, -(-456131 // (isz * n)))
            for chunk in (default + default % 2, 2, 2**21 + 6):
                x = fill((n, chunk), dtype)
                got = direct_all_gather_bidir(x)
                want = direct_all_gather_bidir_plain(x)
                what = f"direct_all_gather_bidir ({n}, {chunk}) {dtype}"
                check_exact(what, got, want)
                check_close(f"{what} against every rank's chunk", got,
                            x.reshape(1, -1).expand(n, -1), dtype)
                n_checks += 1
    return n_checks


def check_barrier_chains(fill) -> None:
    """The cluster barrier keeps no state between launches: 1000 chained
    barriers at the path's 8 ranks (one warp per CTA) and at 64 (8 warps
    per CTA) return their input; 257 ranks, more than one cluster holds,
    are refused at the wrapper before any launch."""
    import torch

    from tpu_perf_torch import kernels
    from tpu_perf_torch.ops.pallas_ring import barrier

    for n in (8, 64):
        x = fill((n, 1), "float32")
        y = x
        for _ in range(1000):
            y = barrier(y)
        torch.cuda.synchronize()
        check_close(f"1000 chained barriers ({n}, 1)", y, x, "float32")
    before = kernels.LAUNCHES["barrier"]
    try:
        barrier(fill((257, 1), "float32"))
    except ValueError as e:
        said = str(e)
    else:
        fail("a barrier of 257 ranks was not refused")
    if kernels.LAUNCHES["barrier"] != before:
        fail("the refused barrier launched")
    print("check: 1000 chained barriers at (8, 1) and (64, 1) return their "
          f"input; 257 ranks refused: {said}")


def check_pingpong_order(fill) -> None:
    """Each pair's return leg waits for its whole payload: two different
    inputs in turn through one stage that holds a sentinel before every
    call (NaN, 0xFF for uint8) come back exactly, the partners' stage rows
    hold the payload and group 0's stage rows keep the sentinel.  (A new
    stage could be a block that already holds the same payload, and an
    early return leg would go unseen.)  Then 1000 chained round trips at
    8 ranks return their input and leave the pair counters at zero."""
    import torch

    from tpu_perf_torch.ops.collectives import DTYPES
    from tpu_perf_torch.ops.pallas_ring import pingpong, pingpong_counters

    cases = 0
    for n in (2, 8):
        for dtype, sentinel in (("float32", float("nan")), ("uint8", 255)):
            isz = DTYPES[dtype].itemsize
            for elems in (-(-456131 // isz), 16 * 1024**2 // isz):
                a = fill((n, elems), dtype)
                b = a.roll(1, 1)
                if torch.equal(a, b):
                    fail(f"pingpong order ({n}, {elems}) {dtype}: the two "
                         "inputs are equal")
                stage = torch.empty_like(a)
                half = n // 2
                for i in range(20):
                    x = a if i % 2 == 0 else b
                    stage.fill_(sentinel)
                    out, _ = pingpong(x, stage)
                    held = (stage[:half].isnan() if dtype == "float32"
                            else stage[:half] == sentinel)
                    if not (torch.equal(out, x)
                            and torch.equal(stage[half:], x[:half])
                            and bool(held.all())):
                        fail(f"pingpong order ({n}, {elems}) {dtype}, call "
                             f"{i}: the round trip did not return its own "
                             "input through the stage")
                cases += 1
    x = fill((8, -(-456131 // 4)), "float32")
    y = x
    for _ in range(1000):
        y = pingpong(y)[0]
    torch.cuda.synchronize()
    check_close("1000 chained round trips (8, 114033)", y, x, "float32")
    counters = pingpong_counters(x.device, 4)
    if counters.any():
        fail(f"pingpong counters left non-zero after 1000 round trips: "
             f"{counters.tolist()}")
    print(f"check: pingpong's return leg waited for its payload in {cases} "
          "sentinel-stage cases of 20 alternating calls; 1000 chained round "
          f"trips at (8, 114033) return their input, counters "
          f"{counters.tolist()}")


def check_row_copy_chains(fill) -> None:
    """The row-copy kernels and the gathers keep nothing between launches
    but their tile counters, which they return to zero: 1000 chained
    copies, ring shifts and exchanges at (8, 114033) return their input
    (1000 ring shifts at 8 ranks are the identity), 1000 chained gathers
    (the gather in src_full mode, whose output is its next input; the
    bidirectional gather through the path's own-shard carry) at 8 chunks
    of 14254 return the gathered input, the counters end at zero, and a
    CUDA graph of 100 chained launches replays to the eager result."""
    import torch

    from tpu_perf_torch.ops.pallas_ring import (
        direct_all_gather, direct_all_gather_bidir, direct_all_gather_plain,
        hbm_copy, pair_exchange, ring_shift, row_copy_counters,
    )

    x = fill((8, -(-456131 // 4)), "float32")
    chunk = 14254
    full = fill((8, 8 * chunk), "float32")
    own = fill((8, chunk), "float32")
    d = torch.arange(8, device=own.device)

    def gather_full(y):
        return direct_all_gather(y, src_full=True)

    def gather_bidir(y):
        return direct_all_gather_bidir(y).view(8, 8, chunk)[d, d]

    said = []
    for name, kern, source, x0, want in (
            ("hbm_copy", hbm_copy, "hbm_copy", x, x),
            ("ring", ring_shift, "p2p_shift", x, x),
            ("exchange", pair_exchange, "p2p_shift", x, x),
            ("direct_all_gather", gather_full, "all_gather", full,
             direct_all_gather_plain(full, src_full=True)),
            ("direct_all_gather_bidir", gather_bidir, "all_gather", own,
             own)):
        y = x0
        for _ in range(1000):
            y = kern(y)
        torch.cuda.synchronize()
        check_exact(f"1000 chained {name} {tuple(x0.shape)}", y, want)
        counters = row_copy_counters(source, x0.device)
        if counters.any():
            fail(f"{name}: tile counters left non-zero after 1000 launches: "
                 f"{counters.tolist()}")
        ms = graph_ms(lambda kern=kern, x0=x0: chain(kern, x0),
                      chain(kern, x0),
                      what=f"graph of 100 chained {name} {tuple(x0.shape)}")
        said.append(f"{name} {ms * 1e3:.2f} us")
    print("check: 1000 chained hbm_copy / ring / exchange at (8, 114033) and "
          "gathers of 8 chunks of 14254 return their input (the gathers: "
          "its gather), tile counters zero; graphs of "
          f"{GRAPH_LAUNCHES} chained launches replay to the eager result "
          f"({', '.join(said)} per launch)")


PEER_REPLAYS = 20


def _replayed(launch, out, source: str, what: str):
    """``launch()`` (which writes ``out``) run eagerly on a side stream,
    captured there into a CUDA graph, ``out`` zeroed and the graph replayed
    PEER_REPLAYS times; fails unless the side stream's ``source`` tile
    counters are zero after the eager launch and after the replays.
    Returns ``out``."""
    import torch

    from tpu_perf_torch.ops.pallas_ring import row_copy_counters

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        launch()
        counters = row_copy_counters(source, out.device)
        side.synchronize()
        if counters.any():
            fail(f"{what}: {source} counters {counters.tolist()} after a "
                 "launch")
        with torch.cuda.graph(graph, stream=side):
            launch()
        out.zero_()
        for _ in range(PEER_REPLAYS):
            graph.replay()
        side.synchronize()
        if counters.any():
            fail(f"{what}: {source} counters {counters.tolist()} after "
                 f"{PEER_REPLAYS} graph replays")
    torch.cuda.current_stream().wait_stream(side)
    return out


def check_peer_tile_kernels(fill) -> None:
    """The two peer kernels that draw tiles in order, bit for bit against
    their plain versions at their tiles' edges (tile_edge_elems: one tile,
    one more 16-byte unit, one more element, and more tiles than twice the
    CTAs the card holds, ragged): the copy in float32, bfloat16, float16
    and uint8, also from a view one element into its storage, which
    together take all four words; the reduce-scatter at 8 and 5 ranks in
    the three float dtypes, scaled by 1/n, one tile and n tiles, also at
    many tiles with a last of three units (a chunk that is not whole
    16-byte units takes the element path).  Each output is the one
    PEER_REPLAYS replays of its graph wrote, and the tile counters are
    zero after every launch."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import DTYPES

    cases, words = 0, set()
    for dtype in ("float32", "bfloat16", "float16", "uint8"):
        isz = DTYPES[dtype].itemsize
        for elems in tile_edge_elems(pr.ROW_COPY_TILE_BYTES, isz, 1):
            for offset in (0, 1):
                src = fill((elems + offset,), dtype)[offset:]
                out = torch.empty_like(src)
                words.add(pr._widest_word(elems * isz, src.data_ptr(),
                                          out.data_ptr()))
                what = f"peer_copy {elems} {dtype} at storage offset {offset}"
                got = _replayed(lambda: pr.peer_copy("peer_ring", src, out=out),
                                out, "peer_copy", what)
                check_exact(what, got, pr.peer_copy_plain("peer_ring", src))
                cases += 1
    if words != {16, 4, 2, 1}:
        fail(f"peer_copy: the cases took the words {sorted(words)}")
    for dtype in ("float32", "bfloat16", "float16"):
        isz = DTYPES[dtype].itemsize
        for n in (8, 5):
            scale = pr.mean_scale(n, DTYPES[dtype])
            edges = tile_edge_elems(pr.PEER_REDUCE_TILE_BYTES, isz, 1)
            # and many tiles whose last holds three 16-byte units
            for chunk in (*edges, edges[-1] - 3 + 3 * (16 // isz)):
                x = fill((n, chunk), dtype)
                parts = pr.PeerParts(x.unbind(0))
                rank = n - 3
                for tiles in (1, n):
                    out = torch.empty(tiles * chunk, dtype=x.dtype,
                                      device=x.device)
                    what = (f"peer_reduce_scatter n={n} rank {rank} chunk "
                            f"{chunk} {dtype} tiles {tiles}")
                    got = _replayed(
                        lambda: pr.peer_reduce_scatter(
                            parts, rank, scale=scale, tiles=tiles, out=out),
                        out, "peer_reduce", what)
                    check_exact(what, got, pr.peer_reduce_scatter_plain(
                        list(parts), rank, scale, tiles))
                    cases += 1
    print(f"check: {cases} peer_copy / peer_reduce_scatter cases at their "
          "tiles' edges (the copy in words 16, 4, 2 and 1) equal their plain "
          f"versions bit for bit after {PEER_REPLAYS} replays of each one's "
          "graph; the tile counters zero after every launch")


def check_peer_gather_kernels() -> None:
    """The peer gathers on in-order tiles, bit for bit, at 1, 2, 5 and 8
    ranks in float32, bfloat16 and uint8, at their tiles' edges
    (tile_edge_elems: a chunk of one tile, one that is no whole number of
    16-byte words, a ragged last tile of more tiles than twice the CTAs
    the card holds), also from sources one element into their storage,
    which together take all four words: every rank's push (whole chunks,
    and half-chunks where the chunk is even) and pull (the same) against
    the sim gather ``direct_all_gather``, and every rank's all-to-all,
    pushed and pulled, against the sim ``all_to_all``.  Each output is the one
    PEER_REPLAYS replays of its graph wrote, and the ``peer_gather``
    counters are zero after every launch.  The inputs are drawn on the
    card from a seeded generator (the largest are hundreds of MB)."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import DTYPES

    gen = torch.Generator(device="cuda").manual_seed(15)

    def fill(shape, dtype):
        t = DTYPES[dtype]
        if t.is_floating_point:
            return torch.rand(shape, generator=gen, device="cuda").to(t)
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=t)

    cases, words = 0, set()
    for dtype in ("float32", "bfloat16", "uint8"):
        isz = DTYPES[dtype].itemsize
        for n in (1, 2, 5, 8):
            for chunk in tile_edge_elems(pr.ROW_COPY_TILE_BYTES, isz, n):
                for offset in (0, 1):
                    own = fill((n * chunk + offset,), dtype)[offset:].view(
                        n, chunk)
                    out = torch.empty(n, n * chunk, dtype=own.dtype,
                                      device=own.device)
                    outs, parts = pr.PeerParts(out.unbind(0)), pr.PeerParts(
                        own.unbind(0))
                    want = pr.direct_all_gather(own)
                    at = f"n={n} chunk={chunk} {dtype} at storage offset " \
                         f"{offset}"
                    for bidir in (False, True)[:1 + (chunk % 2 == 0)]:
                        nbytes = chunk * isz // (1 + bidir)
                        words |= {pr._widest_word(
                            nbytes, own[r].data_ptr(), *(
                                o.data_ptr() + r * chunk * isz for o in outs))
                            for r in range(n)}
                        what = f"push{' bidir' * bidir} {at}"
                        got = _replayed(lambda: [pr.peer_all_gather_push(
                            own[r], outs, r, bidir=bidir) for r in range(n)],
                            out, "peer_gather", what)
                        check_exact(what, got, want)
                        what = f"pull{' bidir' * bidir} {at}"
                        got = _replayed(lambda: [
                            pr.peer_all_gather_bidir(parts, r, out=out[r])
                            if bidir else pr.peer_all_gather(parts, r,
                                                             out=out[r])
                            for r in range(n)], out, "peer_gather", what)
                        check_exact(what, got, want)
                        cases += 2
                    x = fill((n * n * chunk + offset,), dtype)[offset:].view(
                        n, n * chunk)
                    rows = [pr.PeerParts(x.view(n, n, chunk)[:, r].unbind(0))
                            for r in range(n)]
                    want = pr.all_to_all(x.clone())
                    what = f"pull all-to-all {at}"
                    got = _replayed(lambda: [pr.peer_all_to_all(
                        rows[r], r, out=out[r]) for r in range(n)], out,
                        "peer_gather", what)
                    check_exact(what, got, want)
                    words |= {pr._widest_word(
                        chunk * isz, x[r].data_ptr(), *(
                            o.data_ptr() + r * chunk * isz for o in outs))
                        for r in range(n)}
                    what = f"push all-to-all {at}"
                    got = _replayed(lambda: [pr.peer_all_to_all_push(
                        x[r], outs, r) for r in range(n)], out,
                        "peer_gather", what)
                    check_exact(what, got, want)
                    cases += 2
    if words != {16, 4, 2, 1}:
        fail(f"peer gathers: the cases took the words {sorted(words)}")
    print(f"check: {cases} peer gather cases (push and pull, whole and "
          "half-chunks, and the all-to-all pushed and pulled) at 1, 2, 5 "
          "and 8 ranks at their "
          "tiles' edges, in words 16, 4, 2 and 1, equal the sim kernels bit "
          f"for bit after {PEER_REPLAYS} replays of each one's graph; the "
          "peer_gather counters zero after every launch")


def chain(kern, x):
    """GRAPH_LAUNCHES chained launches of ``kern`` from ``x``."""
    y = x
    for _ in range(GRAPH_LAUNCHES):
        y = kern(y)
    return y


def check_exact(what: str, got, want) -> float:
    """A kernel that only moves bytes: the same bytes as its plain version
    (max abs err 0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} != "
             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        fail(f"{what}: {int((got != want).sum())} of {got.numel()} elements "
             f"differ (max abs err {max_abs_err(got, want):.3e})")
    return 0.0


def check_read(what: str, x, dtype: str) -> None:
    """The read sweep returns its input itself, unchanged: the plain
    version (the identity) of a copy taken before the launch."""
    from tpu_perf_torch.ops.pallas_ring import hbm_read, hbm_read_plain

    before = x.clone()
    got = hbm_read(x)
    if got is not x:
        fail(f"{what}: the output is not the input tensor")
    check_close(what, got, hbm_read_plain(before), dtype)


#: op -> ({kernel: launches per execution}, sim ranks)
PATHS = {
    "pl_allreduce": ({"direct_reduce_scatter": 1, "direct_all_gather": 1}, 8),
    "allreduce": ({}, 8),
    "pl_reduce_scatter": ({"direct_reduce_scatter": 1}, 8),
    "pl_all_gather": ({"direct_all_gather": 1}, 8),
    "hbm_stream": ({}, 1),
    "pl_hbm_stream": ({"stream": 1}, 1),
    "hbm_read": ({}, 1),
    "hbm_write": ({}, 1),
    "hbm_triad": ({}, 1),
    "pl_hbm_copy": ({"hbm_copy": 1}, 1),
    "pl_hbm_read": ({"hbm_read": 1}, 1),
    "pl_hbm_write": ({"hbm_write": 1}, 1),
    # the point-to-point slice: the library ops launch no kernel of the
    # port; barrier and pl_barrier collapse the sweep to one point
    "pingpong": ({}, 8),
    "pingpong_unidir": ({}, 8),
    "exchange": ({}, 8),
    "ppermute": ({}, 8),
    "ring": ({}, 8),
    "halo": ({}, 8),
    "barrier": ({}, 8),
    "pl_ring": ({"ring": 1}, 8),
    "pl_exchange": ({"exchange": 1}, 8),
    "pl_pingpong": ({"pingpong": 1}, 8),
    "pl_barrier": ({"barrier": 1}, 8),
    # the collectives slice: the library collectives launch no kernel of
    # the port
    "all_gather": ({}, 8),
    "reduce_scatter": ({}, 8),
    "all_to_all": ({}, 8),
    "broadcast": ({}, 8),
    "broadcast_psum": ({}, 8),
    "pl_all_gather_bidir": ({"direct_all_gather_bidir": 1}, 8),
    "pl_all_to_all": ({"all_to_all": 1}, 8),
}
#: per-rank sizes at which a path's output is checked, where not at the
#: sweep's two ends: the library point-to-point ops and collectives stop
#: at 16 MiB, since the host-side model check of 2 GiB a path is what
#: costs the time (the kernels of the same functions are checked at
#: 256 MiB)
CHECK_BYTES = dict.fromkeys(
    ("pingpong", "pingpong_unidir", "exchange", "ppermute", "ring", "halo",
     "all_gather", "reduce_scatter", "all_to_all", "broadcast",
     "broadcast_psum"),
    (4096, 16 * 1024**2))
#: the reference's default run and its -u / -x: (flags, the op of the rows)
DEFAULT_RUNS = (([], "pingpong"), (["-u"], "pingpong_unidir"),
                (["-x"], "exchange"))


def _drive(argv: list[str], what: str, keep: str | None = None):
    """One ``cli.main`` run with the counters set to 0 just before it and
    read just after; returns (launches, rows, wall s).  ``keep`` names a
    folder the run's extended logs are copied into."""
    import glob
    import shutil
    import tempfile

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.schema import ResultRow

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as logdir:
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-l", logdir])
        wall = time.perf_counter() - t0
        got, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
        rows = []
        for path in sorted(glob.glob(os.path.join(logdir, "tpu-*.log"))):
            with open(path) as fh:
                rows += [ResultRow.from_csv(ln) for ln in fh if ln.strip()]
            if keep is not None:
                shutil.copy(path, keep)
    if rc != 0:
        fail(f"{what} exited {rc}")
    if any(plain.values()):
        fail(f"{what}: plain versions called {plain}")
    return got, rows, wall


def phase_main_path() -> dict:
    import math

    import torch

    from tpu_perf_torch.config import Options
    from tpu_perf_torch.metrics import is_latency_only
    from tpu_perf_torch.runner import sizes_for
    from tpu_perf_torch.selftest import format_results, run_selftest
    from tpu_perf_torch.world import SimWorld

    dev = torch.device("cuda", torch.cuda.current_device())
    launches: dict[str, dict[str, int]] = {}
    for op, (needs, ranks) in PATHS.items():
        # the op's own sizes: one point for the fixed-payload ops
        sizes = sizes_for(Options(sweep=SWEEP, op=op))
        n_sizes = len(sizes)
        # each point: one warm-up run and RUNS measured runs (driver.Driver)
        executions = n_sizes * (1 + RUNS) * ITERS
        what = f"run --op {op}"
        got, rows, wall = _drive(
            ["run", "--op", op, "--sweep", SWEEP, "-i", str(ITERS), "-r",
             str(RUNS), "--sim-ranks", str(ranks)], what, keep=REPORT_DIR)
        if op == "pl_allreduce":
            BLOCK_ROWS.extend(rows)
        missing = [k for k in needs if got[k] == 0]
        if missing:
            fail(f"{what}: kernels {missing} never launched ({got})")
        wrong = {k: got[k] for k, per in needs.items()
                 if got[k] != per * executions}
        if wrong:
            fail(f"{what}: launches {wrong}, want {needs} per execution over "
                 f"{executions} executions")
        extra = [k for k, v in got.items() if v and k not in needs]
        if extra:
            fail(f"{what}: launched kernels {extra} off its path")
        backend = "torch-sim" if ranks > 1 else "torch"
        if len(rows) != n_sizes * RUNS:
            fail(f"{what}: {len(rows)} rows, want {n_sizes * RUNS}")
        latency_only = is_latency_only(op, ranks)
        for r in rows:
            if (r.op != op or r.backend != backend or r.n_devices != ranks
                    or r.iters != ITERS or not math.isfinite(r.busbw_gbps)
                    or (r.busbw_gbps <= 0) != latency_only or r.lat_us <= 0):
                fail(f"{what}: bad row {r}")
        big = max(rows, key=lambda r: (r.nbytes, -r.time_ms))
        small = min(rows, key=lambda r: (r.nbytes, r.lat_us))
        print(f"path: {what} --sweep {SWEEP} --sim-ranks {ranks}: "
              f"{len(rows)} rows in {wall:.1f} s, launches "
              f"{ {k: got[k] for k in needs} }, plain calls 0; largest point "
              f"{big.nbytes} B busbw {big.busbw_gbps:.1f} GB/s, smallest "
              f"point {small.nbytes} B lat {small.lat_us:.1f} us ({backend})")
        launches[op] = got
        # the run's outputs, the same op built at the same flags on the
        # same fill, against the selftest's numpy model
        for nbytes in sorted(set(CHECK_BYTES.get(op, (min(sizes),
                                                      max(sizes))))):
            t0 = time.perf_counter()
            results = run_selftest(SimWorld(ranks, dev), ops=[op],
                                   nbytes=nbytes, iters=ITERS)
            if any(r.status != "ok" for r in results):
                fail(f"{what} output at {nbytes} B:\n"
                     f"{format_results(results)}")
            print(f"path: {what} output at {nbytes} B/rank, "
                  f"iters={ITERS}: {results[0].detail} against the selftest "
                  f"model ({time.perf_counter() - t0:.1f} s)")
    # the reference's own default: no op named, -u, -x
    for flags, op in DEFAULT_RUNS:
        what = " ".join(["run", *flags])
        got, rows, wall = _drive(["run", *flags], what)
        if any(got.values()):
            fail(f"{what}: launched kernels {got} (a library op)")
        if (not rows or {(r.op, r.nbytes, r.n_devices, r.iters, r.backend)
                         for r in rows}
                != {(op, 456132, 8, 10, "torch-sim")}):
            fail(f"{what}: rows {rows}, want {op} at 456132 B, 8 ranks, "
                 "iters 10")
        print(f"path: {what}: {len(rows)} row(s) of {op} at 456132 B, "
              f"8 ranks, lat {rows[0].lat_us:.1f} us, busbw "
              f"{rows[0].busbw_gbps:.1f} GB/s in {wall:.1f} s")
    return launches


def phase_selftest() -> None:
    import torch

    from tpu_perf_torch.selftest import format_results, run_selftest
    from tpu_perf_torch.world import SimWorld

    dev = torch.device("cuda", torch.cuda.current_device())
    for n, dtype, iters in ((8, "float32", 3), (5, "float32", 1),
                            (1, "float32", 3), (8, "bfloat16", 3),
                            (8, "int32", 3), (1, "uint8", 2)):
        results = run_selftest(SimWorld(n, dev), nbytes=1 << 20,
                               dtype=dtype, iters=iters)
        if any(r.status == "fail" for r in results):
            fail(f"selftest n={n} {dtype}:\n{format_results(results)}")
        ok = sum(r.status == "ok" for r in results)
        print(f"selftest: n={n} {dtype} iters={iters}: {ok} ops match the "
              "numpy models")


def phase_grid() -> None:
    import torch

    from tpu_perf_torch import cli
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import hbm_read
    from tpu_perf_torch.world import SimWorld

    argv = ["grid", "--op", GRID_OPS, "--sizes", "256M,1G", "--iters", "8,32",
            "--spec", "hbm", "--sim-ranks", "1"]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    if rc != 0:
        fail(f"{' '.join(argv)} exited {rc}")
    print(f"grid: {len(GRID_OPS.split(','))} ops x 2 sizes x 2 iters judged "
          f"in {time.perf_counter() - t0:.1f} s")
    # the read sweep's time grows with the bytes it reads: a sweep whose
    # reads were dropped would take the same time at any size
    dev = torch.device("cuda", torch.cuda.current_device())
    ms = {}
    for nbytes in (MAIN_BYTES, 4 * MAIN_BYTES):
        x = build_op("pl_hbm_read", SimWorld(1, dev), nbytes, 1).example_input
        ms[nbytes] = cuda_ms(lambda: hbm_read(x), 20)
        del x
    ratio = ms[4 * MAIN_BYTES] / ms[MAIN_BYTES]
    print(f"read sweep: {ms[MAIN_BYTES]:.4f} ms at 256 MiB, "
          f"{ms[4 * MAIN_BYTES]:.4f} ms at 1 GiB: x{ratio:.2f} for 4x the "
          "bytes")
    if ratio < 3:
        fail(f"hbm_read time grew only x{ratio:.2f} for 4x the bytes")


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for ``nbytes`` of device-memory traffic and ``ops``
    float32 operations at this card's published rates, with both counts
    kept for the printout."""
    hbm_bytes_per_s, f32_ops_per_s = card_rates()
    t_bytes = nbytes / hbm_bytes_per_s * 1e3
    t_ops = ops / f32_ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _launches(launches: dict, op: str, name: str) -> dict:
    """A kernel's launches over its path's run, and per execution."""
    return {"launches": launches[op][name],
            "launches_per_execution": PATHS[op][0][name]}


def _cuda_row(launches: dict, name: str, replaces: int, op: str, err: float,
              ms: float, plain_ms: float, bound: dict, library_ms: float,
              shape, source: str | None = None, **extra) -> dict:
    """One CUDA kernel's entry of the kernels line, float32, from the
    source ``csrc/<source or name>.cu``; ``shape`` and ``dtype`` are for the
    printout and leave the JSON line."""
    return {"name": name, "route": "cuda",
            "source": f"tpu_perf_torch/csrc/{source or name}.cu",
            "replaces": f"tpu_perf/ops/pallas_ring.py:{replaces}",
            **_launches(launches, op, name), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms, **extra, "shape": list(shape),
            "dtype": "float32"}


def _gather_row(launches: dict, name: str, replaces: int, op: str,
                own, designs: dict) -> dict:
    """The kernels line's entry of gather entry ``name`` on own chunks
    ``own`` (n, chunk), as path ``op`` launches it: beside the expand copy
    (the library call), a broadcast ``copy_`` into a preallocated output,
    each design of the gather (``gather_designs``, checked exactly first)
    and ``pl_all_gather``'s own-shard carry after the gather."""
    import torch

    from tpu_perf_torch.ops import pallas_ring
    from tpu_perf_torch.tools.gather_designs import launcher

    kern = getattr(pallas_ring, name)
    plain = getattr(pallas_ring, f"{name}_plain")
    n, chunk = own.shape
    want = plain(own)
    err = check_exact(f"{name} at path shape", kern(own), want)
    out = torch.empty_like(want)
    designs_ms = {}
    for design, entry in designs.items():
        out.zero_()
        call = launcher(entry, own, out)
        call()
        check_exact(f"{name} design {design} at path shape", out, want)
        designs_ms[design] = cuda_ms(call, 10)
    d = torch.arange(n, device=own.device)
    # each rank's own chunk read once, the gathered rows written once
    return _cuda_row(
        launches, name, replaces, op, err, cuda_ms(lambda: kern(own), 10),
        cuda_ms(lambda: plain(own), 10),
        _bound((own.numel() + want.numel()) * own.element_size(), 0),
        cuda_ms(lambda: own.reshape(1, -1).expand(n, -1).contiguous(), 10),
        want.shape, source="all_gather",
        copy_broadcast_ms=cuda_ms(lambda: out.view(n, n, chunk).copy_(
            own.unsqueeze(0).expand(n, n, chunk)), 10),
        carry_ms=cuda_ms(lambda: want.view(n, n, chunk)[d, d], 10),
        designs_ms=designs_ms)


def _kernel_rows(per_rank_bytes: int, launches: dict,
                 designs: dict) -> list[dict]:
    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import (
        direct_all_gather, direct_reduce_scatter, direct_reduce_scatter_plain,
        mean_scale,
    )
    from tpu_perf_torch.ops.stream_triton import (
        stream, stream_constants, stream_plain,
    )
    from tpu_perf_torch.world import SimWorld

    dev = torch.device("cuda", torch.cuda.current_device())
    out = []

    # direct reduce-scatter at the pl_allreduce path's input, as that path
    # launches it (scaled by 1/n, the owned chunk alone)
    x = build_op("pl_allreduce", SimWorld(8, dev), per_rank_bytes, 1).example_input
    n = x.shape[0]
    chunk = x.shape[1] // n
    isz = x.element_size()
    inv = mean_scale(n, x.dtype)
    red = direct_reduce_scatter(x, scale=inv)
    err = check_close("direct_reduce_scatter at path shape", red,
                      direct_reduce_scatter_plain(x, inv), "float32")
    tiled_err = check_close(
        "direct_reduce_scatter tiled at path shape",
        direct_reduce_scatter(x, scale=inv, tiles=n),
        direct_reduce_scatter_plain(x, inv, n), "float32")
    # the carries the epilogue replaced, and the same carries now
    inv_t = torch.tensor(inv, dtype=x.dtype, device=dev)
    carries = {
        "pl_reduce_scatter_carry_before_ms":
            lambda: (direct_reduce_scatter(x) * inv_t).repeat(1, n),
        "pl_reduce_scatter_carry_ms":
            lambda: direct_reduce_scatter(x, scale=inv, tiles=n),
        "pl_allreduce_carry_before_ms":
            lambda: direct_all_gather(direct_reduce_scatter(x)).mul_(inv_t),
        "pl_allreduce_carry_ms":
            lambda: direct_all_gather(direct_reduce_scatter(x, scale=inv)),
    }
    # the function's own bytes: x read once, each rank's output row written
    # once; (n-1) adds and one multiply per reduced element
    tiled_bound = _bound((x.numel() + n * n * chunk) * isz, n * n * chunk)
    out.append(_cuda_row(
        launches, "direct_reduce_scatter", 599, "pl_allreduce", err,
        cuda_ms(lambda: direct_reduce_scatter(x, scale=inv), 10),
        cuda_ms(lambda: direct_reduce_scatter_plain(x, inv), 3, 1),
        _bound((x.numel() + n * chunk) * isz, n * n * chunk),
        cuda_ms(lambda: x.view(n, n, chunk).sum(0), 10), x.shape,
        source="reduce_scatter",
        tiled_ms=cuda_ms(lambda: direct_reduce_scatter(x, scale=inv, tiles=n),
                         10),
        tiled_plain_ms=cuda_ms(
            lambda: direct_reduce_scatter_plain(x, inv, n), 3, 1),
        tiled_bound_ms=tiled_bound["bound_ms"],
        tiled_max_abs_err=tiled_err,
        **{k: cuda_ms(fn, 10) for k, fn in carries.items()}))
    del carries

    # the gather at the pl_allreduce path's phase-2 input, the owned chunks
    del x
    out.append(_gather_row(launches, "direct_all_gather", 481, "pl_allreduce",
                           red, designs))
    del red

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
        **_launches(launches, "pl_hbm_stream", "stream"),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: stream(x), 10),
        "plain_ms": cuda_ms(lambda: stream_plain(x), 10),
        **bound,
        "library_ms": cuda_ms(lambda: torch.addcmul(shift, x, scale), 10),
        "shape": list(x.shape), "dtype": "float32",
    })
    del x
    out += _bulk_kernel_rows(per_rank_bytes, launches)
    out += _p2p_kernel_rows(per_rank_bytes, launches)
    out += _collective_kernel_rows(per_rank_bytes, launches, designs)
    return out


def _collective_kernel_rows(per_rank_bytes: int, launches: dict,
                            designs: dict) -> list[dict]:
    """The collective kernels at their 8-rank paths' inputs."""
    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import all_to_all, all_to_all_plain
    from tpu_perf_torch.world import SimWorld

    world = SimWorld(8, torch.device("cuda", torch.cuda.current_device()))
    out = []

    # all-to-all at the pl_all_to_all path's input: x read once, out
    # written once; the yardstick is the chunk transpose's copy
    x = build_op("pl_all_to_all", world, per_rank_bytes, 1).example_input
    n = x.shape[0]
    chunks = x.view(n, n, -1)
    err = check_close("all_to_all at path shape", all_to_all(x),
                      all_to_all_plain(x), "float32")
    out.append(_cuda_row(
        launches, "all_to_all", 291, "pl_all_to_all", err,
        cuda_ms(lambda: all_to_all(x), 10),
        cuda_ms(lambda: all_to_all_plain(x), 3, 1),
        _bound(2 * x.numel() * x.element_size(), 0),
        cuda_ms(lambda: chunks.transpose(0, 1).contiguous(), 10), x.shape))
    del x, chunks

    # the bidirectional gather at the pl_all_gather_bidir path's input,
    # checked over the whole gathered buffer
    x = build_op("pl_all_gather_bidir", world, per_rank_bytes,
                 1).example_input
    out.append(_gather_row(launches, "direct_all_gather_bidir", 430,
                           "pl_all_gather_bidir", x, designs))
    return out


def _p2p_kernel_rows(per_rank_bytes: int, launches: dict) -> list[dict]:
    """The point-to-point kernels at their 8-rank paths' inputs."""
    import torch

    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import (
        barrier, barrier_layout, barrier_plain, pair_exchange,
        pair_exchange_plain, pingpong, pingpong_plain, ring_shift,
        ring_shift_plain,
    )
    from tpu_perf_torch.world import SimWorld

    world = SimWorld(8, torch.device("cuda", torch.cuda.current_device()))
    out = []

    # ring and exchange: x read once, out written once
    x = build_op("pl_ring", world, per_rank_bytes, 1).example_input
    n = x.shape[0]
    nb = x.numel() * x.element_size()
    # the yardstick is the fastest PyTorch call of the function, the row
    # gather x[idx], its index built outside the timed call; index_select
    # and torch.roll beside it
    for name, replaces, op, kern, plain, shift in (
            ("ring", 345, "pl_ring", ring_shift, ring_shift_plain, 1),
            ("exchange", 365, "pl_exchange", pair_exchange,
             pair_exchange_plain, n // 2)):
        err = check_exact(f"{name} at path shape", kern(x), plain(x))
        idx = (torch.arange(n, device=x.device) - shift) % n
        out.append(_cuda_row(
            launches, name, replaces, op, err, cuda_ms(lambda: kern(x), 10),
            cuda_ms(lambda: plain(x), 10), _bound(2 * nb, 0),
            cuda_ms(lambda: x[idx], 10), x.shape, source="p2p_shift",
            index_select_ms=cuda_ms(lambda: x.index_select(0, idx), 10),
            roll_ms=cuda_ms(lambda: torch.roll(x, shift, 0), 10),
            graph_ms=graph_ms(lambda: chain(kern, x), chain(kern, x), 3,
                              f"graph of 100 chained {name} at path shape")))

    # pingpong: the function reads x once and writes out once; its schedule
    # moves group 0's payload through the stage, 3 * nb in all
    got, stage = pingpong(x)
    want, want_stage = torch.empty_like(x), torch.empty_like(x)
    pingpong_plain(x, want, want_stage)
    err = check_close("pingpong at path shape", got, want, "float32")
    check_close("pingpong stage at path shape", stage[n // 2:],
                want_stage[n // 2:], "float32")
    del got, stage
    schedule = _bound(3 * nb, 0)
    out.append(_cuda_row(
        launches, "pingpong", 385, "pl_pingpong", err,
        cuda_ms(lambda: pingpong(x), 10),
        cuda_ms(lambda: pingpong_plain(x, want, want_stage), 10),
        _bound(2 * nb, 0), cuda_ms(lambda: x.clone(), 10), x.shape,
        schedule_bound_ms=schedule["bound_ms"],
        schedule_bytes=schedule["bytes"]))
    del x, want, want_stage

    # barrier at its path's one-element rows: a latency, set beside an
    # empty kernel's launch through the same ctypes route, back to back on
    # one stream (host-bound) and replayed from a CUDA graph (the device's
    # own time per launch)
    x = build_op("pl_barrier", world, per_rank_bytes, 1).example_input
    err = check_close("barrier at path shape", barrier(x), barrier_plain(x),
                      "float32")
    empty = _build.entry("barrier", "empty_launch")
    reps = 2000

    def chained_barriers():
        y = x
        for _ in range(GRAPH_LAUNCHES):
            y = barrier(y)
        return y

    def empty_launches():
        stream_ptr = torch.cuda.current_stream().cuda_stream
        for _ in range(GRAPH_LAUNCHES):
            _build.check("empty_launch", empty(stream_ptr))

    stream_ptr = torch.cuda.current_stream().cuda_stream
    # the cluster launch alone: the C entry on a fixed output, without the
    # wrapper's checks and allocation
    launch = _build.entry("barrier")
    y = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], *barrier_layout(x.shape[0]),
            x.shape[1] * x.element_size(), stream_ptr)
    out.append(_cuda_row(
        launches, "barrier", 329, "pl_barrier", err,
        cuda_ms(lambda: barrier(x), reps),
        cuda_ms(lambda: barrier_plain(x), reps),
        _bound(2 * x.numel() * x.element_size(), 0),
        cuda_ms(lambda: x.clone(), reps), x.shape,
        launch_ms=cuda_ms(lambda: launch(*args), reps),
        empty_launch_ms=cuda_ms(lambda: empty(stream_ptr), reps),
        graph_ms=graph_ms(chained_barriers, x),
        empty_launch_graph_ms=graph_ms(empty_launches)))
    return out


#: launches captured in one CUDA graph for the barrier's device time
GRAPH_LAUNCHES = 100


def graph_ms(capture, want=None, replays: int = 50,
             what: str = "graph of chained barriers") -> float:
    """Device time per launch of ``capture()``'s GRAPH_LAUNCHES launches,
    captured once into a CUDA graph and replayed ``replays`` times back to
    back; where ``want`` is given, the graph's output must equal it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        capture()  # warm-up outside the graph, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up's stream, whose kernel counters it made
    with torch.cuda.graph(graph, stream=side):
        got = capture()
    graph.replay()
    torch.cuda.synchronize()
    if want is not None:
        check_close(what, got, want, "float32")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (replays * GRAPH_LAUNCHES)


def _bulk_kernel_rows(per_rank_bytes: int, launches: dict) -> list[dict]:
    """The three bulk-copy kernels at the one-rank local paths' inputs."""
    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import (
        hbm_copy, hbm_copy_plain, hbm_dma_block_elems, hbm_read,
        hbm_read_plain, hbm_write, hbm_write_plain,
    )
    from tpu_perf_torch.world import SimWorld

    world = SimWorld(1, torch.device("cuda", torch.cuda.current_device()))
    out = []

    # copy: x read once, out written once
    x = build_op("pl_hbm_copy", world, per_rank_bytes, 1).example_input
    nb = x.numel() * x.element_size()
    err = check_exact("hbm_copy at path shape", hbm_copy(x), hbm_copy_plain(x))
    y = torch.empty_like(x)
    out.append(_cuda_row(
        launches, "hbm_copy", 266, "pl_hbm_copy", err,
        cuda_ms(lambda: hbm_copy(x), 10), cuda_ms(lambda: hbm_copy_plain(x), 10),
        _bound(2 * nb, 0), cuda_ms(lambda: y.copy_(x), 10), x.shape,
        graph_ms=graph_ms(lambda: chain(hbm_copy, x), x, 5,
                          "graph of 100 chained hbm_copy at path shape")))
    del x, y

    # read sweep: x read once.  The yardstick amax reads the same bytes but
    # computes another function (the sweep computes nothing)
    x = build_op("pl_hbm_read", world, per_rank_bytes, 1).example_input
    nb = x.numel() * x.element_size()
    err = check_close("hbm_read at path shape", hbm_read(x), hbm_read_plain(x),
                      "float32")
    out.append(_cuda_row(launches, "hbm_read", 185, "pl_hbm_read", err,
                         cuda_ms(lambda: hbm_read(x), 10),
                         cuda_ms(lambda: hbm_read_plain(x), 10), _bound(nb, 0),
                         cuda_ms(lambda: torch.amax(x), 10), x.shape))

    # write sweep: the output written once, the seed block read once; the
    # yardstick is one copy_ of the expanded seed block
    n, elems = x.shape
    blk = hbm_dma_block_elems(x.element_size(), elems)
    nblocks, rem = divmod(elems, blk)
    if rem:
        fail(f"write sweep at {elems} elements has a rem tail; the library "
             "yardstick needs whole blocks")
    err = check_close("hbm_write at path shape", hbm_write(x, blk),
                      hbm_write_plain(x, blk), "float32")
    y = torch.empty_like(x)
    seed = x[:, None, :blk].expand(n, nblocks, blk)
    out.append(_cuda_row(
        launches, "hbm_write", 222, "pl_hbm_write", err,
        cuda_ms(lambda: hbm_write(x, blk), 10),
        cuda_ms(lambda: hbm_write_plain(x, blk), 10),
        _bound(nb + n * blk * x.element_size(), 0),
        cuda_ms(lambda: y.view(n, nblocks, blk).copy_(seed), 10), x.shape))
    return out

#: the card's name and power limit as nvidia-smi gives them (set in main)
CARD = "card not read"
#: the block main path's extended logs, for the report phase (a temporary
#: folder made in main)
REPORT_DIR: str | None = None
#: the block sweep's pl_allreduce rows, set beside the fused sweep's
BLOCK_ROWS: list = []
#: per-rank sizes of the fused phase for every op but the main path's
FUSED_BYTES = (4096, 16 * 1024**2)
#: the fused phase's pl_allreduce lat_us p50 at 4 KiB a rank, -i ITERS,
#: beside which the trace daemon prints its own
FUSED_LAT_4K: list = []
#: ops whose fused output is held within RTOL (they compute); the others
#: move bytes and are held exactly
ARITH_OPS = ("pl_allreduce", "pl_reduce_scatter", "allreduce",
             "pl_hbm_stream")
#: measured runs of the daemon phase: a visit takes well under a
#: millisecond, so this many outlast several 1 s log rotations
DAEMON_RUNS = 12000


def _check_fused_point(op: str, ranks: int, nbytes: int) -> list[float]:
    """One point's CUDA graph against the eager chain: warm a FusedRunner
    (eager run, capture, one replay), then replay twice; each replay must
    pass through no Python wrapper and leave the working buffer equal to
    RUNS eager runs of the op's step from the buffer it started from.
    Returns the last replay's per-run device times."""
    from tpu_perf_torch import kernels
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.runner import build_fused_point
    from tpu_perf_torch.timing import FusedRunner
    from tpu_perf_torch.world import SimWorld, resolve_device

    built = build_op(op, SimWorld(ranks, resolve_device()), nbytes, ITERS)
    runner = FusedRunner(build_fused_point(built, (RUNS,)), built)
    try:
        runner.warm()
        for replay in (1, 2):
            what = f"fused {op} at {nbytes} B/rank, replay {replay}"
            start = runner.buffer.clone()
            kernels.reset_counts()
            times = runner.chunk(RUNS)
            if any(kernels.LAUNCHES.values()) or any(
                    kernels.PLAIN_CALLS.values()):
                fail(f"{what}: the replay went through Python wrappers "
                     f"{kernels.LAUNCHES} {kernels.PLAIN_CALLS}")
            if len(times) != RUNS or not all(t > 0 for t in times):
                fail(f"{what}: per-run device times {times}")
            want = start
            for _ in range(RUNS):
                want = built.step(want)
            if op in GEMM_OPS:
                check_gemm(what, runner.buffer, want, "float32")
            elif op in ARITH_OPS:
                check_close(what, runner.buffer, want, "float32")
            else:
                check_exact(what, runner.buffer, want)
    finally:
        runner.close()
    return times


def _median(values):
    v = sorted(values)
    return v[len(v) // 2]


def phase_fused() -> None:
    """Every pl_* op and allreduce under --fence fused through the CLI
    (pl_allreduce over the main sweep at full width, the rest at 4 KiB and
    16 MiB a rank), and each point's graph against its eager chain."""
    import math

    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import sizes_for

    fused_rows = []
    for op, (needs, ranks) in PATHS.items():
        if not (op.startswith("pl_") or op == "allreduce"):
            continue
        sweep = (SWEEP if op == "pl_allreduce"
                 else ",".join(str(b) for b in FUSED_BYTES))
        sizes = sizes_for(Options(sweep=sweep, op=op))
        # a point launches through the wrappers twice: the eager warm-up
        # run of its chunk and the capture; replays launch from the graph
        executions = len(sizes) * 2 * RUNS * ITERS
        what = f"run --op {op} --fence fused"
        got, rows, wall = _drive(
            ["run", "--op", op, "--sweep", sweep, "-i", str(ITERS), "-r",
             str(RUNS), "--sim-ranks", str(ranks), "--fence", "fused"], what)
        wrong = {k: got[k] for k, per in needs.items()
                 if got[k] != per * executions}
        extra = [k for k, v in got.items() if v and k not in needs]
        if wrong or extra:
            fail(f"{what}: launches {got}, want {needs} per execution over "
                 f"{executions} warm-up and captured executions")
        if len(rows) != len(sizes) * RUNS:
            fail(f"{what}: {len(rows)} rows, want {len(sizes) * RUNS}")
        for r in rows:
            if (r.op != op or r.mode != "oneshot" or r.iters != ITERS
                    or not math.isfinite(r.busbw_gbps) or r.lat_us <= 0):
                fail(f"{what}: bad row {r}")
        checked = []
        for nbytes in ((4096, MAIN_BYTES) if op == "pl_allreduce"
                       else FUSED_BYTES[:len(sizes)]):
            times = _check_fused_point(op, ranks, nbytes)
            checked.append(f"{nbytes} B/rank {_median(times) * 1e3:.4f} ms "
                           "a run")
        print(f"fused: {what} --sweep {sweep} --sim-ranks {ranks}: "
              f"{len(rows)} rows in {wall:.1f} s, launches "
              f"{ {k: got[k] for k in needs} } (warm-up and capture only); "
              f"graph = eager chain over two replays at "
              f"{', '.join(checked)}")
        if op == "pl_allreduce":
            fused_rows = rows
    FUSED_LAT_4K[:] = [_median([r.lat_us for r in fused_rows
                                if r.nbytes == 4096])]
    for nbytes, metric in ((4096, "lat_us"), (MAIN_BYTES, "busbw_gbps")):
        fused = _median([getattr(r, metric) for r in fused_rows
                         if r.nbytes == nbytes])
        block = _median([getattr(r, metric) for r in BLOCK_ROWS
                         if r.nbytes == nbytes])
        print(f"fused vs block: pl_allreduce at {nbytes} B/rank, 8 ranks, "
              f"-i {ITERS} -r {RUNS}: {metric} p50 fused {fused:.3f}, block "
              f"{block:.3f}")


def phase_fences() -> None:
    """auto resolves to trace on the card; --measure-dispatch fills
    overhead_us under block and readback and leaves 0 under slope."""
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.driver import Driver

    resolved = Driver(Options(op="pl_allreduce", fence="auto")).opts.fence
    if resolved != "trace":
        fail(f"--fence auto resolved to {resolved!r} on the card")
    base = ["run", "--op", "pl_allreduce", "-b", "4K", "-i", str(ITERS),
            "-r", str(RUNS)]
    got, rows, _ = _drive(base + ["--fence", "auto"], "run --fence auto")
    # the trace fence's pair: lo and hi (4x) executions, launched through
    # the wrappers twice, by the eager warm-up and by the legs' captures;
    # the warm-up pair and the RUNS measured pairs are graph replays
    want = 2 * 5 * ITERS
    if (got["direct_reduce_scatter"], got["direct_all_gather"]) != (want, want):
        fail(f"run --fence auto: launches {got}, want {want} of each kernel")
    if len(rows) != RUNS or any(r.lat_us <= 0 for r in rows):
        fail(f"run --fence auto: rows {rows}")
    said = [f"auto -> {resolved}, lat p50 {_median([r.lat_us for r in rows]):.2f} us"]
    # two chunks: graphs of 2 runs and of 1 share the working buffer; the
    # warm-up runs the first chunk, the captures both
    got, rows, _ = _drive(base + ["--fence", "fused", "--fused-chunks", "2"],
                          "run --fence fused --fused-chunks 2")
    want = (2 + 2 + 1) * ITERS
    if ((got["direct_reduce_scatter"], got["direct_all_gather"]) != (want, want)
            or [r.run_id for r in rows] != list(range(1, RUNS + 1))):
        fail(f"--fused-chunks 2: launches {got}, rows {rows}")
    said.append(f"fused in 2 chunks, lat p50 "
                f"{_median([r.lat_us for r in rows]):.2f} us")
    for fence in ("block", "readback", "slope"):
        _, rows, _ = _drive(base + ["--fence", fence, "--measure-dispatch"],
                            f"run --fence {fence} --measure-dispatch")
        over = {r.overhead_us for r in rows}
        if len(rows) != RUNS or (fence == "slope") != (over == {0.0}) or any(
                o < 0 for o in over):
            fail(f"--fence {fence} --measure-dispatch: overhead_us {over}")
        said.append(f"{fence} overhead_us {sorted(over)}")
    print("fences: pl_allreduce at 4 KiB/rank: " + "; ".join(said))


def phase_profile() -> None:
    """--profile-dir traces of pl_allreduce at 4 KiB and 256 MiB a rank,
    under block and fused: each point's measured window is one kept trace,
    whose device time and idle share are printed."""
    import glob
    import tempfile

    from tpu_perf_torch.traceparse import device_summary

    with tempfile.TemporaryDirectory(prefix="chip_smoke-profile-") as root:
        for nbytes in (4096, MAIN_BYTES):
            for fence in ("block", "fused"):
                pdir = os.path.join(root, f"{fence}-{nbytes}")
                what = f"run --fence {fence} -b {nbytes} --profile-dir"
                _drive(["run", "--op", "pl_allreduce", "-b", str(nbytes),
                        "-i", str(ITERS), "-r", str(RUNS), "--fence", fence,
                        "--profile-dir", pdir], what)
                traces = glob.glob(os.path.join(pdir, "*.json"))
                if len(traces) != 1:
                    fail(f"{what}: traces {traces}, want one")
                s = device_summary(traces[0])
                counts = {key: sum(c for name, (c, _) in s.kernels.items()
                                   if key in name)
                          for key in ("direct_reduce", "gather")}
                if set(counts.values()) != {RUNS * ITERS}:
                    fail(f"{what}: kernels in the trace {s.kernels}")
                print(f"profile: pl_allreduce {fence} at {nbytes} B/rank, "
                      f"8 ranks, -i {ITERS} -r {RUNS}: kernels "
                      f"{counts} {s.kernel_s * 1e3:.4f} ms, device busy "
                      f"{s.busy_s * 1e3:.4f} ms of a {s.window_s * 1e3:.4f} "
                      f"ms window, idle share {s.idle_share:.4f}")


def phase_daemon() -> None:
    """monitor --fence fused with rotation every second and a local ingest
    sink: the rotated logs arrive in the sink and leave the log folder,
    and no row is lost; then the trace daemon (:func:`_trace_daemon`) and
    what a trace point's graphs hold (:func:`_trace_graph_bytes`)."""
    import glob
    import tempfile

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.schema import LegacyRow, ResultRow

    with tempfile.TemporaryDirectory(prefix="chip_smoke-daemon-") as root:
        logs, sink = os.path.join(root, "logs"), os.path.join(root, "sink")
        old = os.environ.get("TPU_PERF_INGEST")
        os.environ["TPU_PERF_INGEST"] = f"local:{sink}"
        try:
            kernels.reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["monitor", "--op", "pl_allreduce", "--sweep",
                           "4K,16M", "--fence", "fused", "--max-runs",
                           str(DAEMON_RUNS), "--log-refresh-sec", "1",
                           "--stats-every", str(DAEMON_RUNS), "-l", logs])
            wall = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("TPU_PERF_INGEST")
            else:
                os.environ["TPU_PERF_INGEST"] = old
        got = dict(kernels.LAUNCHES)
        what = "monitor --fence fused"
        if rc != 0:
            fail(f"{what} exited {rc}")
        # two points, each an eager warm-up run and a captured run of the
        # default 10 iterations; every visit replayed a graph
        if {k: v for k, v in got.items() if v} != {
                "direct_reduce_scatter": 40, "direct_all_gather": 40}:
            fail(f"{what}: launches {got}")
        arrived = sorted(os.listdir(sink)) if os.path.isdir(sink) else []
        left = sorted(os.listdir(logs))
        kinds = {n.split("-")[0] for n in arrived}
        if kinds != {"tcp", "tpu"} or set(arrived) & set(left):
            fail(f"{what}: sink {arrived}, log folder {left}")
        ext, legacy = [], []
        for folder in (sink, logs):
            for path in glob.glob(os.path.join(folder, "*.log")):
                with open(path) as fh:
                    lines = [ln for ln in fh if ln.strip()]
                if os.path.basename(path).startswith("tpu-"):
                    ext += [ResultRow.from_csv(ln) for ln in lines]
                else:
                    legacy += [LegacyRow.from_csv(ln) for ln in lines]
        if (sorted(r.run_id for r in ext) != list(range(1, DAEMON_RUNS + 1))
                or len(legacy) != DAEMON_RUNS
                or {r.mode for r in ext} != {"daemon"}
                or {r.nbytes for r in ext} != {4096, 16 * 1024**2}):
            fail(f"{what}: {len(ext)} extended and {len(legacy)} legacy rows "
                 f"in the sink and the log folder, modes "
                 f"{ {r.mode for r in ext} }")
        lat = {nb: _median([r.lat_us for r in ext if r.nbytes == nb])
               for nb in (4096, 16 * 1024**2)}
        print(f"daemon: {what} --sweep 4K,16M --max-runs {DAEMON_RUNS} "
              f"--log-refresh-sec 1: {wall:.1f} s, "
              f"{len(arrived) // 2} rotated file pair(s) ingested into the "
              f"local sink and gone from the log folder ({len(left)} newest "
              f"files stay), all {DAEMON_RUNS} rows mode=daemon, launches "
              f"{ {k: v for k, v in got.items() if v} } (warm-up and "
              f"capture only); lat p50 {lat[4096]:.2f} us at 4 KiB, "
              f"{lat[16 * 1024**2]:.2f} us at 16 MiB a rank")
        _trace_daemon(os.path.join(root, "trace"), lat[4096])
    _trace_graph_bytes()


def _trace_graph_bytes() -> None:
    """What a trace point's two leg graphs hold at the sweep's largest
    points (a daemon keeps one pair a point for its life): pl_allreduce
    and overlap_ring at 8 ranks x MAIN_BYTES (2 GiB a buffer), -i ITERS."""
    import torch

    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import build_point_pair
    from tpu_perf_torch.timing import TraceRunner
    from tpu_perf_torch.world import SimWorld, resolve_device

    said = []
    world = SimWorld(8, resolve_device())
    for op in ("pl_allreduce", "overlap_ring"):
        opts = Options(op=op, iters=ITERS, fence="trace")
        built, built_hi = build_point_pair(opts, world, op, MAIN_BYTES)
        runner = TraceRunner(built.step, built_hi.step, built.example_input,
                             built.iters, built_hi.iters)
        runner.warm()
        x = built.example_input
        said.append(f"{op} {runner.graph_bytes / 2**30:.2f} GiB beside its "
                    f"{x.numel() * x.element_size() / 2**30:.2f} GiB input, "
                    f"slope {runner.sample() * 1e3:.4f} ms an execution")
        runner.close()
        del built, built_hi, runner, x
    torch.cuda.empty_cache()
    print(f"daemon: a trace point's leg graphs at 8 ranks x {MAIN_BYTES} B, "
          f"-i {ITERS}: " + "; ".join(said))


#: the trace daemon's visits, plain and with the lo leg stalled, and the
#: stall: a host sleep before and after each replay of the lo leg
TRACE_VISITS, TRACE_STALLED_VISITS, TRACE_STALL_S = 300, 100, 0.002
#: the trace gate's pin: this many more plain visits, every pair positive
#: and no gate timed out; the lo legs above STALL_FACTOR times their
#: median are counted
PIN_VISITS, STALL_FACTOR = 10000, 2.0


def _trace_daemon(logs: str, fused_lat_us: float) -> None:
    """monitor --fence trace at 4 KiB a rank: TRACE_VISITS visits, then
    TRACE_STALLED_VISITS with a host stall around every replay of the lo
    leg.  Each visit is one replay of each leg's graph: every pair must be
    positive, the launches must be the warm-up's and the captures' only,
    and the stalled lo legs' median must lie within 10% of the plain
    ones'.  Prints the trace lat_us beside the fused daemon's."""
    import glob

    from tpu_perf_torch import cli, kernels, timing
    from tpu_perf_torch.schema import ResultRow

    legs: list[tuple[float, float]] = []
    runners = []
    plain_pair, plain_replay = timing.TraceRunner.pair, \
        timing.TraceRunner.replay

    def pair(self):
        if self not in runners:
            runners.append(self)
        legs.append(plain_pair(self))
        return legs[-1]

    def stalled(self, leg):
        if leg == "lo":
            time.sleep(TRACE_STALL_S)
        plain_replay(self, leg)
        if leg == "lo":
            time.sleep(TRACE_STALL_S)

    # every kernel of the point: lo and hi (4x) executions, each launched
    # by the eager warm-up and by its leg's capture; the visits replay
    want = 2 * 5 * ITERS
    lo_ms, lats, pin = {}, {}, {}
    timing.TraceRunner.pair = pair
    try:
        for label, visits in (("plain", TRACE_VISITS), ("pin", PIN_VISITS),
                              ("stalled", TRACE_STALLED_VISITS)):
            if label == "stalled":
                timing.TraceRunner.replay = stalled
            folder = os.path.join(logs, label)
            legs.clear()
            runners.clear()
            kernels.reset_counts()
            rc = cli.main(["monitor", "--op", "pl_allreduce", "-b", "4K",
                           "-i", str(ITERS), "--fence", "trace",
                           "--max-runs", str(visits), "--stats-every",
                           str(visits), "-l", folder])
            rows = []
            for path in glob.glob(os.path.join(folder, "tpu-*.log")):
                with open(path) as fh:
                    rows += [ResultRow.from_csv(ln) for ln in fh
                             if ln.strip()]
            what = f"monitor --fence trace, {visits} {label} visits"
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            if (rc != 0 or launched != {"direct_reduce_scatter": want,
                                        "direct_all_gather": want}
                    or sorted(r.run_id for r in rows)
                    != list(range(1, visits + 1))
                    or {r.mode for r in rows} != {"daemon"}):
                fail(f"{what}: rc {rc}, launches {launched}, "
                     f"{len(rows)} rows")
            bad = [p for p in legs if p[1] <= p[0]]
            if len(legs) != visits or bad:
                fail(f"{what}: {len(legs)} pairs, non-positive {bad[:5]}")
            missed = sum(r.missed() for r in runners)
            if missed:
                fail(f"{what}: {missed} trace gates opened on their timeout")
            lo_ms[label] = _median([lo for lo, _ in legs]) * 1e3
            lats[label] = _median([r.lat_us for r in rows])
            if label == "pin":
                los = sorted(lo for lo, _ in legs)
                slow = [lo for lo in los if lo > STALL_FACTOR * los[
                    len(los) // 2]]
                pin = {"max_ms": los[-1] * 1e3, "stalled": len(slow)}
    finally:
        timing.TraceRunner.pair = plain_pair
        timing.TraceRunner.replay = plain_replay
    drift = lo_ms["stalled"] / lo_ms["plain"] - 1
    if abs(drift) > 0.10:
        fail(f"monitor --fence trace: the lo leg's median {lo_ms['plain']:.4f}"
             f" ms, {lo_ms['stalled']:.4f} ms with a {TRACE_STALL_S * 1e3:g} "
             "ms host stall around its replay: the stall entered the leg")
    print(f"daemon: the trace gate's pin: {PIN_VISITS} more visits, every "
          f"pair positive, no gate timed out; {pin['stalled']} lo legs above "
          f"{STALL_FACTOR:g} x their median {lo_ms['pin']:.4f} ms (the "
          f"largest {pin['max_ms']:.4f} ms) ({CARD})")
    print(f"daemon: monitor --fence trace -b 4K -i {ITERS}, pl_allreduce at "
          f"8 ranks: {TRACE_VISITS} visits and {TRACE_STALLED_VISITS} with a "
          f"{TRACE_STALL_S * 1e3:g} ms host stall around each lo replay, "
          f"every pair positive; lo leg median {lo_ms['plain']:.4f} ms, "
          f"stalled {lo_ms['stalled']:.4f} ms ({drift:+.1%}); launches "
          f"{want} of each kernel a run (warm-up and captures only); trace "
          f"lat p50 {lats['plain']:.2f} us (stalled {lats['stalled']:.2f}) "
          f"beside the fused daemon's {fused_lat_us:.2f} us (-i 10) at 4 KiB "
          f"(trace / fused {lats['plain'] / fused_lat_us:.3f})"
          + "".join(f" and the fused run's {f:.2f} us (-i {ITERS}; trace / "
                    f"fused {lats['plain'] / f:.3f})" for f in FUSED_LAT_4K))


#: the health phase: the synthetic twin's flags and schedule (the JAX
#: package's chaos acceptance soak), run on the card and on the CPU
HEALTH_TWIN_SPEC = {"faults": [
    {"kind": "spike", "op": "ring", "nbytes": 32, "start": 60, "end": 80,
     "magnitude": 30.0},
    {"kind": "drop_run", "op": "ring", "nbytes": 8, "start": 81, "end": 120},
    {"kind": "hook_fail", "start": 130, "end": 135},
    {"kind": "delay", "op": "ring", "nbytes": 32, "start": 150, "end": 400,
     "magnitude": 3.0},
    {"kind": "flatline", "op": "ring", "nbytes": 8, "start": 200, "end": 400},
]}
HEALTH_TWIN_ARGS = ("--synthetic", "0.001", "--seed", "7", "--op", "ring",
                    "--sweep", "8,32", "-i", "1", "--stats-every", "20",
                    "--health-warmup", "20", "--max-runs", "400")
#: the real-timing soak: pl_allreduce fused at 4 KiB and 16 MiB a rank,
#: round robin (odd runs 4 KiB, even 16 MiB), one fault of each kind;
#: the per-sample faults sit on 16 MiB, whose samples a quantized event
#: timer does not repeat, and the delay follows the baseline's warm-up
#: closely, so a regression the card raises by itself has little time to
#: stand where the delay begins
HEALTH_BIG = 16 * 1024**2
HEALTH_REAL_SPEC = {"faults": [
    {"kind": "spike", "op": "pl_allreduce", "nbytes": HEALTH_BIG,
     "start": 101, "end": 120, "magnitude": 30.0},
    {"kind": "delay", "op": "pl_allreduce", "nbytes": HEALTH_BIG,
     "start": 131, "end": 250, "magnitude": 3.0},
    {"kind": "flatline", "op": "pl_allreduce", "nbytes": HEALTH_BIG,
     "start": 301, "end": 400},
    {"kind": "drop_run", "op": "pl_allreduce", "nbytes": 4096, "start": 401,
     "end": 450},
    {"kind": "hook_fail", "start": 460, "end": 465},
    {"kind": "corrupt", "op": "pl_allreduce"},
]}
HEALTH_REAL_RUNS, HEALTH_STATS = 500, 50
#: the fault-free soaks (does a quantized timer flatline, does card noise
#: spike) and the --spans tax runs
HEALTH_SOAK_VISITS, SPANS_TAX_RUNS = 5000, 500


def _jsonl(folder: str, prefix: str) -> list[dict]:
    import glob

    out = []
    for path in sorted(glob.glob(os.path.join(folder, f"{prefix}-*.log"))):
        with open(path) as fh:
            out += [json.loads(ln) for ln in fh if ln.strip()]
    return out


def _rows_in(folder: str) -> list:
    import glob

    from tpu_perf_torch.schema import ResultRow

    rows = []
    for path in glob.glob(os.path.join(folder, "tpu-*.log")):
        with open(path) as fh:
            rows += [ResultRow.from_csv(ln) for ln in fh if ln.strip()]
    return rows


def _ledger_bytes(folder: str) -> bytes:
    import glob

    return b"".join(open(p, "rb").read() for p in sorted(
        glob.glob(os.path.join(folder, "chaos-*.log"))))


def _verify(folder: str, what: str) -> str:
    """chaos verify over ``folder``: its markdown, failing unless it exits 0."""
    import contextlib
    import io

    from tpu_perf_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["chaos", "verify", folder])
    out = buf.getvalue()
    if rc != 0:
        fail(f"{what}: chaos verify exited {rc}:\n{out}")
    return out


def _health_twin(root: str) -> str:
    """Gate 1: the synthetic soak on the card and on the CPU writes the
    same ledger bytes and the same events, and chaos verify catches all
    five faults."""
    from tpu_perf_torch import cli

    spec = os.path.join(root, "twin.json")
    with open(spec, "w") as fh:
        json.dump(HEALTH_TWIN_SPEC, fh)
    sides = {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(root, f"twin-{device}")
        rc = cli.main(["chaos", "--faults", spec, *HEALTH_TWIN_ARGS,
                       "--device", device, "-l", folder])
        if rc != 0:
            fail(f"chaos --synthetic on {device} exited {rc}")
        events = [(e["kind"], e["op"], e["nbytes"], e["run_id"],
                   e["severity"], e["observed"], e["baseline"])
                  for e in _jsonl(folder, "health")]
        sides[device] = (_ledger_bytes(folder), events, folder)
    (lc, ec, folder), (lp, ep, _) = sides["cuda"], sides["cpu"]
    if not lc or lc != lp:
        fail(f"chaos --synthetic: the ledgers differ between the card and "
             f"the CPU ({len(lc)} and {len(lp)} bytes)")
    if ec != ep or not ec:
        fail(f"chaos --synthetic: events differ: card {ec}, CPU {ep}")
    out = _verify(folder, "chaos --synthetic")
    if "5/5 fault(s) caught" not in out:
        fail(f"chaos --synthetic: verify did not catch all five:\n{out}")
    return (f"synthetic twin (the JAX acceptance soak, 400 runs): ledger "
            f"{len(lc)} B identical on the card and the CPU, {len(ec)} "
            f"events identical, verify 5/5 caught")


def _textfile_points(path: str) -> dict:
    """The Prometheus textfile's series, by metric name: each a list of
    (labels, value); a line that does not parse fails."""
    import re

    series: dict = {}
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)",
                             ln)
            if not m:
                fail(f"health textfile: unparseable line {ln!r}")
            series.setdefault(m.group(1), []).append(
                (m.group(2) or "", float(m.group(3))))
    return series


def _health_real(root: str) -> tuple[str, list[str]]:
    """Gates 2-4: the fused pl_allreduce soak with every fault kind, real
    timing, --spans and --health-textfile: verify exits 0 with no critical
    miss, every row, event and ledger entry joins exactly one run span,
    the Chrome trace validates, and the textfile holds one gauge set a
    point.  The launches are the two points' warm-ups and captures and
    the corrupt pass's one execution."""
    import glob

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.faults import read_ledger
    from tpu_perf_torch.health.events import HealthEvent
    from tpu_perf_torch.spans import read_span_records
    from tpu_perf_torch.trace import (
        join_completeness, to_chrome_trace, validate_chrome_trace,
    )

    spec = os.path.join(root, "real.json")
    with open(spec, "w") as fh:
        json.dump(HEALTH_REAL_SPEC, fh)
    folder = os.path.join(root, "real")
    prom = os.path.join(root, "health.prom")
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["chaos", "--faults", spec, "--seed", "7", "--op",
                   "pl_allreduce", "--sweep", "4K,16M", "--fence", "fused",
                   "--max-runs", str(HEALTH_REAL_RUNS), "--stats-every",
                   str(HEALTH_STATS), "--spans", "--health-textfile", prom,
                   "-l", folder])
    wall = time.perf_counter() - t0
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    what = "chaos --fence fused, real timing"
    if rc != 0:
        fail(f"{what} exited {rc}")
    if got != {"direct_reduce_scatter": 41, "direct_all_gather": 41}:
        fail(f"{what}: launches {got}")
    out = _verify(folder, what)
    if "0 critical miss(es)" not in out:
        fail(f"{what}: a critical fault was missed:\n{out}")
    verdicts = [ln for ln in out.splitlines() if ln.startswith("| ")
                and ln.split("|")[1].strip().isdigit()]
    spans = read_span_records(sorted(glob.glob(
        os.path.join(folder, "spans-*.log"))))
    rows = _rows_in(folder)
    events = [HealthEvent(**e) for e in _jsonl(folder, "health")]
    ledger = read_ledger(sorted(glob.glob(
        os.path.join(folder, "chaos-*.log"))))
    missing = join_completeness(spans, rows=rows, events=events,
                                ledger=ledger)
    if missing or not rows:
        fail(f"{what}: {len(missing)} records join no run span (or more "
             f"than one): {missing[:5]}")
    problems = validate_chrome_trace(to_chrome_trace(spans))
    if problems:
        fail(f"{what}: the Chrome trace does not validate: {problems[:5]}")
    series = _textfile_points(prom)
    for name in ("tpu_perf_health_lat_p50_us", "tpu_perf_health_lat_p99_us",
                 "tpu_perf_health_busbw_gbps",
                 "tpu_perf_health_samples_total",
                 "tpu_perf_health_point_severity"):
        sizes = sorted(lbl for lbl, _ in series.get(name, []))
        if (len(sizes) != 2 or not any('nbytes="4096"' in s for s in sizes)
                or not any(f'nbytes="{HEALTH_BIG}"' in s for s in sizes)):
            fail(f"health textfile: {name} series {sizes}")
    kinds = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    said = (f"real timing: chaos --fence fused pl_allreduce 4K,16M, "
            f"{HEALTH_REAL_RUNS} visits, {len(HEALTH_REAL_SPEC['faults'])} "
            f"faults: verify exit 0, 0 critical misses ({wall:.1f} s); "
            f"events {kinds}; {len(spans)} spans, every one of "
            f"{len(rows)} rows, {len(events)} events and {len(ledger)} "
            f"ledger records joins one run span, the Chrome trace "
            f"validates; textfile {len(series)} metrics, one gauge set a "
            f"point; launches {got}")
    return said, verdicts


def _samples_by_point() -> tuple[dict, object]:
    """Patch HealthMonitor.observe to keep every raw sample it judges, by
    point; returns (samples, restore)."""
    from tpu_perf_torch.health import monitor

    samples: dict = {}
    plain = monitor.HealthMonitor.observe

    def observe(self, op, nbytes, iters, n_devices, run_id, t, span_id=""):
        samples.setdefault((op, nbytes), []).append(t)
        return plain(self, op, nbytes, iters, n_devices, run_id, t,
                     span_id=span_id)

    monitor.HealthMonitor.observe = observe

    def restore():
        monitor.HealthMonitor.observe = plain

    return samples, restore


def _longest_repeat(values: list) -> int:
    best = run = 0
    last = None
    for v in values:
        run = run + 1 if v == last else 1
        last = v
        best = max(best, run)
    return best


def _health_soaks(root: str) -> list[str]:
    """Printed, not gated: a fault-free monitor --health of
    HEALTH_SOAK_VISITS visits at 4 KiB under fused and under trace, its
    events by kind and each point's distinct sample values and longest run
    of identical samples (the flatline detector fires at 20)."""
    from tpu_perf_torch import cli

    said = []
    for fence in ("fused", "trace"):
        folder = os.path.join(root, f"soak-{fence}")
        samples, restore = _samples_by_point()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["monitor", "--op", "pl_allreduce", "-b", "4K",
                           "--fence", fence, "--health", "--max-runs",
                           str(HEALTH_SOAK_VISITS), "--stats-every",
                           str(HEALTH_SOAK_VISITS), "-l", folder])
        finally:
            restore()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"monitor --health --fence {fence} exited {rc}")
        kinds, alarms = {}, []
        for e in _jsonl(folder, "health"):
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            if e["kind"] != "recovered":
                alarms.append(f"{e['kind']} at run {e['run_id']}: "
                              f"{e['observed'] * 1e6:.3f} us against "
                              f"{e['baseline'] * 1e6:.3f}")
        pts = ", ".join(
            f"{op}/{nb}: {len(v)} samples, {len(set(v))} distinct, longest "
            f"identical run {_longest_repeat(v)}, p50 "
            f"{_median(v) * 1e6:.3f} us"
            for (op, nb), v in sorted(samples.items()))
        said.append(f"fault-free monitor --health --fence {fence} -b 4K, "
                    f"{HEALTH_SOAK_VISITS} visits ({wall:.1f} s): events "
                    f"{kinds or 'none'} ({'; '.join(alarms) or 'none'}); "
                    f"{pts}")
    return said


def _spans_tax(root: str) -> list[str]:
    """Printed, not gated: pl_allreduce lat_us p50 at 4 KiB under block and
    fused, with --spans off and on, in turns off, on, off, on."""
    from tpu_perf_torch import cli

    said = []
    for fence in ("block", "fused"):
        p50 = {"off": [], "on": []}
        for i, side in enumerate(("off", "on", "off", "on")):
            folder = os.path.join(root, f"tax-{fence}-{i}")
            rc = cli.main(["run", "--op", "pl_allreduce", "-b", "4K", "-r",
                           str(SPANS_TAX_RUNS), "--fence", fence, "-l",
                           folder] + (["--spans"] if side == "on" else []))
            if rc != 0:
                fail(f"run --fence {fence} --spans {side} exited {rc}")
            p50[side].append(_median([r.lat_us for r in _rows_in(folder)]))
        said.append(f"--spans tax, pl_allreduce -b 4K -r {SPANS_TAX_RUNS} "
                    f"--fence {fence}: lat p50 off "
                    + ", ".join(f"{v:.3f}" for v in p50["off"]) + " us, on "
                    + ", ".join(f"{v:.3f}" for v in p50["on"]) + " us")
    return said


def phase_health() -> None:
    """The fleet-health monitor and its chaos judge on the card: the
    synthetic twin (gate 1), the real-timing fused soak with every fault
    kind under --spans and --health-textfile (gates 2-4), then, printed
    and never gated, the fault-free soaks' events and sample values and
    the --spans tax."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-health-") as root:
        print(f"health: {_health_twin(root)}", flush=True)
        said, verdicts = _health_real(root)
        print(f"health: {said}", flush=True)
        for ln in verdicts:
            print(f"health: verdict {ln}", flush=True)
        for ln in _health_soaks(root) + _spans_tax(root):
            print(f"health: {ln} ({CARD})", flush=True)
    print(f"health: phase wall {time.perf_counter() - t0:.1f} s")


def phase_report() -> None:
    """report, --compare-pallas and --format json over the block paths'
    logs: pl_allreduce paired with allreduce at every size of the sweep."""
    import contextlib
    import io

    from tpu_perf_torch import cli
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import sizes_for

    def report(*flags) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["report", REPORT_DIR, *flags])
        if rc != 0:
            fail(f"report {' '.join(flags)} exited {rc}")
        return out.getvalue()

    n_sizes = len(sizes_for(Options(sweep=SWEEP, op="pl_allreduce")))
    table = report()
    curves = [ln for ln in table.splitlines()
              if ln.startswith("| torch-sim | pl_allreduce |")]
    points = json.loads(report("--format", "json"))
    sizes = {op: {p["nbytes"] for p in points if p["op"] == op}
             for op in ("pl_allreduce", "allreduce")}
    # the two ops round a size alike except 456131 B (pl_allreduce takes
    # whole chunks of its ranks): those keys are one-sided, the rest pair
    shared = sizes["pl_allreduce"] & sizes["allreduce"]
    pairs = []
    for ln in report("--compare-pallas").splitlines():
        cells = [c.strip() for c in ln.strip("|").split("|")]
        if cells[:2] == ["allreduce", "pl_allreduce"]:
            if "—" not in cells[4:6]:
                pairs.append(cells)
    ours = [p for p in points if p["op"] == "pl_allreduce"]
    if (len(curves) != n_sizes or len(ours) != n_sizes
            or {p["runs"] for p in ours} != {RUNS}
            or len(shared) < n_sizes - 1 or len(pairs) != len(shared)):
        fail(f"report: {len(curves)} curve lines and {len(ours)} json "
             f"points of pl_allreduce, want {n_sizes}; {len(pairs)} pairs "
             f"with allreduce, want {len(shared)}")
    top = pairs[-1]
    print(f"report: {len(points)} curve points over the block paths' logs; "
          f"--compare-pallas pairs pl_allreduce with allreduce at the "
          f"{len(pairs)} sizes both hold of its {n_sizes} (at {top[2]}: "
          f"busbw p50 {top[4]} library, {top[5]} kernel, ratio {top[6]})")



#: the reference's default buffer (mpi_perf.c:14)
DEF_BUF = 456131
#: the windowed runs: the reference's default buffer at windows of 1, 8
#: and the reference's 256-slot request window (mpi_perf.c:88)
SURFACE_WINDOWS = (1, 8, 256)
#: the production daemon's instrument family (the barrier is one point)
FAMILY = ("pl_allreduce,pl_reduce_scatter,pl_all_gather,pl_hbm_copy,"
          "pl_ring,pl_pingpong,pl_barrier,allreduce")
FAMILY_SWEEP = (4096, 16 * 1024**2)
#: the family daemon's measured runs and its heartbeat period
FAMILY_RUNS, FAMILY_STATS = 6000, 1000
#: launches per execution of each family op's kernels (PATHS)
FAMILY_KERNELS = {op: PATHS[op][0] for op in FAMILY.split(",")}


def _host_cpu() -> str:
    """The host CPU, the label of the C baseline's numbers: lscpu's model
    name, /proc/cpuinfo's, and the logical CPUs this process may use."""
    names = []
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             check=True).stdout
        names += [f"lscpu {ln.split(':', 1)[1].strip()!r}"
                  for ln in out.splitlines() if ln.startswith("Model name:")]
    except (OSError, subprocess.CalledProcessError):
        names.append("no lscpu")
    with open("/proc/cpuinfo") as fh:
        model = {ln.split(":", 1)[1].strip() for ln in fh
                 if ln.startswith("model name")}
    names.append(f"/proc/cpuinfo {', '.join(sorted(model)) or 'none'!r}")
    return f"{'; '.join(names)}; {len(os.sched_getaffinity(0))} CPUs"


def _plain_windowed_exchange(window: int, n: int, elems: int, iters: int,
                             dev):
    """The windowed exchange computed on ``dev`` by rows, in the JAX
    global layout ``(W, n*elems)``: make_fill's values, then ``iters``
    rounds in which every rank's W buffers go to its pair partner."""
    import torch

    from tpu_perf_torch.topology import pair_permutation

    total = window * n * elems
    g = (torch.arange(total, dtype=torch.float64, device=dev)
         .remainder_(251).div_(251.0).add_(1.0).float())
    v = g.view(window, n, elems)
    for _ in range(iters):
        nxt = torch.empty_like(v)
        for src, dst in pair_permutation(n):
            nxt[:, dst] = v[:, src]
        v = nxt
    return v.reshape(window, n * elems)


def _surface_windows() -> None:
    """(a) run -x --window W at the reference's default buffer, W = 1, 8,
    256: the rows share nbytes, iters counts every message, and the
    output equals the plain windowed exchange exactly."""
    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.world import SimWorld, resolve_device

    nbytes = None
    for w in SURFACE_WINDOWS:
        what = f"run -x --window {w}"
        got, rows, wall = _drive(["run", "-x", "--window", str(w), "-b",
                                  str(DEF_BUF), "-i", "10", "-r", "3",
                                  "--sim-ranks", "8"], what)
        if any(got.values()):
            fail(f"{what}: launched kernels {got} (a library op)")
        if not rows:
            fail(f"{what}: no rows")
        keys = {(r.op, r.nbytes, r.iters, r.n_devices, r.backend)
                for r in rows}
        nbytes = nbytes or rows[0].nbytes
        if len(rows) != 3 or keys != {("exchange", nbytes, 10 * w, 8,
                                       "torch-sim")}:
            fail(f"{what}: rows {keys}, want exchange at one nbytes with "
                 f"iters {10 * w}")
        # the output at the run's flags (10: even, the input again) and at
        # one iteration, where a layout that mixed the windows would show
        world = SimWorld(8, resolve_device())
        for iters in (10, 1):
            built = build_op("exchange", world, DEF_BUF, iters, window=w)
            x = built.example_input
            out = built.step(x)
            elems = x.shape[-1]
            check_exact(f"{what} output, -i {iters}",
                        out.reshape(8, w, elems).transpose(0, 1)
                        .reshape(w, -1),
                        _plain_windowed_exchange(w, 8, elems, iters,
                                                 x.device))
            del built, x, out
        torch.cuda.empty_cache()
        print(f"surface: {what} -b {DEF_BUF} -i 10 -r 3 --sim-ranks 8: "
              f"{len(rows)} rows at {nbytes} B, iters {10 * w}, "
              f"{w * 8 * nbytes} B in flight; lat p50 "
              f"{_median([r.lat_us for r in rows]):.3f} us, busbw p50 "
              f"{_median([r.busbw_gbps for r in rows]):.3f} GB/s "
              f"({wall:.1f} s); output = the plain windowed exchange "
              "at -i 10 and -i 1")


def _surface_family() -> None:
    """(b) monitor over an instrument family under --fence fused, logs
    rotating every second into a local: sink, JSON heartbeats."""
    import contextlib
    import datetime
    import glob
    import io
    import tempfile

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import sizes_for
    from tpu_perf_torch.schema import LegacyRow, ResultRow

    sweep = ",".join(str(b) for b in FAMILY_SWEEP)
    points = [(op, nb) for op in FAMILY.split(",")
              for nb in sizes_for(Options(sweep=sweep, op=op))]
    what = "monitor --op <family> --fence fused"
    with tempfile.TemporaryDirectory(prefix="chip_smoke-family-") as root:
        logs, sink = os.path.join(root, "logs"), os.path.join(root, "sink")
        old = os.environ.get("TPU_PERF_INGEST")
        os.environ["TPU_PERF_INGEST"] = f"local:{sink}"
        err = io.StringIO()
        try:
            kernels.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["monitor", "--op", FAMILY, "--fence", "fused",
                               "--sweep", sweep, "--max-runs",
                               str(FAMILY_RUNS), "--heartbeat-format",
                               "json", "--stats-every", str(FAMILY_STATS),
                               "--log-refresh-sec", "1", "-l", logs])
            wall = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("TPU_PERF_INGEST")
            else:
                os.environ["TPU_PERF_INGEST"] = old
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if rc != 0:
            fail(f"{what} exited {rc}: {err.getvalue()[-2000:]}")
        # each point: an eager warm-up run and a captured run of the
        # default 10 iterations; every visit replayed a graph
        want: dict[str, int] = {}
        for op, _ in points:
            for k, per in FAMILY_KERNELS[op].items():
                want[k] = want.get(k, 0) + 2 * 10 * per
        if got != want or any(kernels.PLAIN_CALLS.values()):
            fail(f"{what}: launches {got}, want {want} (warm-up and capture "
                 f"only), plain calls {kernels.PLAIN_CALLS}")
        lines = err.getvalue().splitlines()
        beats = [json.loads(ln) for ln in lines if ln.startswith("{")]
        held = [ln for ln in lines if "daemon:" in ln]
        if (len(beats) != FAMILY_RUNS // FAMILY_STATS
                or any(sum(b["points"].values()) != b["samples"]
                       or b["samples"] != FAMILY_STATS for b in beats)
                or [b["run"] for b in beats]
                != list(range(FAMILY_STATS, FAMILY_RUNS + 1, FAMILY_STATS))):
            fail(f"{what}: heartbeats {beats}")
        ext, legacy = [], []
        for folder in (sink, logs):
            for path in glob.glob(os.path.join(folder, "*.log")):
                with open(path) as fh:
                    rows = [ln for ln in fh if ln.strip()]
                if os.path.basename(path).startswith("tpu-"):
                    ext += [ResultRow.from_csv(ln) for ln in rows]
                else:
                    legacy += [LegacyRow.from_csv(ln) for ln in rows]
        arrived = os.listdir(sink) if os.path.isdir(sink) else []
        counts: dict[tuple, int] = {}
        for r in ext:
            counts[(r.op, r.nbytes)] = counts.get((r.op, r.nbytes), 0) + 1
        even = FAMILY_RUNS / len(points)
        if (sorted(r.run_id for r in ext) != list(range(1, FAMILY_RUNS + 1))
                or len(legacy) != FAMILY_RUNS or len(counts) != len(points)
                or any(abs(c - even) > 1 for c in counts.values())
                or not arrived):
            fail(f"{what}: {len(ext)} extended and {len(legacy)} legacy rows, "
                 f"points {counts}, {len(arrived)} files in the sink")
        stamps = sorted(datetime.datetime.strptime(r.timestamp,
                                                   "%Y-%m-%d %H:%M:%S.%f")
                        for r in ext)
        span = (stamps[-1] - stamps[0]).total_seconds()
        lat = {k: _median([r.lat_us for r in ext if (r.op, r.nbytes) == k])
               for k in counts}
    print(f"surface: {held[0] if held else 'daemon: no residency line'}")
    print(f"surface: {what} ({len(points)} points: {FAMILY}, --sweep "
          f"{sweep}) --max-runs {FAMILY_RUNS}: {wall:.1f} s with the builds "
          f"and captures; {FAMILY_RUNS} visits in {span:.3f} s between the "
          f"first and the last row, {(FAMILY_RUNS - 1) / span:.1f} visits "
          f"a second; every point visited {min(counts.values())}-"
          f"{max(counts.values())} times; {len(beats)} JSON heartbeats, "
          f"points summing to samples; {len(arrived) // 2} rotated pairs "
          f"ingested, no row lost; launches {got} (warm-up and capture "
          "only); lat p50 us " + ", ".join(
              f"{op}/{nb} {v:.2f}" for (op, nb), v in sorted(lat.items())))


def _surface_mpi() -> None:
    """(c) the repo's C baseline (through the port's shim build) and the
    port's windowed exchange into one folder, paired by report."""
    import contextlib
    import io
    import tempfile

    from tpu_perf_torch import cli, mpi_launch, report

    cpu = _host_cpu()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-mpi-") as logs:
        t0 = time.perf_counter()
        rc = cli.main(["run", "--backend", "mpi", "-x", "-b", "65536", "-i",
                       "40", "-r", "3", "-l", logs])
        shim_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"run --backend mpi exited {rc}")
        if not (mpi_launch.BUILD_DIR / "mpi_perf_shim").exists():
            fail(f"no shim in {mpi_launch.BUILD_DIR}")
        got, _, _ = _drive(["run", "-x", "--window", "4", "--sim-ranks", "2",
                            "-b", "65536", "-i", "10", "-r", "3", "-p",
                            "1"], "run -x --window 4 --sim-ranks 2",
                           keep=logs)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["report", logs, "--format", "json"])
        if rc != 0:
            fail(f"report --format json exited {rc}")
        curve = {p["backend"]: p for p in json.loads(out.getvalue())
                 if (p["op"], p["nbytes"]) == ("exchange", 65536)}
        pairs = [c for c in report.compare(report.stream_aggregate(
            report.collect_paths(logs))) if (c.op, c.nbytes)
            == ("exchange", 65536)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["report", logs, "--compare"])
        line = [ln for ln in out.getvalue().splitlines()
                if ln.startswith("| exchange | 64K | float32 |")]
        if (set(curve) != {"mpi", "torch-sim"} or len(pairs) != 1
                or pairs[0].torch is None or pairs[0].mpi is None
                or rc != 0 or len(line) != 1 or "—" in line[0]):
            fail(f"report: exchange@65536 curves {sorted(curve)}, compare "
                 f"{pairs}, markdown {line}")
    # the cluster launch, printed and never started
    with tempfile.TemporaryDirectory(prefix="chip_smoke-hosts-") as root:
        group = os.path.join(root, "group1")
        with open(group, "w") as fh:
            fh.write("h1\n")
        out = io.StringIO()
        real_run = subprocess.run

        def no_launch(*a, **k):
            raise RuntimeError(f"a dry run launched {a}")

        subprocess.run = no_launch
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["run", "--backend", "mpi", "--hosts", "h0,h1",
                               "--dry-run", "-x", "-f", group])
        finally:
            subprocess.run = real_run
        printed = out.getvalue().splitlines()
        if rc != 0 or len(printed) != 1 or not printed[0].startswith(
                "mpirun -np 2 --host h0,h1 "):
            fail(f"--backend mpi --hosts --dry-run: rc {rc}, printed "
                 f"{printed}")
    m, t = curve["mpi"], curve["torch-sim"]
    print(f"surface: run --backend mpi -x -b 65536 -i 40 -r 3 (the shim at "
          f"-np 2, built into {mpi_launch.BUILD_DIR}, {shim_s:.1f} s): "
          f"host CPU {cpu}: lat p50 "
          f"{m['lat_us']['p50']:.3f} us, busbw p50 "
          f"{m['busbw_gbps']['p50']:.3f} GB/s")
    print(f"surface: run -x --window 4 --sim-ranks 2 -b 65536 -i 10 -r 3 "
          f"-p 1 on the card: lat p50 {t['lat_us']['p50']:.3f} us, busbw "
          f"p50 {t['busbw_gbps']['p50']:.3f} GB/s; report --compare pairs "
          f"exchange@65536 torch-sim with mpi: {line[0]}")
    print(f"surface: --backend mpi --hosts h0,h1 --dry-run printed one line "
          f"and launched nothing: {printed[0]}")


def _surface_groups_extern() -> None:
    """(d) -f / -n / -p against the sim world's ranks, and -d."""
    import contextlib
    import glob
    import io
    import tempfile

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.schema import LegacyRow

    with tempfile.TemporaryDirectory(prefix="chip_smoke-groups-") as root:
        group = os.path.join(root, "group1")
        with open(group, "w") as fh:
            fh.write("host4\nhost5\nhost6\nhost7\n")
        base = ["run", "--op", "pl_pingpong", "-f", group, "--sim-ranks",
                "8"]
        got, rows, _ = _drive(base + ["-n", "4", "-p", "1"],
                              "run -f <4 hosts> -n 4 -p 1")
        if got["pingpong"] != 2 * 10 or len(rows) != 1:
            fail(f"run -f -n 4 -p 1: launches {got}, {len(rows)} rows")
        kernels.reset_counts()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(base + ["-n", "3"])
        if rc != 2 or any(kernels.LAUNCHES.values()) or "-n 3 but" not in \
                err.getvalue():
            fail(f"run -f <4 hosts> -n 3: rc {rc}, launches "
                 f"{kernels.LAUNCHES}, {err.getvalue()}")
        logs = os.path.join(root, "extern")
        err = io.StringIO()
        kernels.reset_counts()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["run", "-d", "-r", "3", "-p", "2", "-l", logs])
        printed = [ln for ln in err.getvalue().splitlines()
                   if ln.startswith("extern-bench ")]
        legacy = []
        for path in glob.glob(os.path.join(logs, "tcp-*.log")):
            with open(path) as fh:
                legacy += [LegacyRow.from_csv(ln) for ln in fh if ln.strip()]
        if (rc != 0 or len(printed) != 3 or len(legacy) != 3
                or {r.num_flows for r in legacy} != {2}
                or any(kernels.LAUNCHES.values())
                or printed[0].split()[1] != "server"):
            fail(f"run -d: rc {rc}, printed {printed}, {len(legacy)} rows")
    print(f"surface: run --op pl_pingpong -f <4 hosts> -n 4 -p 1 "
          f"--sim-ranks 8: {got['pingpong']} launches; -n 3 exits 2 before "
          f"any kernel; run -d -r 3 -p 2: 3 rows (NumOfFlows 2) and "
          f"stderr {printed[0]!r}")


def phase_surface() -> None:
    """The rest of the reference's run surface: the windowed -x, the
    family daemon, the C baseline beside the port, -f / -n / -p and -d."""
    _surface_windows()
    _surface_family()
    _surface_mpi()
    _surface_groups_extern()


#: the compute phase: mxu_gemm's matrix side on the path (m = 4096: 64 MiB
#: in float32, 32 MiB in bfloat16)
GEMM_M = 4096
#: the product against a plain ``x @ q * a + b`` on the card:
#: |got - want| <= tol * (1 + |want|).  The path folds the multiply-add
#: into the product's epilogue and rounds once, the plain version rounds
#: after each operation, and the two products may sum in other orders:
#: a few units in the last place in float32, one in bfloat16.
GEMM_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
#: the ops whose fused graph is held within GEMM_TOL of the eager chain
GEMM_OPS = ("mxu_gemm", "overlap_ring")
#: overlap_ring's ring payloads a rank, 8 ranks
OVERLAP_BYTES = (4 * 1024**2, MAIN_BYTES)
#: the overlapped sweep: an instrument family over two sizes, on 4 lanes
STREAMS_FAMILY = ("pl_allreduce,pl_ring,pl_exchange,pl_all_gather,"
                  "pl_hbm_copy,allreduce")
STREAMS_SWEEP = "4K,16M"
STREAMS_K = 4
#: rounds of each two-lane counter race
RACE_ROUNDS = 50
#: wall-clock limit of the pingpong race's process, seconds
PINGPONG_LIMIT_S = 240
#: contend's loads and victims, 8 ranks at 4 MiB a rank
CONTEND_LOADS = ("mxu_gemm", "hbm_stream", "pl_hbm_copy")
CONTEND_VICTIMS = ("allreduce", "pl_allreduce")
#: bench's JAX one-device labels: (label prefix, peak family, dtype)
BENCH_LABELS = (("hbm_stream_busbw_p50@", "hbm", "float32"),
                ("hbm_triad_busbw_p50@", "hbm", "float32"),
                ("mxu_gemm_tflops_p50@m4096bf16[1dev]", "mxu", "bfloat16"))


def check_gemm(what: str, got, want, dtype: str) -> float:
    """A product against its plain version within GEMM_TOL."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} != "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite output")
    bad = (g - w).abs() > GEMM_TOL[dtype] * (1 + w.abs())
    err = max_abs_err(got, want)
    if bad.any():
        fail(f"{what}: {int(bad.sum())} of {g.numel()} elements off (max abs "
             f"err {err:.3e}, tol {GEMM_TOL[dtype]} * (1 + |want|))")
    return err


def _gemm_plain(x, m: int, dtype: str):
    """One mxu_gemm iteration in plain PyTorch operations: ``x @ q`` times
    1.0000001 plus 1e-7, q and the constants rounded to the dtype."""
    from tpu_perf_torch.ops.collectives import _ortho, to_tensor
    from tpu_perf_torch.ops.stream_triton import stream_constants

    q = to_tensor(_ortho(m), dtype, x.device)
    a, b = (c.to(x.device) for c in stream_constants(x.dtype))
    return (x.reshape(-1, m) @ q * a + b).view(x.shape)


def _trace_kernels(argv: list[str], what: str, per: int) -> tuple:
    """``argv`` under --profile-dir: the device work in the one kept trace
    (kernels, copies and sets), by name, and its count over ``per`` (the
    iterations measured)."""
    import glob
    import tempfile

    from tpu_perf_torch.traceparse import (
        DEVICE_CATEGORIES, device_summary, read_events,
    )

    with tempfile.TemporaryDirectory(prefix="chip_smoke-trace-") as pdir:
        _drive(argv + ["--profile-dir", pdir], what)
        traces = glob.glob(os.path.join(pdir, "*.json"))
        if len(traces) != 1:
            fail(f"{what}: traces {traces}, want one")
        s = device_summary(traces[0])
        names: dict[str, int] = {}
        for e in read_events(traces[0]):
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
                name = f"{e['cat']}:{e.get('name', '')[:50]}"
                names[name] = names.get(name, 0) + 1
    return sum(names.values()) / per, names, s


def _compute_path(dtype: str) -> None:
    """run --op mxu_gemm at m = GEMM_M on one rank through the CLI, its
    output at -i 1 against the plain product, its TFLOP/s against the
    card's peak, and its kernels an iteration from a trace."""
    import torch

    from tpu_perf_torch.chips import card_peak, card_spec
    from tpu_perf_torch.metrics import flops_per_iter_dtype
    from tpu_perf_torch.ops.collectives import DTYPES, build_op
    from tpu_perf_torch.world import SimWorld, resolve_device

    nbytes = GEMM_M * GEMM_M * DTYPES[dtype].itemsize
    what = f"run --op mxu_gemm --dtype {dtype}"
    argv = ["run", "--op", "mxu_gemm", "-b", str(nbytes), "--dtype", dtype,
            "-i", str(ITERS), "-r", str(RUNS), "--sim-ranks", "1"]
    got, rows, wall = _drive(argv + ["--fence", "trace"], what)
    if any(got.values()):
        fail(f"{what}: launched kernels {got} (a library product)")
    if len(rows) != RUNS or {(r.op, r.nbytes, r.backend, r.dtype)
                             for r in rows} != {("mxu_gemm", nbytes, "torch",
                                                 dtype)}:
        fail(f"{what}: rows {rows}")
    flops = flops_per_iter_dtype("mxu_gemm", nbytes, dtype)
    tflops = _median([flops / (r.lat_us * 1e-6) / 1e12 for r in rows])
    peak = card_peak(card_spec(torch.cuda.get_device_name(0)), "mxu", dtype)
    built = build_op("mxu_gemm", SimWorld(1, resolve_device()), nbytes, 1,
                     dtype=dtype)
    x = built.example_input
    err = check_gemm(f"{what} output at -i 1", built.step(x),
                     _gemm_plain(x, GEMM_M, dtype), dtype)
    del built, x
    per_iter, names, _ = _trace_kernels(
        argv + ["--fence", "block"], f"{what} --profile-dir", RUNS * ITERS)
    kernels = {k: c for k, c in names.items() if k.startswith("kernel:")}
    if len(kernels) != 1 or not 0 < sum(kernels.values()) <= RUNS * ITERS:
        # the wrap-add belongs in the product's epilogue: the only kernel
        # of the window is the product, one an iteration (the profiler may
        # miss the window's first few: the count is at most one), beside
        # whatever copies or sets the library issues with it
        fail(f"{what}: {per_iter:g} device ops an iteration ({names})")
    print(f"compute: {what} at m={GEMM_M} ({nbytes} B), -i {ITERS} -r "
          f"{RUNS}, trace fence: TFLOP/s p50 {tflops:.1f}, "
          f"{tflops / peak:.1%} of the card's {peak:g} ({CARD}); lat p50 "
          f"{_median([r.lat_us for r in rows]):.1f} us; output at -i 1 "
          f"max abs err {err:.3e} against x @ q * a + b (tol "
          f"{GEMM_TOL[dtype]} * (1 + |want|)); device ops an iteration "
          f"{per_iter:g}: {names} ({wall:.1f} s)")


def _compute_grid() -> None:
    """grid --spec mxu over two sizes in bfloat16 and float32, each judged
    against the card's peak for its dtype."""
    import contextlib
    import io

    from tpu_perf_torch import cli

    for dtype, sizes in (("bfloat16", "8M,32M"), ("float32", "16M,64M")):
        argv = ["grid", "--op", "mxu_gemm", "--sizes", sizes, "--iters",
                "10,20", "-r", "5", "--fence", "trace", "--spec", "mxu",
                "--dtype", dtype, "--sim-ranks", "1"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        table = out.getvalue()
        if rc != 0 or "TFLOP/s spec ceiling" not in table:
            fail(f"{' '.join(argv)} exited {rc}:\n{table}")
        print(f"compute: {' '.join(argv)}:\n{table.rstrip()}")


def _overlap_shares() -> None:
    """overlap_ring at 8 ranks beside ring and mxu_gemm at its own m: the
    share of the ring's time hidden under the product, and the fused
    graph (the side stream a parallel branch) against the eager chain."""
    import torch

    from tpu_perf_torch.ops.collectives import _overlap_split, payload_elems

    for nbytes in OVERLAP_BYTES:
        elems, _ = payload_elems("overlap_ring", nbytes, 8, 4)
        _, m = _overlap_split(elems)
        lat = {}
        for op, b in (("ring", nbytes), ("mxu_gemm", m * m * 4),
                      ("overlap_ring", nbytes)):
            # the earlier phases' cached blocks go back to the card first:
            # a 2 GiB output that fits none of them would otherwise make
            # the allocator free its cache (a synchronize) inside a timed
            # run, and a device-time pair would read it as a stall
            torch.cuda.empty_cache()
            what = f"run --op {op} -b {b} --sim-ranks 8"
            got, rows, _ = _drive(["run", "--op", op, "-b", str(b), "-i",
                                   str(ITERS), "-r", str(RUNS), "--sim-ranks",
                                   "8", "--fence", "trace"], what)
            if any(got.values()) or len(rows) != RUNS:
                fail(f"{what}: launches {got}, {len(rows)} rows")
            lat[op] = _median([r.lat_us for r in rows])
        hidden = (lat["ring"] + lat["mxu_gemm"] - lat["overlap_ring"]) \
            / lat["ring"]
        per_iter, names, s = _trace_kernels(
            ["run", "--op", "overlap_ring", "-b", str(nbytes), "-i",
             str(ITERS), "-r", str(RUNS), "--sim-ranks", "8"],
            f"overlap_ring -b {nbytes} --profile-dir", RUNS * ITERS)
        times = _check_fused_point("overlap_ring", 8, nbytes)
        print(f"compute: overlap_ring at {nbytes} B/rank, 8 ranks, m={m} "
              f"float32, trace fence: lat p50 ring {lat['ring']:.1f} us, "
              f"mxu_gemm {lat['mxu_gemm']:.1f} us, overlap_ring "
              f"{lat['overlap_ring']:.1f} us: hidden share {hidden:.3f}; "
              f"block-fenced trace: {per_iter:g} device ops an iteration "
              f"{names}, idle share {s.idle_share:.4f}; fused graph = eager "
              f"chain, {_median(times) * 1e3:.4f} ms a run")


def phase_compute() -> None:
    for dtype in ("float32", "bfloat16"):
        _compute_path(dtype)
    _compute_grid()
    _overlap_shares()


def _streams_sweep() -> None:
    """The family over two sizes serially and on STREAMS_K lanes: the same
    (op, nbytes, run) rows and the same launches, each lane row's stream
    in 1..K."""
    base = ["run", "--op", STREAMS_FAMILY, "--sweep", STREAMS_SWEEP, "-i",
            str(ITERS), "-r", str(RUNS), "--sim-ranks", "8"]
    got_s, rows_s, wall_s = _drive(base, "run (serial family)")
    got_k, rows_k, wall_k = _drive(base + ["--streams", str(STREAMS_K)],
                                   f"run --streams {STREAMS_K}")

    def coords(rows):
        return sorted((r.op, r.nbytes, r.run_id) for r in rows)

    lanes = {r.stream for r in rows_k}
    if coords(rows_s) != coords(rows_k) or not lanes <= set(
            range(1, STREAMS_K + 1)) or {r.stream for r in rows_s} != {0}:
        fail(f"run --streams {STREAMS_K}: rows {coords(rows_k)} lanes "
             f"{lanes}, serial {coords(rows_s)}")
    if got_s != got_k or not any(got_k.values()):
        fail(f"run --streams {STREAMS_K}: launches {got_k}, serial {got_s}")
    print(f"streams: run --op {STREAMS_FAMILY} --sweep {STREAMS_SWEEP} -i "
          f"{ITERS} -r {RUNS} --sim-ranks 8: {len(rows_k)} rows on lanes "
          f"{sorted(lanes)}, the serial run's (op, nbytes, run) set and "
          f"launches { {k: v for k, v in got_k.items() if v} }; wall "
          f"{wall_k:.2f} s on {STREAMS_K} streams, {wall_s:.2f} s serial")


def check_counter_race(rounds: int = RACE_ROUNDS) -> None:
    """Kernels that draw tiles from device counters, two at once on two
    lanes, ``rounds`` times: pl_ring beside pl_exchange (one row-shift
    source), two sizes of the gather, the copy beside itself, the peer
    copy and the peer reduce-scatter (scaled, one tile and n tiles) each
    beside itself, and the peer gathers' push beside their pull (the
    all-to-all), every rank's launch in turn on its lane.  Every output
    equals its plain version exactly, and each lane's counters end at
    zero."""
    import torch

    from tpu_perf_torch.ops.pallas_ring import (
        PeerParts, all_to_all_plain, direct_all_gather,
        direct_all_gather_plain, hbm_copy, hbm_copy_plain, mean_scale,
        pair_exchange, pair_exchange_plain, peer_all_gather_push,
        peer_all_to_all, peer_copy, peer_reduce_scatter,
        peer_reduce_scatter_plain, ring_shift, ring_shift_plain,
        row_copy_counters,
    )
    from tpu_perf_torch.ops.collectives import make_fill, to_tensor
    from tpu_perf_torch.streams.engine import StreamEngine

    def fill(shape):
        total = shape[0] * shape[1]
        return to_tensor(make_fill(total, "float32").reshape(shape),
                         "float32", "cuda")

    row = 4 * 1024**2  # 16 MiB a rank
    inv = mean_scale(8, torch.float32)

    def peer_reduce(x, tiles):
        # a rank's reduce-scatter over x's rows (8 ranks' chunks), its
        # table made here, outside the race; the lane passes x
        parts = PeerParts(x.unbind(0))
        return (lambda _: peer_reduce_scatter(parts, 5, scale=inv,
                                              tiles=tiles),
                lambda _: peer_reduce_scatter_plain(list(parts), 5, inv,
                                                    tiles), x)

    def peer_push(x):
        # every rank's push of its row of x into one output of n rows,
        # whose table is made here, outside the race
        n = x.shape[0]
        out = torch.empty(n, x.numel(), dtype=x.dtype, device=x.device)
        outs = PeerParts(out.unbind(0))

        def kern(_):
            for r in range(n):
                peer_all_gather_push(x[r], outs, r)
            return out

        return kern, lambda _: direct_all_gather_plain(x), x

    def peer_a2a(x):
        # every rank's pull of chunk r of each row of x
        n = x.shape[0]
        out = torch.empty_like(x)
        rows = [PeerParts(x.view(n, n, -1)[:, r].unbind(0))
                for r in range(n)]

        def kern(_):
            for r in range(n):
                peer_all_to_all(rows[r], r, out=out[r])
            return out

        return kern, lambda _: all_to_all_plain(x), x

    races = (
        ("pl_ring beside pl_exchange", "p2p_shift",
         (ring_shift, ring_shift_plain, fill((8, row))),
         (pair_exchange, pair_exchange_plain, fill((8, row)).roll(1, 1))),
        ("two sizes of pl_all_gather", "all_gather",
         (direct_all_gather, direct_all_gather_plain, fill((8, 2**21))),
         (direct_all_gather, direct_all_gather_plain, fill((8, 2**20 + 5)))),
        ("pl_hbm_copy beside itself", "hbm_copy",
         (hbm_copy, hbm_copy_plain, fill((8, row))),
         (hbm_copy, hbm_copy_plain, fill((1, 8 * row + 3)))),
        ("peer_copy beside itself", "peer_copy",
         (lambda x: peer_copy("peer_ring", x.view(-1)),
          lambda x: x.reshape(-1).clone(), fill((8, row))),
         (lambda x: peer_copy("peer_exchange", x.view(-1)),
          lambda x: x.reshape(-1).clone(), fill((1, 8 * row + 3)))),
        ("peer_reduce_scatter beside itself", "peer_reduce",
         peer_reduce(fill((8, row)), 1),
         peer_reduce(fill((8, row // 2 + 4)), 8)),
        ("the peer gathers' push beside their pull", "peer_gather",
         peer_push(fill((8, 2**18 + 3))),
         peer_a2a(fill((8, 8 * (2**17 + 1))))),
    )
    said = []
    for name, source, *sides in races:
        wants = [plain(x) for _, plain, x in sides]
        engine = StreamEngine(2)
        t0 = time.perf_counter()
        for i in range(rounds):
            outs = [engine.dispatch(lane, kern, x)
                    for lane, (kern, _, x) in enumerate(sides)]
            engine.fence_all()
            for lane, (out, want) in enumerate(zip(outs, wants)):
                check_exact(f"counter race {name}, round {i}, lane {lane}",
                            out, want)
        wall = time.perf_counter() - t0
        for lane in range(2):
            with torch.cuda.stream(engine._lanes[lane]):
                counters = row_copy_counters(source, sides[0][2].device)
                if counters.any():
                    fail(f"counter race {name}: lane {lane}'s counters "
                         f"{counters.tolist()}")
        said.append(f"{name} {wall * 1e3 / rounds:.3f} ms a round")
    print(f"streams: counter race, {rounds} rounds each on two lanes, every "
          f"output equal to its plain version, each lane's counters zero: "
          f"{'; '.join(said)}")


def race_pingpong(rounds: int = RACE_ROUNDS) -> None:
    """pl_pingpong (pair counters, a spin-wait) on lane 0 beside a
    pl_hbm_copy load on lane 1, ``rounds`` times; run by phase_streams in
    a process of its own under a wall-clock limit."""
    import torch

    from tpu_perf_torch.ops.collectives import make_fill, to_tensor
    from tpu_perf_torch.ops.pallas_ring import (
        hbm_copy, pingpong, pingpong_counters,
    )
    from tpu_perf_torch.streams.engine import StreamEngine

    x = to_tensor(make_fill(8 * 114033, "float32").reshape(8, -1), "float32",
                  "cuda")
    big = torch.arange(64 * 1024**2, dtype=torch.float32,
                       device="cuda").view(1, -1)
    engine = StreamEngine(2)
    t0 = time.perf_counter()
    for i in range(rounds):
        copied = engine.dispatch(1, hbm_copy, big)
        back = engine.dispatch(0, lambda y: pingpong(y)[0], x)
        engine.fence_all()
        check_exact(f"pingpong race round {i}", back, x)
        check_exact(f"pingpong race load round {i}", copied, big)
    wall = time.perf_counter() - t0
    with torch.cuda.stream(engine._lanes[0]):
        counters = pingpong_counters(x.device, 4)
        if counters.any():
            fail(f"pingpong race: pair counters {counters.tolist()}")
    print(f"pingpong race: {rounds} round trips at (8, 114033) beside a "
          f"256 MiB pl_hbm_copy on the other lane returned their input, "
          f"pair counters zero, {wall * 1e3 / rounds:.3f} ms a round")


def _contend() -> None:
    """contend on allreduce and pl_allreduce at 8 ranks under each load,
    then report's interference matrix over their rows."""
    import contextlib
    import io
    import tempfile

    from tpu_perf_torch import cli

    with tempfile.TemporaryDirectory(prefix="chip_smoke-contend-") as keep:
        said = []
        for victim in CONTEND_VICTIMS:
            for load in CONTEND_LOADS:
                what = f"contend --op {victim} --load {load}"
                got, rows, wall = _drive(
                    ["contend", "--op", victim, "--load", load, "-b",
                     str(HEADLINE_BYTES), "-i", str(ITERS), "-r", "10",
                     "--sim-ranks", "8"], what, keep=keep)
                idle = [r for r in rows if not r.load]
                loaded = [r for r in rows if r.load]
                needs = set(PATHS.get(victim, ({}, 0))[0])
                needs |= set(PATHS.get(load, ({}, 0))[0])
                if (len(idle) != 10 or len(loaded) != 10
                        or {r.stream for r in idle} != {0}
                        or {(r.load, r.stream) for r in loaded} != {(load, 1)}
                        or {k for k, v in got.items() if v} != needs):
                    fail(f"{what}: {len(idle)} idle and {len(loaded)} loaded "
                         f"rows, launches {got}")
                slow = (_median([r.lat_us for r in loaded])
                        / _median([r.lat_us for r in idle]))
                said.append(f"{victim} under {load} x{slow:.3f}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["report", keep])
        text = out.getvalue()
        matrix = text.split("### Interference matrix", 1)[-1]
        cells = [ln for ln in matrix.splitlines() if ln.startswith("| ")
                 and not ln.startswith("| op ")]
        if rc != 0 or "### Interference matrix" not in text or len(cells) != \
                len(CONTEND_VICTIMS) * len(CONTEND_LOADS):
            fail(f"report over contend's rows: rc {rc}, matrix {cells}")
    print(f"streams: contend at {HEADLINE_BYTES} B/rank, 8 ranks, -i {ITERS} "
          f"-r 10, block fence, loaded p50 over idle p50: {', '.join(said)}; "
          f"report's interference matrix:\n" + "\n".join(cells))


def _release_cache(what: str) -> None:
    """Give this process' cached blocks back to the card before a child
    process needs the card's memory, and say what stays."""
    import torch

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{what}: this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB in tensors; the card has {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB free")


def phase_streams() -> None:
    _streams_sweep()
    check_counter_race()
    here = os.path.dirname(os.path.abspath(__file__))
    _release_cache("streams: before the pingpong race's process")
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.race_pingpong()"], cwd=here, capture_output=True,
            text=True, timeout=PINGPONG_LIMIT_S)
    except subprocess.TimeoutExpired:
        fail(f"pingpong race: no end within {PINGPONG_LIMIT_S} s (deadlock)")
    if out.returncode != 0:
        fail(f"pingpong race exited {out.returncode}:\n{out.stderr[-4000:]}")
    print(f"streams: {out.stdout.strip()}")
    _contend()


def phase_bench() -> None:
    """``bench`` once through the CLI: its JSON line, the JAX one-device
    labels, and each ratio against the detected card's entry."""
    import contextlib
    import io

    import torch

    from tpu_perf_torch import cli
    from tpu_perf_torch.chips import card_peak, card_spec

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["bench"])
    wall = time.perf_counter() - t0
    line = out.getvalue().strip().splitlines()[-1]
    print(line)
    payload = json.loads(line)
    spec = card_spec(torch.cuda.get_device_name(0))
    inst = payload["metrics"][:len(BENCH_LABELS)]
    if rc != 0 or payload["metric"] != inst[0]["metric"]:
        fail(f"bench: rc {rc}, headline {payload['metric']}")
    for m, (label, family, dtype) in zip(inst, BENCH_LABELS):
        want = m["value"] / card_peak(spec, family, dtype)
        if (not m["metric"].startswith(label) or m["vs_peak"] is None
                or abs(m["vs_peak"] - want) > 1e-3 * want):
            fail(f"bench: {m} against {label} and the {spec.kind} "
                 f"{family} peak")
    d, c = payload["dispatch_overhead"], payload["contention"]
    if len(d["points"]) != 3 or not c["slowdown"] > 0:
        fail(f"bench: dispatch_overhead {d}, contention {c}")
    print(f"bench: {len(payload['metrics'])} metrics in {wall:.1f} s; "
          + "; ".join(f"{m['metric']} {m['value']} {m['unit']} "
                      f"({m['vs_peak']:.1%} of the {spec.kind} peak)"
                      for m in inst)
          + "; dispatch_overhead host/overlapped/fused us "
          + ", ".join(f"{p['nbytes']} B {p['host_us']:.2f}/"
                      f"{p['overlapped_us']:.2f}/{p['fused_us']:.2f}"
                      for p in d["points"])
          + f"; contention slowdown {c['slowdown']:.3f} ({CARD})")


# --- adaptive runs, the compile pipeline, contend along axes ---------------

#: the adaptive stop rule of the adaptive phase: a point stops once its 95%
#: interval is within 5%, after 5 runs and by 50 at most
ADAPTIVE = ("--ci-rel", "0.05", "--min-runs", "5", "--max-runs", "50")
MIN_RUNS, MAX_RUNS, CI_REL = 5, 50, 0.05
#: the pipeline runs' sweep, each in a process of its own
PIPE_SWEEP = "4K:16M"
#: contend along the axes of the sim mesh: the victim's bytes a rank, runs
MESH_CONTEND_BYTES, MESH_CONTEND_RUNS = 16 * 1024**2, 10


def _logged_run(argv: list[str], what: str, logdir: str):
    """One ``cli.main`` run into ``logdir`` with the counters set to 0 just
    before it and read just after; returns (launches, rows, the phase
    sidecar, wall s)."""
    import glob

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.schema import ResultRow

    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["-l", logdir])
    wall = time.perf_counter() - t0
    got, plain = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
    if rc != 0:
        fail(f"{what} exited {rc}")
    if any(plain.values()):
        fail(f"{what}: plain versions called {plain}")
    rows = []
    for path in sorted(glob.glob(os.path.join(logdir, "tpu-*.log"))):
        with open(path) as fh:
            rows += [ResultRow.from_csv(ln) for ln in fh if ln.strip()]
    sides = glob.glob(os.path.join(logdir, "phase-*.json"))
    if len(sides) != 1:
        fail(f"{what}: phase sidecars {sides}")
    with open(sides[0]) as fh:
        side = json.load(fh)
    return got, rows, side, wall


def _phase_line(side: dict) -> str:
    ph = side["phase"]
    return (f"wall {side['wall_s']:.3f} s: compile {ph['compile_s']:.3f}, "
            f"measure {ph['measure_s']:.3f}, log {ph['log_s']:.3f} s")


def phase_adaptive() -> None:
    """``run --op pl_allreduce --sweep 4K:256M --ci-rel 0.05 --min-runs 5
    --max-runs 50`` at 8 sim ranks under block and fused: every point's
    runs within the bounds, its interval within 5% wherever it stopped
    early, the launches those runs' (block: the warm-up and each run;
    fused: the eager chunk and the capture), the savings and the phase
    split from the sidecar; then pl_allreduce's output at 4 KiB and
    16 MiB a rank against its plain versions on the same input."""
    import tempfile

    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.world import SimWorld

    for fence in ("block", "fused"):
        what = f"run --fence {fence} --ci-rel 0.05"
        with tempfile.TemporaryDirectory(prefix="chip_smoke-adaptive-") as d:
            got, rows, side, wall = _logged_run(
                ["run", "--op", "pl_allreduce", "--sim-ranks", "8",
                 "--sweep", SWEEP, "-i", str(ITERS), "--fence", fence,
                 *ADAPTIVE], what, d)
        points = {}
        for r in rows:
            points.setdefault(r.nbytes, []).append(r)
        early = []
        for nb, pts in points.items():
            last = max(pts, key=lambda r: r.run_id)
            if (not MIN_RUNS <= last.runs_taken <= MAX_RUNS
                    or {r.runs_requested for r in pts} != {MAX_RUNS}):
                fail(f"{what} at {nb} B: runs_taken {last.runs_taken}, "
                     f"requested {sorted({r.runs_requested for r in pts})}")
            if last.run_id < MAX_RUNS:
                early.append(last.run_id)
                if not 0 < last.ci_rel <= CI_REL:
                    fail(f"{what} at {nb} B: stopped after {last.run_id} "
                         f"runs at ci_rel {last.ci_rel}")
        taken = sum(max(r.run_id for r in pts) for pts in points.values())
        # block: one warm-up run and each measured run; fused: the eager
        # first chunk and the capture of the one chunk size (5 runs each)
        per_point = {"block": None, "fused": 2 * MIN_RUNS * ITERS}[fence]
        want = ((len(points) + taken) * ITERS if per_point is None
                else len(points) * per_point)
        launched = {k: v for k, v in got.items() if v}
        if launched != {"direct_reduce_scatter": want,
                        "direct_all_gather": want}:
            fail(f"{what}: launches {launched}, want {want} of each")
        a = side["adaptive"]
        if (a["points"] != len(points) or a["runs_requested"] !=
                len(points) * MAX_RUNS or a["runs_attempted"] != taken):
            fail(f"{what}: the sidecar's adaptive totals {a}")
        print(f"adaptive: pl_allreduce --sweep {SWEEP} at 8 ranks, -i "
              f"{ITERS}, --fence {fence}, --ci-rel {CI_REL} --min-runs "
              f"{MIN_RUNS} --max-runs {MAX_RUNS}: {len(points)} points, "
              f"{taken} runs of {a['runs_requested']} ({a['runs_saved']} "
              f"saved, {len(early)} points stopped early), wall saved "
              f"{a['wall_saved_s']:.4f} s; {_phase_line(side)} "
              f"(the run {wall:.1f} s); launches {want} of each kernel "
              f"({CARD})")
    dev = torch.device("cuda", torch.cuda.current_device())
    errs = []
    for nbytes in (4096, 16 * 1024**2):
        card = build_op("pl_allreduce", SimWorld(8, dev), nbytes, ITERS)
        plain = build_op("pl_allreduce", SimWorld(8, torch.device("cpu")),
                         nbytes, ITERS)
        check_exact(f"the adaptive path's input at {nbytes} B",
                    card.example_input.cpu(), plain.example_input)
        errs.append(check_close(
            f"pl_allreduce at {nbytes} B/rank against its plain versions",
            card.step(card.example_input).cpu(),
            plain.step(plain.example_input), "float32"))
    print(f"adaptive: pl_allreduce at 4 KiB and 16 MiB a rank, -i {ITERS}: "
          f"the kernels against their plain versions on the same input, "
          f"max abs err {max(errs):.3e}")


_PIPE_CHILD = ("import json, sys; from tpu_perf_torch import cli, kernels; "
               "from tpu_perf_torch.kernels import _build; "
               "rc = cli.main(sys.argv[1:]); print('PIPE ' + json.dumps("
               "{'rc': rc, 'launches': kernels.LAUNCHES, "
               "'builds': _build.BUILDS}))")


def phase_pipeline() -> None:
    """The compile pipeline against the serial run, each in a process of
    its own over PIPE_SWEEP (pl_allreduce, 8 sim ranks, block): serial
    into a fresh ``--compile-cache`` A, ``--precompile 2`` into a fresh B
    (the worker builds the kernels), ``--precompile auto`` into A again (a
    second process on one cache builds no kernel).  The rows' (op, nbytes,
    iters, run_id) and the launches must be the serial run's; each run's
    phase split is printed beside its wall."""
    import tempfile

    from tpu_perf_torch.schema import ResultRow

    here = os.path.dirname(os.path.abspath(__file__))
    _release_cache("pipeline: before its processes")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-pipe-") as root:
        for label, flags, cache in (("serial", [], "a"),
                                    ("precompile 2", ["--precompile", "2"],
                                     "b"),
                                    ("precompile auto",
                                     ["--precompile", "auto"], "a")):
            logs = os.path.join(root, label.replace(" ", "-"))
            argv = ["run", "--op", "pl_allreduce", "--sim-ranks", "8",
                    "--sweep", PIPE_SWEEP, "-i", str(ITERS), "-r", str(RUNS),
                    "--compile-cache", os.path.join(root, cache), "-l", logs,
                    *flags]
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", _PIPE_CHILD, *argv],
                                 cwd=here, capture_output=True, text=True,
                                 timeout=300)
            proc_s = time.perf_counter() - t0
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("PIPE ")]
            if out.returncode != 0 or len(lines) != 1:
                fail(f"pipeline: {label} exited {out.returncode}:\n"
                     f"{out.stderr[-3000:]}")
            res = json.loads(lines[0][5:])
            rows, side = [], None
            for name in sorted(os.listdir(logs)):
                with open(os.path.join(logs, name)) as fh:
                    if name.startswith("tpu-"):
                        rows += [ResultRow.from_csv(ln) for ln in fh
                                 if ln.strip()]
                    elif name.startswith("phase-"):
                        side = json.load(fh)
            if res["rc"] != 0 or side is None:
                fail(f"pipeline: {label}: rc {res['rc']}, sidecar {side}")
            runs[label] = (res, rows, side, proc_s)
    coords = {k: [(r.op, r.nbytes, r.iters, r.run_id) for r in v[1]]
              for k, v in runs.items()}
    launches = {k: {n: c for n, c in v[0]["launches"].items() if c}
                for k, v in runs.items()}
    builds = {k: v[0]["builds"] for k, v in runs.items()}
    if (len({json.dumps(c) for c in coords.values()}) != 1
            or len({json.dumps(x, sort_keys=True)
                    for x in launches.values()}) != 1):
        fail(f"pipeline: rows or launches differ from the serial run's: "
             f"{ {k: len(c) for k, c in coords.items()} }, {launches}")
    if (builds["serial"] < 1 or builds["precompile 2"] != builds["serial"]
            or builds["precompile auto"] != 0):
        fail(f"pipeline: kernel builds {builds}: the second process on a "
             "compile cache must build none")
    said = []
    for label, (res, rows, side, proc_s) in runs.items():
        ph = side["phase"]
        hidden = max(0.0, ph["compile_s"] + ph["measure_s"] + ph["log_s"]
                     - side["wall_s"])
        said.append(f"{label}: {_phase_line(side)}, compile hidden "
                    f"{hidden:.3f} s ({hidden / max(ph['compile_s'], 1e-9):.1%}"
                    f" of it), {builds[label]} nvcc builds"
                    + (f", depth {side['precompile_depth']}"
                       if "precompile_depth" in side else "")
                    + f" (process {proc_s:.1f} s)")
    print(f"pipeline: pl_allreduce --sweep {PIPE_SWEEP} at 8 ranks, -i "
          f"{ITERS} -r {RUNS}, each a process of its own: "
          + "; ".join(said) + f"; rows and launches "
          f"{launches['serial']} the serial run's ({CARD})")


def phase_contend_axes() -> None:
    """contend on a 2 x 4 sim mesh (dcn, ici): allreduce at
    MESH_CONTEND_BYTES a rank along each axis, loaded by allreduce along
    the other axis and along its own, and by hbm_stream; each row's
    columns, and the slowdowns."""
    import tempfile

    from tpu_perf_torch import cli, kernels
    from tpu_perf_torch.report import aggregate, interference_matrix
    from tpu_perf_torch.schema import ResultRow

    said = []
    for victim, load, load_axis in (("ici", "allreduce", "dcn"),
                                    ("ici", "allreduce", "ici"),
                                    ("dcn", "allreduce", "ici"),
                                    ("dcn", "allreduce", "dcn"),
                                    ("ici", "hbm_stream", None)):
        what = (f"contend --mesh 2x4 --victim-axis {victim} --load {load}"
                + (f" --load-axis {load_axis}" if load_axis else ""))
        with tempfile.TemporaryDirectory(prefix="chip_smoke-axes-") as d:
            kernels.reset_counts()
            argv = ["contend", "--mesh", "2x4", "--axes", "dcn,ici", "--op",
                    "allreduce", "--load", load, "--victim-axis", victim,
                    "-b", str(MESH_CONTEND_BYTES), "-i", str(ITERS), "-r",
                    str(MESH_CONTEND_RUNS), "-l", d]
            if load_axis:
                argv += ["--load-axis", load_axis]
            rc = cli.main(argv)
            rows = []
            for name in os.listdir(d):
                with open(os.path.join(d, name)) as fh:
                    rows += [ResultRow.from_csv(ln) for ln in fh
                             if ln.strip()]
        idle = [r for r in rows if not r.load]
        loaded = [r for r in rows if r.load]
        if (rc != 0 or len(idle) != MESH_CONTEND_RUNS
                or len(loaded) != MESH_CONTEND_RUNS
                or {(r.load, r.stream) for r in loaded} != {(load, 1)}
                or {r.n_devices for r in rows} != {8}
                or any(kernels.PLAIN_CALLS.values())):
            fail(f"{what}: rc {rc}, {len(idle)} idle and {len(loaded)} "
                 f"loaded rows")
        [cell] = interference_matrix(aggregate(rows))
        said.append(f"victim along {victim} under {load}"
                    + (f" along {load_axis}" if load_axis else "")
                    + f": idle {cell.idle.lat_us['p50']:.1f} us, loaded "
                    f"{cell.loaded.lat_us['p50']:.1f} us, x"
                    f"{cell.slowdown:.3f}")
    print(f"contend: allreduce at {MESH_CONTEND_BYTES} B/rank on a 2 x 4 sim "
          f"mesh (dcn, ici), -i {ITERS} -r {MESH_CONTEND_RUNS}, p50 lat: "
          + "; ".join(said) + f" ({CARD})")


# --- the multi-rank world ---------------------------------------------------

#: the NCCL world of one's library ops: no kernel of the port
DIST_OPS = ("allreduce,all_gather,reduce_scatter,all_to_all,broadcast,"
            "broadcast_psum,barrier,ring")
DIST_SWEEP = "4K:16M"
#: op -> {kernel: (launches an execution, launches a step besides)} of
#: each pl_* path on a rank of a multi-rank world (the pingpong's copies
#: are group 0's, leg 1 pushed and the last leg 2 pulled: group 1 copies
#: its own and pushes leg 2 but the last, see peer_launches)
PEER_PATHS = {
    "pl_allreduce": {"peer_reduce_scatter": (1, 0), "peer_all_gather": (1, 0),
                     "peer_barrier": (2, 1)},
    "pl_reduce_scatter": {"peer_reduce_scatter": (1, 0),
                          "peer_barrier": (1, 1)},
    "pl_ring": {"peer_ring": (1, 0), "peer_barrier": (1, 1)},
    "pl_exchange": {"peer_exchange": (1, 0), "peer_barrier": (1, 1)},
    "pl_pingpong": {"peer_pingpong": (1, 1), "peer_barrier": (2, 1)},
    "pl_barrier": {"peer_barrier_copy": (1, 0)},
    "pl_all_to_all": {"peer_all_to_all": (1, 0), "peer_barrier": (1, 1)},
    "pl_all_gather": {"peer_all_gather": (1, 0), "peer_barrier": (1, 1)},
    "pl_all_gather_bidir": {"peer_all_gather_bidir": (1, 0),
                            "peer_barrier": (1, 1)},
    "pl_hbm_stream": {"stream": (1, 0)},
    "pl_hbm_copy": {"hbm_copy": (1, 0)},
    "pl_hbm_read": {"hbm_read": (1, 0)},
    "pl_hbm_write": {"hbm_write": (1, 0)},
}
#: the pl_* ops of a world of one: those the JAX package runs on one
#: device, and pl_allreduce, whose peer form runs at any size
ONE_RANK_OPS = ("pl_allreduce", "pl_ring", "pl_all_to_all", "pl_all_gather",
                "pl_all_gather_bidir", "pl_hbm_stream", "pl_hbm_copy",
                "pl_hbm_read", "pl_hbm_write")
#: the launch counters of csrc/peer_collectives.cu
PEER_KERNELS = ("peer_reduce_scatter", "peer_all_gather", "peer_barrier",
                "peer_ring", "peer_exchange", "peer_pingpong",
                "peer_all_to_all", "peer_all_gather_bidir",
                "peer_barrier_copy")
#: the ops that read a peer's memory: the loopback runs their real steps
PEER_OPS = ("pl_allreduce", "pl_reduce_scatter", "pl_ring", "pl_exchange",
            "pl_pingpong", "pl_barrier", "pl_all_to_all", "pl_all_gather",
            "pl_all_gather_bidir")
#: the loopback's wall-clock limit: a rank waiting on a peer's signal that
#: never comes fails the smoke, never hangs it
LOOPBACK_LIMIT_S = 400
LOOPBACK_RANKS = (2, 4, 8)
LOOPBACK_CHAIN, LOOPBACK_REPLAYS = 50, 20
#: the per-rank sizes of the loopback's step cases (one not 16-byte
#: divisible) and their chains: eager steps, then graph replays
STEP_BYTES = (4108, (1 << 20) + 16)
STEP_CHAIN, STEP_REPLAYS = 6, 6
#: the IPC worlds: their sizes, the per-rank sizes and steps of each op,
#: and each world's wall-clock limit
IPC_RANKS = (2, 4)
IPC_BYTES = (4108, 16 * 1024**2)
IPC_STEPS = 2
IPC_LIMIT_S = 240
HIER_BYTES = 4 * 1024**2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def peer_launches(op: str, n: int, rank: int, steps: int) -> dict:
    """A rank's launches over ``steps`` steps of ``op`` at ITERS
    executions each, by kernel: PEER_PATHS, group 1 of the pingpong with
    its local copy besides its leg and no leg at the last execution."""
    want = {}
    for name, (per_exec, per_step) in PEER_PATHS[op].items():
        if op == "pl_pingpong" and name == "peer_pingpong" and rank >= n // 2:
            per_exec, per_step = 2, -1
        want[name] = steps * (per_exec * ITERS + per_step)
    return want


def _dist_world_of_one() -> dict:
    """(a) ``run --distributed`` in an NCCL world of one, in this process
    through ``cli.main``: the library ops' rows (backend torch, no kernel
    of the port), the command joining the world and leaving it when it
    ends; then, in a world this process joins first (NCCL its backend),
    which each command leaves alone, each pl_* op of ONE_RANK_OPS over
    DIST_SWEEP under the block fence and at FUSED_BYTES under the fused
    one, each run's launches (counted from 0 just before it, read just
    after) its path's and no plain call; then each op's output against
    its plain chain (:func:`_check_world_of_one`).  Returns the launches
    by kernel, summed over the pl_* runs."""
    import torch.distributed as dist

    from tpu_perf_torch.config import Options
    from tpu_perf_torch.parallel import initialize_distributed
    from tpu_perf_torch.runner import sizes_for

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    argv = ["run", "--distributed", "--op", DIST_OPS, "--sweep", DIST_SWEEP,
            "-i", str(ITERS), "-r", str(RUNS)]
    what = " ".join(argv)
    launched, said = {}, []
    try:
        got, rows, wall = _drive(argv, what)
        if dist.is_initialized():
            fail(f"{what}: the command left its process group behind")
        if any(got.values()):
            fail(f"{what}: launches {got}, want none")
        os.environ["MASTER_PORT"] = str(_free_port())
        initialize_distributed(device="cuda")
        backend = dist.get_backend()
        for op in ONE_RANK_OPS:
            sizes = sizes_for(Options(sweep=DIST_SWEEP, op=op))
            for fence, points, steps in (
                    ("block", sizes, len(sizes) * (1 + RUNS)),
                    # launches are the warm-up's and the capture's only
                    ("fused", FUSED_BYTES, len(FUSED_BYTES) * 2 * RUNS)):
                op_argv = ["run", "--distributed", "--op", op, "--sweep",
                           ",".join(str(b) for b in points), "-i", str(ITERS),
                           "-r", str(RUNS), "--fence", fence]
                op_what = " ".join(op_argv)
                op_got, op_rows, op_wall = _drive(op_argv, op_what)
                want = peer_launches(op, 1, 0, steps)
                if {k: v for k, v in op_got.items() if v} != want:
                    fail(f"{op_what}: launches {op_got}, want {want} and "
                         "nothing else")
                if len(op_rows) != len(points) * RUNS or any(
                        r.backend != "torch" or r.n_devices != 1
                        or r.lat_us <= 0 for r in op_rows):
                    fail(f"{op_what}: {len(op_rows)} rows or a bad row")
                for k, v in want.items():
                    launched[k] = launched.get(k, 0) + v
                big = max(op_rows, key=lambda r: r.nbytes)
                lo = min(r.nbytes for r in op_rows)
                said.append(f"{op} {fence} {len(op_rows)} rows in "
                            f"{op_wall:.1f} s ({big.nbytes} B "
                            f"{big.busbw_gbps:.1f} GB/s; lat_us at {lo} B "
                            + "/".join(f"{r.lat_us:.2f}" for r in op_rows
                                       if r.nbytes == lo) + ")")
        checked = _check_world_of_one()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"distributed: dist.get_backend() = {backend}")
    if backend != "nccl":
        fail(f"{what}: backend {backend}, want nccl")
    want_rows = sum(len(sizes_for(Options(sweep=DIST_SWEEP, op=op))) * RUNS
                    for op in DIST_OPS.split(","))
    if len(rows) != want_rows or any(
            r.backend != "torch" or r.n_devices != 1 or r.lat_us <= 0
            for r in rows):
        fail(f"{what}: {len(rows)} rows (want {want_rows}) or a bad row")
    print(f"distributed: {what}: {len(rows)} rows (backend torch, 1 rank) "
          f"in {wall:.1f} s, no kernel of the port; the command left its "
          "NCCL group (barrier, destroy_process_group)")
    print("distributed: the pl_* ops of a world of one, each run's launches "
          f"its path's, plain calls 0: {'; '.join(said)} ({CARD})")
    print(f"distributed: {checked}")
    return launched


def _plain_chain_of_one(op: str, x, nbytes: int):
    """``op``'s plain versions' chain of ITERS executions at n = 1 on x:
    what a world of one's step must give."""
    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.stream_triton import stream_plain

    y = x
    for _ in range(ITERS):
        if op == "pl_allreduce":
            y = pr.peer_all_gather_plain([pr.peer_reduce_scatter_plain(
                [y], 0, pr.mean_scale(1, y.dtype))])
        elif op == "pl_ring":
            y = pr.peer_copy_plain("peer_ring", y)
        elif op == "pl_all_to_all":
            y = pr.peer_all_to_all_plain([y])
        elif op == "pl_all_gather":
            y = pr.peer_all_gather_plain([y])
        elif op == "pl_all_gather_bidir":
            y = pr.peer_all_gather_bidir_plain([y], 0)
        elif op == "pl_hbm_stream":
            y = stream_plain(y)
        elif op == "pl_hbm_copy":
            y = pr.hbm_copy_plain(y)
        elif op == "pl_hbm_read":
            y = pr.hbm_read_plain(y)
        else:
            block = pr.hbm_dma_block_elems(y.element_size(), y.numel())
            y = pr.hbm_write_plain(y.view(1, -1), block).view(-1)
    return y


def _check_world_of_one() -> str:
    """Each op of ONE_RANK_OPS in the NCCL world of one, built as the run
    builds it at the sweep's smallest and largest size: a step run
    eagerly, then captured into a CUDA graph on the same stream and
    replayed twice, each output its plain versions' chain on the same
    input (bit for bit; the stream within its tolerance)."""
    import torch

    from tpu_perf_torch.config import Options
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.runner import sizes_for, world_for

    world = world_for(Options(distributed=True, sim_ranks=1))
    for op in ONE_RANK_OPS:
        sizes = sizes_for(Options(sweep=DIST_SWEEP, op=op))
        for nbytes in (min(sizes), max(sizes)):
            built = build_op(op, world, nbytes, ITERS)
            x = built.example_input
            want = _plain_chain_of_one(op, x.clone(), nbytes)
            what = f"world of one: {op} at {nbytes} B"

            def check(label, got):
                if op == "pl_hbm_stream":
                    check_close(f"{what}, {label}", got, want, "float32")
                else:
                    check_exact(f"{what}, {label}", got, want)

            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                eager = built.step(x)
            torch.cuda.synchronize()
            check("an eager step", eager)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                got = built.step(x)
            for replay in range(2):
                graph.replay()
                torch.cuda.synchronize()
                check(f"graph replay {replay}", got)
            del graph, built
    return (f"{', '.join(ONE_RANK_OPS)} at the sweep's ends, an eager step "
            "and two graph replays each: their plain versions' chain")


def _hier_on_the_sim_world() -> None:
    """(b) hier_allreduce on a 2 x 4 (dcn, ici) mesh of the sim world, its
    output against its selftest model."""
    import torch

    from tpu_perf_torch.parallel import make_mesh
    from tpu_perf_torch.selftest import format_results, run_selftest
    from tpu_perf_torch.world import SimWorld

    argv = ["run", "--op", "hier_allreduce", "--mesh", "2x4", "--axes",
            "dcn,ici", "--sim-ranks", "8", "-b", str(HIER_BYTES), "-i",
            str(ITERS), "-r", str(RUNS)]
    got, rows, wall = _drive(argv, " ".join(argv))
    if any(got.values()) or len(rows) != RUNS or any(
            r.op != "hier_allreduce" or r.n_devices != 8 for r in rows):
        fail(f"hier_allreduce: launches {got}, rows {rows}")
    world = SimWorld(8, torch.device("cuda", torch.cuda.current_device()),
                     make_mesh((2, 4), ("dcn", "ici"), n=8))
    results = run_selftest(world, ops=["hier_allreduce"], nbytes=HIER_BYTES,
                           iters=ITERS)
    if any(r.status != "ok" for r in results):
        fail(f"hier_allreduce output:\n{format_results(results)}")
    print(f"distributed: {' '.join(argv)}: {len(rows)} rows in {wall:.1f} s, "
          f"busbw {max(r.busbw_gbps for r in rows):.1f} GB/s; output "
          f"{results[0].detail} against the selftest model")


def phase_distributed() -> tuple[dict, list[dict]]:
    """The multi-rank world: (a) an NCCL world of one through the CLI, (b)
    hier_allreduce in the sim world, (c) every pl_* op across two and
    four processes on the card through CUDA IPC, (d) the peer kernels'
    loopback in a process of its own; (c) and (d) under wall-clock
    limits.  Returns the peer
    kernels' launches on the main path (the world of one's runs and the
    IPC worlds' steps) and their kernels-line entries."""
    launched = _dist_world_of_one()
    _hier_on_the_sim_world()
    _release_cache("distributed: before the IPC worlds' processes")
    for k, v in _ipc_worlds().items():
        launched[k] = launched.get(k, 0) + v
    here = os.path.dirname(os.path.abspath(__file__))
    # one hardware queue a stream, so no rank's launch queues behind
    # another rank's waiting barrier; every kernel loaded up front, since
    # loading one at its first launch waits for the card, where a rank's
    # barrier waits for a rank this thread has not yet enqueued
    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS="32",
               CUDA_MODULE_LOADING="EAGER")
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.loopback()"],
            cwd=here, env=env, capture_output=True, text=True,
            timeout=LOOPBACK_LIMIT_S)
    except subprocess.TimeoutExpired:
        fail(f"loopback: no end within {LOOPBACK_LIMIT_S} s (a rank waits "
             "on a signal that never comes)")
    if out.returncode != 0:
        fail(f"loopback exited {out.returncode}:\n{out.stdout[-3000:]}\n"
             f"{out.stderr[-4000:]}")
    entries = None
    for line in out.stdout.splitlines():
        if line.startswith("LOOPBACK_KERNELS "):
            entries = json.loads(line.split(" ", 1)[1])
        else:
            print(f"loopback: {line}")
    if entries is None:
        fail("loopback: no kernels line")
    missing = [k for k in PEER_KERNELS if not launched.get(k)]
    if missing:
        fail(f"the main path launched no {missing}")
    # launches an execution on the path each row's kernel first serves
    per_exec = {"peer_reduce_scatter": 1, "peer_all_gather": 1,
                "peer_barrier": 2 + 1 / ITERS, "peer_ring": 1,
                "peer_exchange": 1, "peer_pingpong": 1.5,
                "peer_all_to_all": 1, "peer_all_gather_bidir": 1,
                "peer_barrier_copy": 1}
    for k in entries:
        k["launches"] = launched[k["name"]]
        k["launches_per_execution"] = per_exec[k["name"]]
    return launched, entries


def ipc_world(n: int, rank: int, port: int, cards: int = 1) -> None:
    """(c) one of n processes on one card (or, with ``cards``, rank r on
    card r % cards, so that pushes and signals cross NVLink), each a rank
    of a world of n
    whose pl_* ops read the others' buffers through CUDA IPC
    (``PeerBuffers``: ``peer_alloc``, ``peer_ipc_handle``,
    ``peer_ipc_open``) and meet them on signal pads across the processes.
    NCCL refuses two ranks on one card, so the handles cross over a gloo
    group; the data path is the peer kernels alone.  Every pl_* op at
    IPC_BYTES, IPC_STEPS steps each, each output bit for bit its row of
    the sim kernels' chain and the op's launches its path's, no plain
    call; prints the launches as IPC_LAUNCHES json.  Run by
    phase_distributed under a wall-clock limit."""
    import torch
    import torch.distributed as dist

    from tpu_perf_torch import kernels
    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import build_op, example_input
    from tpu_perf_torch.parallel import make_mesh
    from tpu_perf_torch.world import DistWorld, SimWorld

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    torch.cuda.set_device(rank % cards)
    dev = torch.device("cuda", torch.cuda.current_device())
    world = DistWorld(rank=rank, n=n, local_rank=0, device=dev,
                      mesh=make_mesh(n=n))
    sim = SimWorld(n, dev)
    totals = {}
    for op in pr.PALLAS_OPS:
        wants = {}
        for nbytes in IPC_BYTES:
            step, elems, _ = pr.build_pallas_step(op, sim, nbytes, ITERS)
            wants[nbytes] = step(example_input(sim, elems, "float32"))[rank]
        torch.cuda.synchronize()
        kernels.reset_counts()
        for nbytes in IPC_BYTES:
            built = build_op(op, world, nbytes, ITERS)
            for step in range(IPC_STEPS):
                got = built.step(built.example_input)
                torch.cuda.synchronize()
                check_exact(f"ipc world of {n}, rank {rank}: {op} at {nbytes} "
                            f"B, step {step}", got, wants[nbytes])
            del built
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = peer_launches(op, n, rank, len(IPC_BYTES) * IPC_STEPS)
        if got != want or any(kernels.PLAIN_CALLS.values()):
            fail(f"ipc world of {n}, rank {rank}: {op} launched {got}, want "
                 f"{want}; plain calls {kernels.PLAIN_CALLS}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
    # the barriers alone, across the processes: each set's pad slots and
    # the generation must count them
    for peers in ("all", "ring", "pair"):
        buffers = pr.PeerBuffers(world, {})
        for _ in range(BARRIER_CHAIN):
            pr.peer_barrier(buffers.pads, buffers.generation, rank,
                            peers=peers)
        torch.cuda.synchronize()
        own = buffers.pads[rank].tolist()
        want = [BARRIER_CHAIN if s in pr.barrier_set(peers, n, rank) else 0
                for s in range(n)]
        if own != want or int(buffers.generation) != BARRIER_CHAIN:
            fail(f"ipc world of {n}, rank {rank}: after {BARRIER_CHAIN} "
                 f"{peers} barriers pad {own} and generation "
                 f"{int(buffers.generation)}, want {want}")
        # no rank frees its pad while a peer may still signal it
        dist.barrier()
        del buffers
    said = _ipc_pushes(world)
    kernels.reset_counts()
    print(f"rank {rank} of {n}: {said}")
    if n == 4:
        _ipc_contend(rank, dev)
    print(f"rank {rank} of {n}: every pl_* op across {n} processes on "
          f"{min(n, cards)} card(s) through CUDA IPC at {IPC_BYTES[0]} B and 16 MiB, "
          f"{IPC_STEPS} steps each: bit for bit the sim kernels, each op's "
          f"launches its path's; {BARRIER_CHAIN} chained barriers of each "
          "set: the pads and generation count them")
    print("IPC_LAUNCHES " + json.dumps(totals))
    dist.destroy_process_group()


#: contend in the IPC world of 4 on a 2 x 2 mesh: (victim axis, load
#: axis), the victim's bytes a rank, runs
IPC_CONTEND = (("ici", "dcn"), ("dcn", "ici"))
IPC_CONTEND_BYTES, IPC_CONTEND_RUNS = 1024 * 1024, 5


def _ipc_contend(rank: int, dev) -> None:
    """contend in the IPC world of 4 processes on a 2 x 2 mesh (dcn,
    ici): allreduce along one axis loaded by allreduce along the other,
    each lane on process groups of its own (gloo carries them: NCCL
    refuses two ranks on one card).  Prints each race's rows as
    IPC_CONTEND json; every rank's must be the same (each run's time its
    maximum over the ranks)."""
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.parallel import make_mesh
    from tpu_perf_torch.streams.contend import run_contend
    from tpu_perf_torch.world import DistWorld

    world = DistWorld(rank=rank, n=4, local_rank=0, device=dev,
                      mesh=make_mesh((2, 2), ("dcn", "ici"), n=4))
    for victim, load_axis in IPC_CONTEND:
        opts = Options(op="allreduce", load="allreduce",
                       buff_sz=IPC_CONTEND_BYTES, iters=ITERS,
                       num_runs=IPC_CONTEND_RUNS)
        rows = run_contend(opts, world=world, axis=victim,
                           load_axis=load_axis)
        print("IPC_CONTEND " + json.dumps({
            "victim": victim, "rank": rank,
            "rows": [(r.load, r.stream, r.n_devices, r.nbytes, r.time_ms)
                     for r in rows]}))


def _ipc_pushes(world, chunk: int = 1027) -> str:
    """The all-to-all's push and its pull in this rank's order, and the
    pingpong's pushed legs, across the processes of an IPC world (chunk
    odd: four-byte words), each rank's output (and group 1's stage) bit
    for bit the plain versions' on every rank's input.  Returns what it
    held."""
    import torch
    import torch.distributed as dist

    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import SimWorld

    n, rank, dev = world.n, world.rank, world.device
    half, elems, f32 = n // 2, n * chunk, torch.float32
    rows = example_input(SimWorld(n, dev), elems, "float32")
    b = pr.PeerBuffers(world, {"x": (elems, f32), "out": (elems, f32),
                               "stage": (elems, f32)})
    xs, outs, stages = b["x"], b["out"], b["stage"]
    xs[rank].copy_(rows[rank])
    what = f"ipc world of {n}, rank {rank}"

    def fence():
        # every rank's launches done: a push is whole in its peer's buffer
        torch.cuda.synchronize(dev)
        dist.barrier()

    fence()
    pr.peer_all_to_all_push(xs[rank], pr.PeerParts(outs), rank)
    fence()
    want = [torch.zeros_like(rows[0]) for _ in range(n)]
    for s in range(n):
        pr.peer_all_to_all_push_plain(rows[s], want, s)
    check_exact(f"{what}: peer_all_to_all pushed", outs[rank], want[rank])
    got = pr.peer_all_to_all(pr.PeerParts(pr._sub(x, rank * chunk, chunk)
                                          for x in xs), rank)
    check_exact(f"{what}: peer_all_to_all pulled", got,
                pr.peer_all_to_all_plain(
                    [r.view(n, chunk)[rank] for r in rows], rank))
    fence()
    if rank < half:  # leg 1: into the partner's stage
        pr.peer_copy("peer_pingpong", xs[rank], out=stages[rank + half])
    fence()
    if rank >= half:  # leg 2: the stage back into the partner's output
        check_exact(f"{what}: the pingpong's stage after leg 1",
                    stages[rank], pr.peer_copy_plain("peer_pingpong",
                                                     rows[rank - half]))
        pr.peer_copy("peer_pingpong", stages[rank], out=outs[rank - half])
    fence()
    if rank < half:
        check_exact(f"{what}: the pingpong's output after leg 2",
                    outs[rank], pr.peer_copy_plain("peer_pingpong",
                                                   rows[rank]))
    fence()
    del b
    return ("the all-to-all pushed and pulled, and the pingpong's pushed "
            f"legs, at {chunk} elements a chunk: their plain versions' bit "
            "for bit")


def _ipc_worlds(cards: int = 1) -> dict:
    """ipc_world at each size of IPC_RANKS, a process a rank, over
    ``cards`` cards; returns the launches by kernel, summed over the ranks
    and worlds.  Across cards (the pushes' and the barrier's stores into
    another card's memory over NVLink) it needs that many cards:
    ``python3 -c "import chip_smoke as c; c.ipc_across_cards(4)"``."""
    here = os.path.dirname(os.path.abspath(__file__))
    totals = {}
    contended: dict[str, dict] = {}
    for n in IPC_RANKS:
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.ipc_world({n}, {r}, {port}, "
             f"{cards})"],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=IPC_LIMIT_S) for p in procs]
        except subprocess.TimeoutExpired:
            fail(f"ipc world of {n}: no end within {IPC_LIMIT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                fail(f"ipc world of {n} exited {p.returncode}:\n{out}\n"
                     f"{err[-4000:]}")
            for line in out.splitlines():
                if line.startswith("IPC_LAUNCHES "):
                    for k, v in json.loads(line.split(" ", 1)[1]).items():
                        totals[k] = totals.get(k, 0) + v
                elif line.startswith("IPC_CONTEND "):
                    race = json.loads(line.split(" ", 1)[1])
                    contended.setdefault(race["victim"], {})[
                        race["rank"]] = race["rows"]
                else:
                    print(f"distributed: {line}")
        print(f"distributed: the ipc world of {n} on {min(n, cards)} "
              f"card(s) in {time.perf_counter() - t0:.1f} s")
    said = []
    for victim, load_axis in IPC_CONTEND:
        ranks = contended.get(victim, {})
        rows = ranks.get(0, [])
        if (sorted(ranks) != [0, 1, 2, 3]
                or any(v != rows for v in ranks.values())
                or len(rows) != 2 * IPC_CONTEND_RUNS
                or {tuple(r[:3]) for r in rows}
                != {("", 0, 4), ("allreduce", 1, 4)}):
            fail(f"ipc world of 4: contend along {victim}: rows by rank "
                 f"{ {k: len(v) for k, v in ranks.items()} }")
        idle = _median([r[4] for r in rows if not r[0]])
        loaded = _median([r[4] for r in rows if r[0]])
        said.append(f"allreduce along {victim} under allreduce along "
                    f"{load_axis}: x{loaded / idle:.3f}")
    print(f"distributed: contend in the ipc world of 4 on one card, mesh "
          f"2 x 2 (gloo), {IPC_CONTEND_BYTES} B/rank, -i {ITERS} -r "
          f"{IPC_CONTEND_RUNS}, rows identical on the 4 ranks: "
          + "; ".join(said))
    return totals


def ipc_across_cards(cards: int) -> int:
    """The IPC worlds of IPC_RANKS processes with rank r on card r % cards
    (every card of one host, peer to peer): every pl_* op bit for bit the
    sim kernels' chain, and the chained barriers of each set, with the
    pushes and signals crossing cards.  Builds the kernels first; prints
    the card names and the ok line."""
    import torch

    from tpu_perf_torch.kernels import _build

    if torch.cuda.device_count() < cards:
        fail(f"ipc across cards: {cards} cards asked, "
             f"{torch.cuda.device_count()} visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.build_all()
    totals = _ipc_worlds(cards)
    print(json.dumps({"ok": True, "cards": cards, "launches": totals}))
    return 0


# --- the multi-rank world across cards (run by across_cards, never by main)

#: every op a multi-rank world runs, held against the sim chain across
#: the cards: the library ops, every pl_* op on the peer kernels, the
#: local instruments
CARDS_OPS = ("allreduce", "all_gather", "reduce_scatter", "all_to_all",
             "broadcast", "broadcast_psum", "barrier", "ring", "halo",
             "exchange", "ppermute", "pingpong", "pingpong_unidir",
             "hbm_stream", *PEER_OPS, "pl_hbm_stream", "pl_hbm_copy",
             "pl_hbm_read", "pl_hbm_write")
#: ops whose output is held within RTOL (sums, the stream's multiply-add)
CARDS_ARITH = ("allreduce", "reduce_scatter", "barrier", "hbm_stream",
               "pl_allreduce", "pl_reduce_scatter", "pl_hbm_stream",
               "hier_allreduce")
CARDS_BYTES, CARDS_STEPS = (4108, 16 * 1024**2), 2
#: the push chains: (per-rank bytes, steps), every step's output bit for
#: bit the first one's
PUSH_OPS = ("pl_allreduce", "pl_all_gather", "pl_all_gather_bidir",
            "pl_all_to_all", "pl_pingpong")
PUSH_CHAINS = ((4096, 2000), (4108, 2000), (16 * 1024**2, 1000),
               (MAIN_BYTES, 300))
#: the timed sizes a rank, and the launches a graph holds at each
CARDS_TIMED = ((MAIN_BYTES, 10), (4096, 100))
#: NVLink's rate each way a card (H100 SXM: 18 links of 25 GB/s)
LINK_BYTES_PER_S = 450e9
CARDS_LIMIT_S = 900
#: the CLI runs across the cards: the family, its sweep and the daemon's
CARDS_SWEEP = "4K,16M"
CARDS_DAEMON_RUNS = 3000


def _nccl_world(device: str):
    """Join the world torchrun's variables name (NCCL on the card, gloo on
    the CPU) and return this rank's DistWorld."""
    import torch

    from tpu_perf_torch.parallel import initialize_distributed
    from tpu_perf_torch.world import dist_world

    if not initialize_distributed(device=device):
        fail("across cards: no world to join")
    return dist_world(torch.device(device))


def _sim_row(op: str, n: int, nbytes: int, dev, mesh=None):
    """Rank-major rows of ``op``'s sim chain (ITERS executions) on ``dev``:
    what a multi-rank world's ranks must hold."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.world import SimWorld

    built = build_op(op, SimWorld(n, dev, mesh), nbytes, ITERS)
    out = built.step(built.example_input)
    return out.reshape(n, -1)


def _cards_ops(world) -> int:
    """Every op of CARDS_OPS at CARDS_BYTES, CARDS_STEPS steps each, and
    hier_allreduce on a 2 x 2 (dcn, ici) mesh: this rank's output of each
    step against its row of the sim chain (within RTOL for the sums,
    exact otherwise), and each pl_* op's launches its path's.  Returns
    the cases held."""
    import torch

    from tpu_perf_torch import kernels
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.parallel import make_hybrid_mesh
    from tpu_perf_torch.world import dist_world

    n, rank, dev = world.n, world.rank, world.device
    cases = 0
    for op, w in [(op, world) for op in CARDS_OPS] + [
            ("hier_allreduce", dist_world(dev, make_hybrid_mesh(
                n=n, per_node=n // 2)))]:
        # the sim chain first: its kernels count apart from the op's
        wants = {nbytes: _sim_row(op, n, nbytes, dev, w.mesh)[rank]
                 for nbytes in CARDS_BYTES}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        kernels.reset_counts()
        for nbytes in CARDS_BYTES:
            want = wants[nbytes]
            built = build_op(op, w, nbytes, ITERS)
            for step in range(CARDS_STEPS):
                got = built.step(built.example_input).reshape(-1)
                what = (f"across {n} cards, rank {rank}: {op} at {nbytes} B,"
                        f" step {step}")
                if op in CARDS_ARITH:
                    check_close(what, got, want, "float32")
                else:
                    check_exact(what, got, want)
                cases += 1
            del built
        if op in PEER_PATHS and dev.type == "cuda":
            got = {k: v for k, v in kernels.LAUNCHES.items() if v}
            want = peer_launches(op, n, rank, len(CARDS_BYTES) * CARDS_STEPS)
            if got != want or any(kernels.PLAIN_CALLS.values()):
                fail(f"across {n} cards, rank {rank}: {op} launched {got}, "
                     f"want {want}; plain calls {kernels.PLAIN_CALLS}")
    return cases


def _push_chains(world) -> list[str]:
    """The push steps replayed from a CUDA graph PUSH_CHAINS times at each
    size, each replay's output compared on the card with the eager step's
    (itself held against the sim chain): every step bit for bit."""
    import torch

    from tpu_perf_torch.ops.collectives import build_op

    n, rank, dev = world.n, world.rank, world.device
    said = []
    for op in PUSH_OPS:
        for nbytes, steps in PUSH_CHAINS:
            built = build_op(op, world, nbytes, ITERS)
            x = built.example_input
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                want = built.step(x).clone()
            torch.cuda.synchronize(dev)
            sim = _sim_row(op, n, nbytes, dev)[rank]
            what = f"push chain {op} at {nbytes} B, rank {rank}"
            if op in CARDS_ARITH:
                check_close(what, want.reshape(-1), sim, "float32")
            else:
                check_exact(what, want.reshape(-1), sim)
            del sim
            differed = torch.zeros((), dtype=torch.int64, device=dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                y = built.step(x)
                differed.add_((y != want).any().to(torch.int64))
            del y
            for _ in range(steps):
                graph.replay()
            torch.cuda.synchronize(dev)
            if int(differed) != 0:
                fail(f"{what}: {int(differed)} of {steps} steps differed "
                     "from the eager step")
            said.append(f"{op}@{nbytes}: {steps} steps, 0 differed")
            del graph, built, want
    return said


def _rank_max_ms(world, ms: float) -> float:
    import torch
    import torch.distributed as dist

    t = torch.tensor([ms], dtype=torch.float64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _per_launch_ms(world, launch, k: int, *, graph: bool = True,
                   replays: int = 5) -> float:
    """Device ms a call of ``launch()``: k calls captured into a CUDA
    graph (or, with ``graph`` False, issued eagerly back to back) after
    one eager call on the capture stream, replayed ``replays`` times
    after one warm replay; the ranks start together (one host barrier)
    and the slowest rank's time is returned."""
    import torch
    import torch.distributed as dist

    dev = world.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        launch()
    torch.cuda.synchronize(dev)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(k):
                launch()

        def run():
            g.replay()
    else:
        def run():
            for _ in range(k):
                launch()
    with torch.cuda.stream(side):
        run()
        torch.cuda.synchronize(dev)
        dist.barrier()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(replays):
            run()
        e1.record()
    torch.cuda.synchronize(dev)
    return _rank_max_ms(world, e0.elapsed_time(e1) / (replays * k))


def _cards_bound(memory_bytes: int, link_bytes: int) -> dict:
    """The larger of the card's memory time and its link time (each way)."""
    hbm, _ = card_rates()
    mem_ms = memory_bytes / hbm * 1e3
    link_ms = link_bytes / LINK_BYTES_PER_S * 1e3
    return {"bound_ms": max(mem_ms, link_ms),
            "bound_by": "link" if link_ms >= mem_ms else "memory",
            "memory_ms": mem_ms, "link_ms": link_ms}


def _serial_bound(*legs: tuple[int, int]) -> dict:
    """The schedule bound of legs that run one after another, each leg's
    (memory bytes, link bytes) on the busiest card: the sum of their
    _cards_bound."""
    parts = [_cards_bound(*leg) for leg in legs]
    return {"bound_ms": sum(p["bound_ms"] for p in parts),
            "bound_by": " and ".join(sorted({p["bound_by"] for p in parts})),
            "memory_ms": sum(p["memory_ms"] for p in parts),
            "link_ms": sum(p["link_ms"] for p in parts)}


def _latency_bound(memory_bytes: int, link_bytes: int) -> dict:
    """A barrier's bound: its bytes' time (far below a signal's round
    trip), marked latency-bound, so that no share of it is printed."""
    return {**_cards_bound(memory_bytes, link_bytes), "bound_by": "latency"}


def _cards_timing(world, nbytes: int, k: int) -> list[dict]:
    """Each peer kernel at ``nbytes`` a rank across the cards (chained
    launches from a graph; the barrier kernels as they run, each launch
    meeting the ranks) beside its NCCL call on the same cards, with the
    bound of each."""
    import torch
    import torch.distributed as dist

    from tpu_perf_torch.ops import pallas_ring as pr

    n, rank, dev = world.n, world.rank, world.device
    f32 = torch.float32
    chunk = nbytes // 4 // n
    elems = n * chunk
    half = n // 2
    b = pr.PeerBuffers(world, {"x": (elems, f32), "mid": (chunk, f32),
                               "out": (elems, f32), "stage": (elems, f32)})
    xs, mids, outs, stage = (b["x"], b["mid"], b["out"], b["stage"])
    xs[rank].copy_(torch.arange(elems, dtype=f32, device=dev) % 251 + rank)
    mids[rank].copy_(xs[rank][:chunk])
    own, out = xs[rank], outs[rank]
    rs_parts = pr.PeerParts(pr._sub(p, rank * chunk, chunk) for p in xs)
    mid_parts, out_parts = pr.PeerParts(mids), pr.PeerParts(outs)
    torch.cuda.synchronize(dev)
    dist.barrier()
    x_lib = own.clone()
    y_lib = torch.empty_like(x_lib)
    c_lib = torch.empty(chunk, dtype=f32, device=dev)
    one = torch.ones(1, dtype=f32, device=dev)
    ring_to, ring_from = (rank + 1) % n, (rank - 1) % n
    partner = (rank + half) % n

    def p2p(pairs):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend if send else dist.irecv, t, peer)
            for send, t, peer in pairs])
        for r in reqs:
            r.wait()

    def pingpong():
        # the step's execution: leg 1 pushed by group 0 under group 1's
        # local copy, leg 2 pushed back by group 1
        pr.peer_barrier(b.pads, b.generation, rank, peers="pair")
        pr.peer_copy("peer_pingpong", own,
                     out=stage[partner] if rank < half else out)
        pr.peer_barrier(b.pads, b.generation, rank, peers="pair")
        if rank >= half:
            pr.peer_copy("peer_pingpong", stage[rank], out=outs[partner])

    def nccl_pingpong():
        if rank < half:
            p2p([(True, x_lib, partner)])
            p2p([(False, y_lib, partner)])
        else:
            p2p([(False, y_lib, partner)])
            p2p([(True, y_lib, partner)])

    isz = 4
    move = _cards_bound(2 * elems * isz, elems * isz)
    gather_bound = _cards_bound((chunk + n * chunk) * isz,
                                (n - 1) * chunk * isz)
    a2a_bound = _cards_bound(2 * elems * isz, (n - 1) * chunk * isz)
    cases = [
        ("peer_reduce_scatter", 599,
         lambda: pr.peer_reduce_scatter(rs_parts, rank, scale=1.0 / n,
                                        out=mids[rank]),
         "reduce_scatter_tensor (graph)", True,
         lambda: dist.reduce_scatter_tensor(c_lib, x_lib),
         _cards_bound((n * chunk + chunk) * isz, (n - 1) * chunk * isz)),
        ("peer_all_gather", 481,
         lambda: pr.peer_all_gather_push(mids[rank], out_parts, rank),
         "all_gather_into_tensor (graph)", True,
         lambda: dist.all_gather_into_tensor(y_lib, c_lib), gather_bound),
        # pl_allreduce's last execution: the pull in each rank's order
        ("peer_all_gather pulled", 481,
         lambda: pr.peer_all_gather(mid_parts, rank, out=out),
         "all_gather_into_tensor (graph)", True,
         lambda: dist.all_gather_into_tensor(y_lib, c_lib), gather_bound),
        ("peer_all_gather_bidir", 430,
         lambda: pr.peer_all_gather_push(mids[rank], out_parts, rank,
                                         bidir=True),
         "all_gather_into_tensor (graph)", True,
         lambda: dist.all_gather_into_tensor(y_lib, c_lib),
         _cards_bound((chunk + n * chunk) * isz, (n - 1) * chunk * isz)),
        ("peer_ring", 345,
         lambda: pr.peer_copy("peer_ring", xs[ring_from], out=out),
         "batch_isend_irecv, ring", False,
         lambda: p2p([(True, x_lib, ring_to), (False, y_lib, ring_from)]),
         move),
        ("peer_exchange", 365,
         lambda: pr.peer_copy("peer_exchange", xs[partner], out=out),
         "batch_isend_irecv, pair", False,
         lambda: p2p([(True, x_lib, partner), (False, y_lib, partner)]),
         move),
        # two legs in series: leg 1 lands in group 1's stage while group 1
        # copies its own (3 buffers through its memory), leg 2 crosses back
        ("peer_pingpong", 385, pingpong,
         "isend / irecv there and back", False, nccl_pingpong,
         _serial_bound((3 * elems * isz, elems * isz),
                       (elems * isz, elems * isz))),
        ("peer_all_to_all", 291,
         lambda: pr.peer_all_to_all_push(own, out_parts, rank),
         "all_to_all_single", False,
         lambda: dist.all_to_all_single(y_lib, x_lib), a2a_bound),
        # pl_all_to_all's last execution: the pull in each rank's order
        ("peer_all_to_all pulled", 291,
         lambda: pr.peer_all_to_all(rs_parts, rank, out=out),
         "all_to_all_single", False,
         lambda: dist.all_to_all_single(y_lib, x_lib), a2a_bound),
        ("peer_barrier", 278,
         lambda: pr.peer_barrier(b.pads, b.generation, rank),
         "all_reduce of one element (graph)", True,
         lambda: dist.all_reduce(one),
         _latency_bound(2 * n * 4, (n - 1) * 4)),
        ("peer_barrier_copy", 329,
         lambda: pr.peer_barrier(b.pads, b.generation, rank,
                                 copy=(own[:1], out[:1])),
         "all_reduce of one element (graph)", True,
         lambda: dist.all_reduce(one),
         _latency_bound(2 * n * 4 + 2 * isz, (n - 1) * 4)),
    ]
    rows = []
    for name, line, kernel, lib_name, lib_graph, lib, bound in cases:
        rows.append({
            "name": name, "bytes_a_rank": nbytes, "ranks": n,
            "replaces": f"tpu_perf/ops/pallas_ring.py:{line}",
            "ms": _per_launch_ms(world, kernel, k),
            "library_call": lib_name,
            "library_ms": _per_launch_ms(world, lib, k, graph=lib_graph),
            **bound})
    # every barrier the timings launched met every rank: one more round
    # leaves each rank's generation equal to the others'
    gens = torch.zeros(n, dtype=torch.int64, device=dev)
    pr.peer_barrier(b.pads, b.generation, rank)
    gens[rank] = int(b.generation)
    dist.all_reduce(gens)
    if len(set(gens.tolist())) != 1:
        fail(f"across {n} cards: barrier generations {gens.tolist()}")
    torch.cuda.synchronize(dev)
    dist.barrier()
    del b
    return rows


def cards_rank(device: str = "cuda") -> None:
    """One rank of across_cards' world, joined from torchrun's variables:
    every op against the sim chain (:func:`_cards_ops`), then on the card
    the push chains and the peer kernels' times beside NCCL's.  Rank 0
    prints the results, the timings as one CARDS_KERNELS json line."""
    import torch

    from tpu_perf_torch.parallel.multihost import leave_world

    t0 = time.perf_counter()
    world = _nccl_world(device)
    n, rank = world.n, world.rank
    cases = _cards_ops(world)
    said = [f"every op of {len(CARDS_OPS)} and hier_allreduce on a 2 x "
            f"{n // 2} mesh at {CARDS_BYTES}, {CARDS_STEPS} steps: the sim "
            f"chain's row ({cases} cases on this rank; sums within RTOL, "
            f"the rest bit for bit), each pl_* op's launches its path's "
            f"({time.perf_counter() - t0:.1f} s)"]
    rows = []
    if world.device.type == "cuda":
        said += [f"push chain {s}" for s in _push_chains(world)]
        for nbytes, k in CARDS_TIMED:
            rows += _cards_timing(world, nbytes, k)
        torch.cuda.synchronize()
    if rank == 0:
        for line in said:
            print(f"cards: {line}")
        for r in rows:
            bound = ("latency-bound" if r["bound_by"] == "latency" else
                     f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                     f"(memory {r['memory_ms']:.4f}, link "
                     f"{r['link_ms']:.4f}), {r['bound_ms'] / r['ms']:.1%} "
                     "of it")
            print(f"cards: {r['name']} at {r['bytes_a_rank']} B a rank x "
                  f"{n}: {r['ms']:.4f} ms, NCCL {r['library_call']} "
                  f"{r['library_ms']:.4f} ms (kernel / NCCL "
                  f"{r['ms'] / r['library_ms']:.3f}), {bound}")
        print("CARDS_KERNELS " + json.dumps(rows), flush=True)
    leave_world()


def _rank_env(rank: int, n: int, port: int, per_node: int,
              **more) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
               LOCAL_RANK=str(rank % per_node),
               LOCAL_WORLD_SIZE=str(per_node), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    env.update(more)
    return env


def _procs(cmds: list, envs: list, what: str, limit: float) -> list:
    """Run the processes of one world to their end under a wall-clock
    limit; any rank's failure fails the smoke with its output's tail.
    Returns (stdout, stderr) each."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(c, cwd=here, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    try:
        outs = [p.communicate(timeout=limit) for p in procs]
    except subprocess.TimeoutExpired:
        fail(f"{what}: no end within {limit} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{what}: process {i} exited {p.returncode}:\n"
                 f"{out[-3000:]}\n{err[-4000:]}")
    return outs


def _torchrun(n: int, argv: list, what: str, device: str, **env) -> list:
    """``torchrun --nproc-per-node n -m tpu_perf_torch <argv> --distributed``
    as a user runs it; every rank must end with rc 0 (torchrun's own)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(n), "--master-addr", "127.0.0.1", "--master-port",
           str(_free_port()), "-m", "tpu_perf_torch", *argv,
           "--distributed", "--device", device]
    (out, err), = _procs([cmd], [dict(os.environ, **env)], what,
                         CARDS_LIMIT_S)
    return [out, err]


def _logged_rows(folder: str, prefix: str = "tpu") -> dict:
    """Every rank's rows in ``folder``, by rank (from the file names)."""
    import glob

    from tpu_perf_torch.schema import LegacyRow, ResultRow

    parse = ResultRow.from_csv if prefix == "tpu" else LegacyRow.from_csv
    rows: dict[int, list] = {}
    for path in glob.glob(os.path.join(folder, f"{prefix}-*.log")):
        rank = int(os.path.basename(path).split("-")[-3])
        with open(path) as fh:
            rows.setdefault(rank, []).extend(
                parse(ln) for ln in fh if ln.strip())
    return rows


def _cards_cli(n: int, device: str) -> list[str]:
    """The CLI across the cards: a run over every op of CARDS_OPS (rows
    identical on every rank, the heartbeats' triple from rank 0 alone); a
    -l daemon rotating every second into a local sink (no row of any rank
    lost, passes fired by local rank 0 alone, skipping the node's n live
    writers); and hier_allreduce on two nodes of n / 2 cards each
    (``--hybrid-mesh``)."""
    import tempfile

    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import sizes_for

    said = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke-cards-") as root:
        logs = os.path.join(root, "run")
        t0 = time.perf_counter()
        family = ",".join(CARDS_OPS)
        _, err = _torchrun(n, [
            "run", "--op", family, "--sweep", CARDS_SWEEP, "-i", str(ITERS),
            "-r", str(RUNS), "--stats-every", str(RUNS),
            "--heartbeat-format", "json", "-l", logs],
            f"torchrun run --distributed over {len(CARDS_OPS)} ops", device)
        rows = _logged_rows(logs)
        if sorted(rows) != list(range(n)):
            fail(f"across cards: rows of ranks {sorted(rows)}")
        keys = [sorted((r.op, r.nbytes, r.run_id, r.time_ms)
                       for r in rows[k]) for k in range(n)]
        points = sum(len(sizes_for(Options(sweep=CARDS_SWEEP, op=op)))
                     for op in CARDS_OPS)
        want = points * RUNS
        if any(k != keys[0] for k in keys) or len(keys[0]) != want:
            fail(f"across cards: rows differ between ranks or are not "
                 f"{want}: {[len(k) for k in keys]}")
        beats = [json.loads(ln) for ln in err.splitlines()
                 if ln.startswith("{")]
        bad = [b for b in beats if not b.get("hosts") or not (
            b["hosts"]["min"] <= b["hosts"]["avg"] <= b["hosts"]["max"])]
        if len(beats) != points or bad:
            fail(f"across cards: {len(beats)} heartbeats, bad {bad[:3]}")
        said.append(f"run --distributed over {len(CARDS_OPS)} ops at "
                    f"{CARDS_SWEEP}: {want} rows, identical on the {n} "
                    f"ranks; {len(beats)} heartbeats from rank 0, hosts min "
                    f"<= avg <= max ({time.perf_counter() - t0:.1f} s)")
        logs, sink = os.path.join(root, "daemon"), os.path.join(root, "sink")
        passes = os.path.join(root, "passes")
        t0 = time.perf_counter()
        cmd = (f'echo "$LOCAL_RANK" >> {passes} && exec {sys.executable} -m '
               f"tpu_perf_torch ingest -d {logs} -f {n}")
        _torchrun(n, ["monitor", "--op", "pl_allreduce,allreduce",
                      "--sweep", "4K", "-i", str(ITERS), "--max-runs",
                      str(CARDS_DAEMON_RUNS), "--log-refresh-sec", "1",
                      "-l", logs], "torchrun monitor --distributed -l",
                  device, TPU_PERF_INGEST=f"local:{sink}",
                  TPU_PERF_INGEST_CMD=cmd)
        with open(passes) as fh:
            fired = fh.read().split()
        got = {}
        for prefix in ("tcp", "tpu"):
            arrived, left = (_logged_rows(sink, prefix),
                             _logged_rows(logs, prefix))
            for k in range(n):
                ids = sorted(r.run_id for r in arrived.get(k, []) +
                             left.get(k, []))
                if ids != list(range(1, CARDS_DAEMON_RUNS + 1)) or \
                        not arrived.get(k):
                    fail(f"across cards: the daemon's {prefix} rows of rank "
                         f"{k}: {len(ids)} of {CARDS_DAEMON_RUNS}, "
                         f"{len(arrived.get(k, []))} in the sink")
            got[prefix] = sum(len(v) for v in arrived.values())
        if not fired or set(fired) != {"0"}:
            fail(f"across cards: ingest passes fired by local ranks {fired}")
        said.append(f"monitor --distributed -l rotating every second: every "
                    f"rank's {CARDS_DAEMON_RUNS} rows of each family kept "
                    f"({got} in the sink), {len(fired)} passes, all fired by "
                    f"local rank 0 ({time.perf_counter() - t0:.1f} s)")
        # two nodes of n / 2 cards: each node's processes see its cards
        # only, as torchrun's ranks on two hosts would
        t0 = time.perf_counter()
        per_node, port = n // 2, _free_port()
        logs = os.path.join(root, "hier")
        argv = [sys.executable, "-m", "tpu_perf_torch", "run",
                "--distributed", "--hybrid-mesh", "--op", "hier_allreduce",
                "-b", str(HIER_BYTES), "-i", str(ITERS), "-r", str(RUNS),
                "--device", device, "-l", logs]
        envs = []
        for r in range(n):
            node = r // per_node
            cards = ",".join(str(node * per_node + i) for i in range(per_node))
            envs.append(_rank_env(r, n, port, per_node,
                                  CUDA_VISIBLE_DEVICES=cards))
        _procs([argv] * n, envs, "--hybrid-mesh hier_allreduce", CARDS_LIMIT_S)
        rows = _logged_rows(logs)
        lat = [[r.lat_us for r in rows.get(k, [])] for k in range(n)]
        if any(len(v) != RUNS or v != lat[0] for v in lat):
            fail(f"across cards: hier_allreduce rows {lat}")
        said.append(f"--hybrid-mesh (2 nodes x {per_node} cards): "
                    f"hier_allreduce at {HIER_BYTES} B, lat p50 "
                    f"{_median(lat[0]):.1f} us, rows identical on the {n} "
                    f"ranks ({time.perf_counter() - t0:.1f} s)")
        # the adaptive stop rule across the cards: each rank's samples its
        # own, every rank's runs the same (the vote)
        t0 = time.perf_counter()
        logs = os.path.join(root, "adaptive")
        _torchrun(n, ["run", "--op", "pl_allreduce,allreduce", "--sweep",
                      CARDS_SWEEP, "-i", str(ITERS), *ADAPTIVE, "-l", logs],
                  "torchrun run --distributed --ci-rel", device)
        rows = _logged_rows(logs)
        taken = {k: sorted((r.op, r.nbytes, r.run_id, r.runs_taken)
                           for r in rows.get(k, [])) for k in range(n)}
        lasts = {}
        for op, nb, run_id, _ in taken[0]:
            lasts[(op, nb)] = max(lasts.get((op, nb), 0), run_id)
        if (sorted(rows) != list(range(n))
                or any(v != taken[0] for v in taken.values())
                or not all(MIN_RUNS <= k <= MAX_RUNS
                           for k in lasts.values())):
            fail(f"across cards: --ci-rel runs differ between ranks or "
                 f"leave their bounds: {lasts}, rows by rank "
                 f"{ {k: len(v) for k, v in taken.items()} }")
        said.append(f"run --distributed --ci-rel {CI_REL} --min-runs "
                    f"{MIN_RUNS} --max-runs {MAX_RUNS}: runs a point "
                    + ", ".join(f"{op}@{nb} {k}" for (op, nb), k
                                in sorted(lasts.items()))
                    + f", the same on the {n} ranks "
                    f"({time.perf_counter() - t0:.1f} s)")
        # contend on a 2 x 2 mesh across the cards, each axis in turn
        for victim, other in (("ici", "dcn"), ("dcn", "ici")):
            t0 = time.perf_counter()
            logs = os.path.join(root, f"contend-{victim}")
            _torchrun(n, ["contend", "--mesh", "2x2", "--axes", "dcn,ici",
                          "--op", "allreduce", "--load", "allreduce",
                          "--victim-axis", victim, "--load-axis", other,
                          "-b", str(MESH_CONTEND_BYTES), "-i", str(ITERS),
                          "-r", str(MESH_CONTEND_RUNS), "-l", logs],
                      f"torchrun contend --victim-axis {victim}", device)
            rows = _logged_rows(logs)
            got = {k: [(r.load, r.stream, r.time_ms) for r in rows.get(k, [])]
                   for k in range(n)}
            if (any(v != got[0] for v in got.values())
                    or len(got[0]) != 2 * MESH_CONTEND_RUNS):
                fail(f"across cards: contend along {victim}: rows "
                     f"{ {k: len(v) for k, v in got.items()} }")
            idle = _median([t for ld, _, t in got[0] if not ld])
            loaded = _median([t for ld, _, t in got[0] if ld])
            said.append(f"contend on 2 x 2: allreduce at "
                        f"{MESH_CONTEND_BYTES} B along {victim} under "
                        f"allreduce along {other}: idle {idle:.4f} ms, "
                        f"loaded {loaded:.4f} ms, x{loaded / idle:.3f}, "
                        f"rows identical on the {n} ranks "
                        f"({time.perf_counter() - t0:.1f} s)")
    return said


#: the skew soak across the cards: allreduce at 4 KiB and 16 MiB a rank
#: round robin under the fused fence, the last rank entering late by up
#: to CARDS_SKEW_US in visits 101-300
CARDS_SKEW_US, CARDS_SKEW_RUNS, CARDS_SKEW_STATS = 1000.0, 400, 50


def _cards_chaos(n: int, device: str) -> list[str]:
    """A `chaos` soak through torchrun with one ``skew`` fault on the last
    rank, real timing: every other rank's samples must carry the wait, so
    chaos verify must catch the fault through the regression events of
    each victim rank."""
    import tempfile

    from tpu_perf_torch.health.events import HealthEvent

    straggler = n - 1
    spec = {"faults": [{"kind": "skew", "op": "allreduce",
                        "rank": straggler, "magnitude": CARDS_SKEW_US,
                        "start": 101, "end": 300}]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-skew-") as root:
        path, folder = os.path.join(root, "skew.json"), os.path.join(
            root, "logs")
        with open(path, "w") as fh:
            json.dump(spec, fh)
        t0 = time.perf_counter()
        fence = "fused"
        _torchrun(n, ["chaos", "--faults", path, "--op", "allreduce",
                      "--sweep", "4K,16M", "-i", str(ITERS), "--fence",
                      fence, "--max-runs", str(CARDS_SKEW_RUNS),
                      "--stats-every", str(CARDS_SKEW_STATS), "-l", folder],
                  f"torchrun chaos, a skew fault on rank {straggler}",
                  device)
        wall = time.perf_counter() - t0
        out = _verify(folder, "chaos with a skew fault across the cards")
        if "1/1 fault(s) caught" not in out:
            fail(f"across cards: the skew fault was not caught:\n{out}")
        events = [HealthEvent(**e) for e in _jsonl(folder, "health")]
        victims = sorted({e.rank for e in events if e.kind == "regression"
                          and 101 <= e.run_id <= 300 + 2 * CARDS_SKEW_STATS
                          and e.rank != straggler})
        if victims != [r for r in range(n) if r != straggler]:
            fail(f"across cards: regression events on victim ranks "
                 f"{victims}, events {[(e.rank, e.kind, e.run_id) for e in events]}")
        rows = _logged_rows(folder)
        lat = {}
        for nb in (4096, 16 * 1024**2):
            for label, lo, hi in (("before", 61, 100), ("during", 101, 300)):
                lat[(nb, label)] = _median([
                    r.lat_us for r in rows.get(0, [])
                    if r.nbytes == nb and lo <= r.run_id <= hi])
        kinds = {}
        for e in events:
            kinds[(e.rank, e.kind)] = kinds.get((e.rank, e.kind), 0) + 1
    return [f"chaos --fence {fence}, allreduce 4K,16M, skew on rank "
            f"{straggler} up to {CARDS_SKEW_US:g} us in visits 101-300: "
            f"verify 1/1 caught, regression events on victim ranks "
            f"{victims}; events by (rank, kind) {kinds}; rank 0 lat p50 "
            + ", ".join(f"{nb} B {label} {v:.2f} us"
                        for (nb, label), v in lat.items())
            + f" ({wall:.1f} s)"]


def cards_chaos(cards: int, device: str = "cuda") -> int:
    """The skew soak alone (:func:`_cards_chaos`); on a host with four
    cards: ``python3 -c "import chip_smoke as c; c.cards_chaos(4)"``."""
    if device == "cuda":
        print(card_line_all(), flush=True)
    for line in _cards_chaos(cards, device):
        print(f"cards: {line}", flush=True)
    print(json.dumps({"ok": True, "cards": cards}))
    return 0


def card_line_all() -> str:
    """Every visible card's name and power limit, as nvidia-smi gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def across_cards(cards: int, device: str = "cuda") -> int:
    """The multi-rank world across ``cards`` cards of one host, one rank a
    card on NCCL (never run by main, which needs one card); on a host with
    four cards::

        python3 -c "import chip_smoke as c; c.across_cards(4)"

    Builds the kernels; runs :func:`cards_rank` in a world of ``cards``
    processes (every op against the sim chain, the push chains, each peer
    kernel timed beside its NCCL call); then the CLI through torchrun
    (:func:`_cards_cli`) and the skew soak (:func:`_cards_chaos`).  Prints each card's name and power limit, the
    results, and ``{"ok": true, "cards": N}`` last.  ``device`` "cpu"
    rehearses the world and the CLI on gloo (no push chain, no timing)."""
    import torch

    t0 = time.perf_counter()
    if device == "cuda":
        if torch.cuda.device_count() < cards:
            fail(f"across cards: {cards} cards asked, "
                 f"{torch.cuda.device_count()} visible")
        print(card_line_all(), flush=True)
        from tpu_perf_torch.kernels import _build

        _build.build_all()
    port = _free_port()
    code = f"import chip_smoke; chip_smoke.cards_rank({device!r})"
    outs = _procs([[sys.executable, "-c", code]] * cards,
                  [_rank_env(r, cards, port, cards) for r in range(cards)],
                  f"the world of {cards} cards", CARDS_LIMIT_S)
    for line in outs[0][0].splitlines():
        print(line, flush=True)
    for line in _cards_cli(cards, device) + _cards_chaos(cards, device):
        print(f"cards: {line}", flush=True)
    print(f"cards: total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "cards": cards}))
    return 0


def _loopback_world(xs, chunk: int):
    """Per-rank buffers of an n-rank loopback: each rank's input is its own
    allocation (``xs``), as are its owned chunk, output, pad, generation
    and stream; the owned chunks, the outputs and the pads with their
    pointer tables."""
    import torch

    from tpu_perf_torch.ops.pallas_ring import PeerParts

    n = len(xs)
    dev = xs[0].device
    pads, gens = _pads(n, dev)
    return {
        "n": n, "chunk": chunk,
        "streams": [torch.cuda.Stream(dev) for _ in range(n)],
        "mids": PeerParts(torch.empty(chunk, dtype=xs[0].dtype, device=dev)
                          for _ in range(n)),
        "outs": PeerParts(torch.empty(n * chunk, dtype=xs[0].dtype,
                                      device=dev) for _ in range(n)),
        "pads": pads, "gens": gens,
    }


def _pads(n: int, dev):
    """n ranks' signal pads, zeroed, with their table, and generations."""
    import torch

    from tpu_perf_torch.ops.pallas_ring import PeerParts

    return (PeerParts(torch.zeros(n, dtype=torch.int32, device=dev)
                      for _ in range(n)),
            [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(n)])


def _rank_parts(xs, chunk: int) -> list:
    """What rank r's reduce-scatter and all-to-all read: chunk r of every
    rank's input, with its pointer table, for each r."""
    from tpu_perf_torch.ops.pallas_ring import PeerParts

    n = len(xs)
    return [PeerParts(x.view(n, chunk)[r] for x in xs) for r in range(n)]


def _on_streams(w, launch) -> None:
    """``launch(r)`` for every rank, each on its own stream, forked from
    and joined back to the current one."""
    import torch

    main = torch.cuda.current_stream()
    for s in w["streams"]:
        s.wait_stream(main)
    for r, s in enumerate(w["streams"]):
        with torch.cuda.stream(s):
            launch(r)
    for s in w["streams"]:
        main.wait_stream(s)


def _loopback_execution(w, parts, outs, scale: float) -> None:
    """One pl_allreduce execution of every rank of the loopback, phase by
    phase: barrier, reduce-scatter of the rank's chunk from every rank's
    input (``parts``, :func:`_rank_parts`), barrier, each rank's push of
    its owned chunk into ``outs`` (a PeerParts of every rank's output),
    whole once every stream is joined or at the next barrier."""
    from tpu_perf_torch.ops import pallas_ring as pr

    def barrier(r):
        pr.peer_barrier(w["pads"], w["gens"][r], r)

    _on_streams(w, barrier)
    _on_streams(w, lambda r: pr.peer_reduce_scatter(
        parts[r], r, scale=scale, out=w["mids"][r]))
    _on_streams(w, barrier)
    _on_streams(w, lambda r: pr.peer_all_gather_push(w["mids"][r], outs, r))


def _rank_inputs(n: int, chunk: int, dtype: str):
    """Rank r's input, its own allocation, and every rank's as the sim
    world's rows: the ranks' shards of one make_fill."""
    import torch

    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import SimWorld

    rows = example_input(SimWorld(n, torch.device("cuda")), n * chunk, dtype)
    return [rows[r].clone() for r in range(n)], rows


def _loopback_case(n: int, dtype: str, chunk: int) -> None:
    """One execution at n ranks: the owned chunks bit for bit the sim
    reduce-scatter's (float32) and the peer plain version's (every dtype),
    each output its row of the sim gather, every pad and generation at 2,
    and a third round of barriers its plain version's."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    xs, rows = _rank_inputs(n, chunk, dtype)
    w = _loopback_world(xs, chunk)
    scale = pr.mean_scale(n, xs[0].dtype)
    _loopback_execution(w, _rank_parts(xs, chunk), w["outs"], scale)
    torch.cuda.synchronize()
    mids = torch.stack(w["mids"])
    what = f"loopback n={n} {dtype} chunk={chunk}"
    for r in range(n):
        check_exact(f"{what}: rank {r} reduce-scatter against its plain "
                    "version", w["mids"][r], pr.peer_reduce_scatter_plain(
                        [x.view(n, chunk)[r] for x in xs], r, scale))
        check_exact(f"{what}: rank {r} gather against its plain version",
                    w["outs"][r], pr.peer_all_gather_plain(w["mids"]))
    if dtype == "float32":
        check_exact(f"{what}: reduce-scatter against the sim kernel", mids,
                    pr.direct_reduce_scatter(rows, scale=scale))
        check_exact(f"{what}: gather against the sim kernel",
                    torch.stack(w["outs"]), pr.direct_all_gather(mids))
    _check_barriers(w, 2, what)


def _check_barriers(w, rounds: int, what: str, peers: str = "all",
                    copies=None) -> float:
    """After ``rounds`` barriers of set ``peers`` a rank, every generation
    at ``rounds`` and every pad slot of a rank's set at ``rounds`` (the
    others at 0); then one more round of the kernel, every rank on its
    stream (with ``copies[r] = (src, dst)`` its tail copies), against the
    plain version's from the same pads and generations.  Returns that
    round's max abs err."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    n = w["n"]
    pads, gens = torch.stack(list(w["pads"])), torch.cat(w["gens"])
    want = torch.zeros_like(pads)
    for r in range(n):
        for s in pr.barrier_set(peers, n, r):
            want[s, r] = rounds
    if not (torch.equal(pads, want) and bool((gens == rounds).all())):
        fail(f"{what}: pads {pads.tolist()}, generations {gens.tolist()}, "
             f"want {want.tolist()} and {rounds}")
    want_pads = [p.clone() for p in w["pads"]]
    want_gens = [g.clone() for g in w["gens"]]
    want_dsts = []
    for r in range(n):
        copy = None
        if copies is not None:
            copy = (copies[r][0], torch.empty_like(copies[r][1]))
            want_dsts.append(copy[1])
        pr.peer_barrier_plain(want_pads, want_gens[r], r, peers, copy)
    _on_streams(w, lambda r: pr.peer_barrier(
        w["pads"], w["gens"][r], r, peers=peers,
        copy=None if copies is None else copies[r]))
    torch.cuda.synchronize()
    if copies is not None:
        check_exact(f"{what}: the tail copies against their plain version",
                    torch.cat([c[1] for c in copies]), torch.cat(want_dsts))
    return check_exact(f"{what}: a round of barriers against its plain "
                       "version", torch.cat([*w["pads"], *w["gens"]]),
                       torch.cat([*want_pads, *want_gens]))


def _loopback_chain(n: int, chunk: int) -> None:
    """LOOPBACK_CHAIN chained executions (each rank's output its next
    input), then a CUDA graph of two executions a rank, captured on the
    rank's stream and replayed LOOPBACK_REPLAYS times: every step bit for
    bit the sim kernels' chain, the generations advanced on the device."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    xs, rows = _rank_inputs(n, chunk, "float32")
    ys = [torch.empty_like(x) for x in xs]
    w = _loopback_world(xs, chunk)
    scale = pr.mean_scale(n, xs[0].dtype)
    parts = [_rank_parts(xs, chunk), _rank_parts(ys, chunk)]
    outs = [pr.PeerParts(ys), pr.PeerParts(xs)]

    def sim(y, k):
        for _ in range(k):
            y = pr.direct_all_gather(pr.direct_reduce_scatter(y, scale=scale))
        return y

    for j in range(LOOPBACK_CHAIN):
        _loopback_execution(w, parts[j % 2], outs[j % 2], scale)
    torch.cuda.synchronize()
    want = sim(rows, LOOPBACK_CHAIN)
    check_exact(f"loopback n={n}: {LOOPBACK_CHAIN} chained executions",
                torch.stack(xs), want)
    graphs = []
    for r, s in enumerate(w["streams"]):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            for b in (0, 1):
                pr.peer_barrier(w["pads"], w["gens"][r], r)
                pr.peer_reduce_scatter(parts[b][r], r, scale=scale,
                                       out=w["mids"][r])
                pr.peer_barrier(w["pads"], w["gens"][r], r)
                pr.peer_all_gather_push(w["mids"][r], outs[b], r)
        graphs.append(g)
    t0 = time.perf_counter()
    for _ in range(LOOPBACK_REPLAYS):
        _on_streams(w, lambda r: graphs[r].replay())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_exact(f"loopback n={n}: {LOOPBACK_REPLAYS} replays of a graph of "
                "two executions", torch.stack(xs),
                sim(want, 2 * LOOPBACK_REPLAYS))
    executions = LOOPBACK_CHAIN + 2 * LOOPBACK_REPLAYS
    _check_barriers(w, 2 * executions, f"loopback n={n}")
    print(f"n={n} float32 chunk={chunk}: {LOOPBACK_CHAIN} chained executions "
          f"and {LOOPBACK_REPLAYS} replays of each rank's graph of two "
          f"equal the sim kernels' chain bit for bit; generations "
          f"{2 * executions} (advanced on the device); replays "
          f"{wall * 1e3 / LOOPBACK_REPLAYS:.3f} ms each")


def _loopback_steps(n: int, op: str, nbytes: int, dtype: str) -> None:
    """``op``'s own per-rank steps (``build_op`` in a DistWorld a rank) on
    an n-rank loopback, every rank's step on its own stream: STEP_CHAIN
    eager steps, each rank's output its next input, then STEP_REPLAYS
    replays of each rank's graph of one step that feeds its output back:
    bit for bit the sim kernels' chain of steps.  Every eager step's
    output is held to the end: no later step may overwrite it."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.world import SimWorld, loopback_ranks

    dev = torch.device("cuda", torch.cuda.current_device())
    builts = [build_op(op, world, nbytes, ITERS, dtype=dtype)
              for world in loopback_ranks(n, dev)]
    sim_step, _, _ = pr.build_pallas_step(op, SimWorld(n, dev), nbytes,
                                          ITERS, dtype=dtype)
    w = {"streams": [torch.cuda.Stream() for _ in range(n)]}
    ys = [b.example_input for b in builts]
    pr.warm_loopback_streams(w["streams"], dev, n * ys[0].nbytes)
    want = torch.stack(ys)
    kept = []
    for _ in range(STEP_CHAIN):
        outs = [None] * n

        def one(r):
            outs[r] = builts[r].step(ys[r])

        _on_streams(w, one)
        ys = outs
        want = sim_step(want)
        kept.append((ys, want))
    torch.cuda.synchronize()
    what = f"loopback n={n}: {op} {dtype} at {nbytes} B"
    for k, (got, step_want) in enumerate(kept):
        check_exact(f"{what}, eager step {k} after {STEP_CHAIN} steps",
                    torch.stack(got), step_want)
    xs = [y.clone() for y in ys]
    graphs = []
    for r, s in enumerate(w["streams"]):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            xs[r].copy_(builts[r].step(xs[r]))
        graphs.append(g)
    for _ in range(STEP_REPLAYS):
        _on_streams(w, lambda r: graphs[r].replay())
        want = sim_step(want)
    torch.cuda.synchronize()
    check_exact(f"{what}, {STEP_REPLAYS} graph replays", torch.stack(xs),
                want)


def _loopback_kernels(n: int, dtype: str, chunk: int) -> None:
    """Each new peer kernel at n ranks, every rank's launch on its own
    stream, against its plain version on the same parts: the copies from
    the ring's and the pair's source (the pingpong's also pushed to the
    partner, its legs), the all-to-all over chunk r of every rank's input,
    pulled in each rank's order and pushed, the bidirectional gather
    (chunk even) and the tiled reduce-scatter (floats); then the ring and
    pair barriers, and the all-rank one with its tail copy, two rounds
    each, against theirs."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    xs, _ = _rank_inputs(n, chunk, dtype)
    w = _loopback_world(xs, chunk)
    parts = _rank_parts(xs, chunk)
    what = f"loopback n={n} {dtype} chunk={chunk}"
    outs = [torch.empty_like(x) for x in xs]
    for name, shift in (("peer_ring", 1), ("peer_exchange", n // 2),
                        ("peer_pingpong", n // 2)):
        _on_streams(w, lambda r: pr.peer_copy(name, xs[(r - shift) % n],
                                              out=outs[r]))
        torch.cuda.synchronize()
        for r in range(n):
            check_exact(f"{what}: rank {r} {name}", outs[r],
                        pr.peer_copy_plain(name, xs[(r - shift) % n]))
    # the pingpong's legs push: rank r stores into its partner's buffer
    for o in outs:
        o.zero_()
    _on_streams(w, lambda r: pr.peer_copy("peer_pingpong", xs[r],
                                          out=outs[(r + n // 2) % n]))
    torch.cuda.synchronize()
    for r in range(n):
        check_exact(f"{what}: rank {r} peer_pingpong pushed", outs[r],
                    pr.peer_copy_plain("peer_pingpong", xs[(r - n // 2) % n]))
    _on_streams(w, lambda r: pr.peer_all_to_all(parts[r], r, out=outs[r]))
    torch.cuda.synchronize()
    for r in range(n):
        check_exact(f"{what}: rank {r} peer_all_to_all pulled", outs[r],
                    pr.peer_all_to_all_plain(list(parts[r]), r))
    for o in outs:
        o.zero_()
    dsts = pr.PeerParts(outs)
    _on_streams(w, lambda r: pr.peer_all_to_all_push(xs[r], dsts, r))
    torch.cuda.synchronize()
    want = [torch.zeros_like(o) for o in outs]
    for r in range(n):
        pr.peer_all_to_all_push_plain(xs[r], want, r)
    check_exact(f"{what}: peer_all_to_all pushed", torch.stack(outs),
                torch.stack(want))
    if chunk % 2 == 0:
        _on_streams(w, lambda r: pr.peer_all_gather_bidir(
            parts[0], r, out=outs[r]))
        torch.cuda.synchronize()
        for r in range(n):
            check_exact(f"{what}: rank {r} peer_all_gather_bidir", outs[r],
                        pr.peer_all_gather_bidir_plain(list(parts[0]), r))
    if dtype != "int32":
        scale = pr.mean_scale(n, xs[0].dtype)
        _on_streams(w, lambda r: pr.peer_reduce_scatter(
            parts[r], r, scale=scale, tiles=n, out=outs[r]))
        torch.cuda.synchronize()
        for r in range(n):
            check_exact(f"{what}: rank {r} tiled peer_reduce_scatter",
                        outs[r], pr.peer_reduce_scatter_plain(
                            list(parts[r]), r, scale, n))
    for peers in ("ring", "pair", "all"):
        w["pads"], w["gens"] = _pads(n, xs[0].device)
        copies = ([(xs[r][:1], outs[r][:1]) for r in range(n)]
                  if peers == "all" else None)
        _on_streams(w, lambda r: pr.peer_barrier(
            w["pads"], w["gens"][r], r, peers=peers,
            copy=None if copies is None else copies[r]))
        _check_barriers(w, 1, f"{what}: {peers} barriers", peers, copies)


#: chained barriers of each set in the loopback and the IPC worlds, and
#: how many each rank enqueues before the next rank (the streams' queues
#: stay short)
BARRIER_CHAIN, BARRIER_BATCH = 1000, 50


def _loopback_barrier_chains() -> None:
    """BARRIER_CHAIN chained barriers of each set at each n of
    LOOPBACK_RANKS, each rank's on its stream, BARRIER_BATCH a rank at a
    time: every pad slot of a rank's set and every generation count them,
    and one more round equals its plain version."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    for n in LOOPBACK_RANKS:
        w = {"n": n, "streams": [torch.cuda.Stream(dev) for _ in range(n)]}
        for peers in ("all", "ring", "pair"):
            w["pads"], w["gens"] = _pads(n, dev)
            for _ in range(BARRIER_CHAIN // BARRIER_BATCH):
                _on_streams(w, lambda r: [pr.peer_barrier(
                    w["pads"], w["gens"][r], r, peers=peers)
                    for _ in range(BARRIER_BATCH)])
            torch.cuda.synchronize()
            _check_barriers(w, BARRIER_CHAIN, f"loopback n={n}: "
                            f"{BARRIER_CHAIN} chained {peers} barriers",
                            peers)
    print(f"{BARRIER_CHAIN} chained barriers of each set (all, ring, pair) "
          f"at n = {LOOPBACK_RANKS}: pads and generations count them, one "
          "more round its plain version's "
          f"({time.perf_counter() - t0:.1f} s)")


def _loopback_timing() -> list[dict]:
    """The peer kernels at 8 ranks x MAIN_BYTES, every rank's launch on its
    own stream, beside the sim kernels on the same rows: the
    kernels-line entries."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    n = 8
    chunk = MAIN_BYTES // 4 // n
    xs, rows = _rank_inputs(n, chunk, "float32")
    w = _loopback_world(xs, chunk)
    scale = pr.mean_scale(n, torch.float32)
    parts = _rank_parts(xs, chunk)

    def rs():
        _on_streams(w, lambda r: pr.peer_reduce_scatter(
            parts[r], r, scale=scale, out=w["mids"][r]))

    def ag():
        _on_streams(w, lambda r: pr.peer_all_gather_push(
            w["mids"][r], w["outs"], r))

    def ag_pull():
        _on_streams(w, lambda r: pr.peer_all_gather(w["mids"], r,
                                                    out=w["outs"][r]))

    def barrier():
        _on_streams(w, lambda r: pr.peer_barrier(w["pads"], w["gens"][r], r))

    def plain_rs():
        _on_streams(w, lambda r: pr.peer_reduce_scatter_plain(parts[r], r,
                                                              scale))

    def plain_ag():
        _on_streams(w, lambda r: pr.peer_all_gather_push_plain(
            w["mids"][r], w["outs"], r))

    rs()
    ag()
    torch.cuda.synchronize()
    red = pr.direct_reduce_scatter(rows, scale=scale)
    rs_err = check_exact("loopback at 8 x 256 MiB: reduce-scatter",
                         torch.stack(list(w["mids"])), red)
    gathered = pr.direct_all_gather(red)
    ag_err = check_exact("loopback at 8 x 256 MiB: gather (push)",
                         torch.stack(w["outs"]), gathered)
    for o in w["outs"]:
        o.zero_()
    ag_pull()
    torch.cuda.synchronize()
    check_exact("loopback at 8 x 256 MiB: gather (pull)",
                torch.stack(w["outs"]), gathered)
    del gathered
    isz = 4
    data_bound = _bound((n * n * chunk + n * chunk) * isz, n * n * chunk)
    gather_bound = _bound((n * chunk + n * n * chunk) * isz, 0)
    sim_rs = cuda_ms(lambda: pr.direct_reduce_scatter(rows, scale=scale), 10)
    sim_ag = cuda_ms(lambda: pr.direct_all_gather(red), 10)
    eager_rounds, eager_warmup = 200, 5
    barrier_ms = cuda_ms(barrier, eager_rounds, warmup=eager_warmup)
    barrier_graph_ms = _barrier_graph_ms(w, "all")
    # every timed barrier met every rank: the pads and generations count
    # them, and one more round equals its plain version
    barrier_err = _check_barriers(
        w, eager_warmup + eager_rounds + (2 + 20) * GRAPH_LAUNCHES,
        "loopback at 8 ranks, after the timed barriers")
    source = "tpu_perf_torch/csrc/peer_collectives.cu"
    # the tiled reduce-scatter (pl_reduce_scatter's carry in the kernel)
    # into each rank's whole buffer
    full = [torch.empty_like(x) for x in xs]

    def rs_tiled():
        _on_streams(w, lambda r: pr.peer_reduce_scatter(
            parts[r], r, scale=scale, tiles=n, out=full[r]))

    rs_tiled()
    torch.cuda.synchronize()
    tiled_err = check_exact(
        "loopback at 8 x 256 MiB: tiled reduce-scatter", torch.stack(full),
        pr.direct_reduce_scatter(rows, scale=scale, tiles=n))
    tiled = {"tiled_ms": cuda_ms(rs_tiled, 10),
             "tiled_plain_ms": cuda_ms(lambda: _on_streams(
                 w, lambda r: pr.peer_reduce_scatter_plain(
                     parts[r], r, scale, n)), 3, 1),
             "tiled_bound_ms": _bound(2 * n * n * chunk * isz,
                                      n * n * chunk)["bound_ms"],
             "tiled_max_abs_err": tiled_err}
    entries = [
        {"name": "peer_reduce_scatter", "route": "cuda", "source": source,
         "replaces": "tpu_perf/ops/pallas_ring.py:599", "max_abs_err": rs_err,
         "ms": cuda_ms(rs, 10), "plain_ms": cuda_ms(plain_rs, 3, 1),
         **data_bound, "library_call": "view(n,n,c).sum(0)",
         "library_ms": cuda_ms(lambda: rows.view(n, n, chunk).sum(0), 10),
         "sim_kernel_ms": sim_rs, **tiled},
        {"name": "peer_all_gather", "route": "cuda", "source": source,
         "replaces": "tpu_perf/ops/pallas_ring.py:481", "max_abs_err": ag_err,
         "ms": cuda_ms(ag, 10), "plain_ms": cuda_ms(plain_ag, 3, 1),
         **gather_bound, **_gather_calls(w, w["mids"], red, ag_pull),
         "sim_kernel_ms": sim_ag},
        {"name": "peer_barrier", "route": "cuda", "source": source,
         "replaces": "tpu_perf/ops/pallas_ring.py:278",
         "max_abs_err": barrier_err, "ms": barrier_ms, "plain_ms": cuda_ms(
             lambda: [pr.peer_barrier_plain(w["pads"], w["gens"][r], r)
                      for r in range(n)], 20),
         **_bound(2 * n * n * 4, 0), "library_ms": None,
         "graph_ms": barrier_graph_ms},
    ]
    new, set_graph_ms = _loopback_timing_new(w, xs, rows, full, red, source)
    # the barrier's other sets, from graphs: modes of its row
    barrier_row, = (k for k in entries if k["name"] == "peer_barrier")
    barrier_row.update(set_graph_ms)
    entries += new
    torch.cuda.synchronize()
    for k in entries:
        k.pop("bytes")
        k.pop("ops")
    return entries


def _gather_calls(w, mids, red, pull) -> dict:
    """A peer gather's yardsticks at the loopback's ranks: the expand copy
    of the stacked owned chunks (one call for every rank's output, the
    library call), ``torch.cat`` of the owned chunks on every rank's
    stream, and the pull gather (``pull()``)."""
    import torch

    n = w["n"]
    return {
        "library_call": "reshape(1,-1).expand(n,-1).contiguous()",
        "library_ms": cuda_ms(
            lambda: red.reshape(1, -1).expand(n, -1).contiguous(), 10),
        "cat_ms": cuda_ms(lambda: _on_streams(
            w, lambda r: torch.cat(list(mids))), 10),
        "pull_ms": cuda_ms(pull, 10)}


def _barrier_graph_ms(w, peers: str, copies=None) -> float:
    """The barrier's device time at the loopback's ranks: each rank's graph
    of GRAPH_LAUNCHES chained barriers of set ``peers`` (with its tail
    copy), captured on its stream, all replayed together twice to warm
    up and 20 times timed: the time a barrier."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    graphs = []
    for r, s in enumerate(w["streams"]):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            for _ in range(GRAPH_LAUNCHES):
                pr.peer_barrier(w["pads"], w["gens"][r], r, peers=peers,
                                copy=None if copies is None else copies[r])
        graphs.append(g)
    return cuda_ms(lambda: _on_streams(w, lambda r: graphs[r].replay()), 20,
                   warmup=2) / GRAPH_LAUNCHES


def _loopback_timing_new(w, xs, rows, full, red,
                         source: str) -> tuple[list[dict], dict]:
    """This slice's kernels at 8 ranks x MAIN_BYTES: the ring's and the
    exchange's copies, a pingpong execution (two pair barriers and its
    pushed legs, as the step runs it), the all-to-all (pushed, and
    pulled beside it), the bidirectional gather of the owned chunks, and
    pl_barrier's barrier with its tail copy,
    each first held against the sim kernel's function on the same rows,
    its max abs err on its row; returns those rows and the ring and pair
    barriers' times from graphs."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    n, chunk, isz = w["n"], w["chunk"], 4
    elems = n * chunk
    half = n // 2
    parts = _rank_parts(xs, chunk)
    idx = torch.arange(n, device=rows.device)
    move_bound = _bound(2 * n * elems * isz, 0)
    stage = [torch.empty_like(x) for x in xs]
    w["pads"], w["gens"] = _pads(n, xs[0].device)

    def copies(name, shift):
        return lambda: _on_streams(w, lambda r: pr.peer_copy(
            name, xs[(r - shift) % n], out=full[r]))

    def plain_copies(name, shift):
        return lambda: _on_streams(w, lambda r: pr.peer_copy_plain(
            name, xs[(r - shift) % n]))

    def pingpong():
        # leg 1 pushed by group 0 under group 1's local copy, leg 2 pushed
        # back by group 1
        def one(r):
            pr.peer_barrier(w["pads"], w["gens"][r], r, peers="pair")
            pr.peer_copy("peer_pingpong", xs[r],
                         out=stage[r + half] if r < half else full[r])
            pr.peer_barrier(w["pads"], w["gens"][r], r, peers="pair")
            if r >= half:
                pr.peer_copy("peer_pingpong", stage[r], out=full[r - half])

        _on_streams(w, one)

    def plain_pingpong():
        _on_streams(w, lambda r: pr.peer_copy_plain(
            "peer_pingpong", xs[r], stage[r + half] if r < half else full[r]))
        _on_streams(w, lambda r: pr.peer_copy_plain(
            "peer_pingpong", stage[r], full[r - half]) if r >= half else None)

    entries = []
    for name, replaces, shift in (("peer_ring", 345, 1),
                                  ("peer_exchange", 365, half)):
        copies(name, shift)()
        torch.cuda.synchronize()
        # the library's row gather takes an index made outside its timing
        perm = (idx - shift) % n
        err = check_exact(f"loopback at 8 x 256 MiB: {name}",
                          torch.stack(full), rows[perm])
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"tpu_perf/ops/pallas_ring.py:{replaces}",
            "max_abs_err": err, "ms": cuda_ms(copies(name, shift), 10),
            "plain_ms": cuda_ms(plain_copies(name, shift), 3, 1),
            **move_bound, "library_call": "x[idx]",
            "library_ms": cuda_ms(lambda perm=perm: rows[perm], 10),
            "sim_kernel_ms": cuda_ms(
                (lambda: pr.ring_shift(rows)) if name == "peer_ring"
                else (lambda: pr.pair_exchange(rows)), 10)})
    pingpong()
    torch.cuda.synchronize()
    pp_err = check_exact("loopback at 8 x 256 MiB: a pingpong execution",
                         torch.stack(full), rows)
    entries.append({
        "name": "peer_pingpong", "route": "cuda", "source": source,
        "replaces": "tpu_perf/ops/pallas_ring.py:385", "max_abs_err": pp_err,
        "ms": cuda_ms(pingpong, 10), "plain_ms": cuda_ms(plain_pingpong, 3, 1),
        **move_bound, "library_call": "x.clone()",
        "library_ms": cuda_ms(rows.clone, 10),
        # the legs' schedule: three copies of half the ranks' buffers
        "schedule_bound_ms": _bound(3 * half * 2 * elems * isz, 0)["bound_ms"],
        "sim_kernel_ms": cuda_ms(lambda: pr.pingpong(rows), 10)})

    full_parts = pr.PeerParts(full)

    def a2a():
        _on_streams(w, lambda r: pr.peer_all_to_all_push(xs[r], full_parts,
                                                         r))

    def a2a_pull():
        _on_streams(w, lambda r: pr.peer_all_to_all(parts[r], r, out=full[r]))

    for launch, how in ((a2a_pull, "pulled"), (a2a, "pushed")):
        for o in full:
            o.zero_()
        launch()
        torch.cuda.synchronize()
        a2a_err = check_exact(f"loopback at 8 x 256 MiB: peer_all_to_all "
                              f"{how}", torch.stack(full), pr.all_to_all(rows))
    entries.append({
        "name": "peer_all_to_all", "route": "cuda", "source": source,
        "replaces": "tpu_perf/ops/pallas_ring.py:291", "max_abs_err": a2a_err,
        "ms": cuda_ms(a2a, 10), "pull_ms": cuda_ms(a2a_pull, 10),
        "plain_ms": cuda_ms(lambda: _on_streams(
            w, lambda r: pr.peer_all_to_all_push_plain(
                xs[r], full_parts, r)), 3, 1),
        **move_bound,
        "library_ms": cuda_ms(lambda: rows.view(n, n, chunk).transpose(
            0, 1).contiguous(), 10),
        "sim_kernel_ms": cuda_ms(lambda: pr.all_to_all(rows), 10)})
    mids = pr.PeerParts(red[r].clone() for r in range(n))
    dsts = pr.PeerParts(full)

    def bidir():
        _on_streams(w, lambda r: pr.peer_all_gather_push(
            mids[r], dsts, r, bidir=True))

    def bidir_pull():
        _on_streams(w, lambda r: pr.peer_all_gather_bidir(mids, r,
                                                          out=full[r]))

    gathered = pr.direct_all_gather(red)
    for launch, how in ((bidir_pull, "pull"), (bidir, "push")):
        for o in full:
            o.zero_()
        launch()
        torch.cuda.synchronize()
        bidir_err = check_exact("loopback at 8 x 256 MiB: "
                                f"peer_all_gather_bidir ({how})",
                                torch.stack(full), gathered)
    del gathered
    entries.append({
        "name": "peer_all_gather_bidir", "route": "cuda", "source": source,
        "replaces": "tpu_perf/ops/pallas_ring.py:430",
        "max_abs_err": bidir_err, "ms": cuda_ms(bidir, 10),
        "plain_ms": cuda_ms(lambda: _on_streams(
            w, lambda r: pr.peer_all_gather_push_plain(
                mids[r], dsts, r, bidir=True)), 3, 1),
        **_bound((n * chunk + n * n * chunk) * isz, 0),
        **_gather_calls(w, mids, red, bidir_pull),
        "sim_kernel_ms": cuda_ms(
            lambda: pr.direct_all_gather_bidir(red), 10)})
    # the barriers from graphs: ring and pair sets, and pl_barrier's
    graph_ms, errs = {}, {}
    ones = [(xs[r][:1], full[r][:1]) for r in range(n)]
    for peers, tail in (("ring", None), ("pair", None), ("all", ones)):
        w["pads"], w["gens"] = _pads(n, xs[0].device)
        graph_ms[peers] = _barrier_graph_ms(w, peers, tail)
        errs[peers] = _check_barriers(
            w, (2 + 20) * GRAPH_LAUNCHES,
            f"loopback at 8 ranks: {peers} barriers", peers, tail)
    w["pads"], w["gens"] = _pads(n, xs[0].device)
    copy_eager = cuda_ms(lambda: _on_streams(w, lambda r: pr.peer_barrier(
        w["pads"], w["gens"][r], r, copy=ones[r])), 200, warmup=5)
    entries.append({
        "name": "peer_barrier_copy", "route": "cuda", "source": source,
        "replaces": "tpu_perf/ops/pallas_ring.py:329",
        "max_abs_err": errs["all"],
        "ms": copy_eager, "plain_ms": cuda_ms(
            lambda: [pr.peer_barrier_plain(w["pads"], w["gens"][r], r,
                                           copy=ones[r]) for r in range(n)],
            20),
        **_bound(2 * n * n * 4 + 2 * n * isz, 0), "library_ms": None,
        "graph_ms": graph_ms["all"]})
    return entries, {"ring_graph_ms": graph_ms["ring"],
                     "pair_graph_ms": graph_ms["pair"]}


def loopback() -> None:
    """(d) the peer kernels on one card: n rank buffers as n separate
    allocations, each rank's launch on its own stream, reading its peers
    through the pointer tables; run by phase_distributed in a process of
    its own under a wall-clock limit.  Prints its checks and, last, the
    peer kernels' kernels-line entries."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    cap = pr.peer_barrier_capacity(torch.cuda.current_device())
    if max(LOOPBACK_RANKS) > cap:
        fail(f"loopback: {max(LOOPBACK_RANKS)} waiting barriers do not fit "
             f"the card ({cap} CTAs)")
    t0 = time.perf_counter()
    cases = 0
    for n in LOOPBACK_RANKS:
        for dtype in ("float32", "bfloat16"):
            # a whole number of 16-byte units, and a chunk with a tail
            for chunk in (1 << 16, (1 << 16) + 3):
                _loopback_case(n, dtype, chunk)
                cases += 1
    print(f"{cases} cases at n = {LOOPBACK_RANKS}, float32 and bfloat16, "
          "with and without a tail: the owned chunks and outputs equal the "
          "plain versions (and, in float32, the sim kernels) bit for bit, "
          "pads and generations at 2, a third round of barriers its plain "
          f"version's ({time.perf_counter() - t0:.1f} s; "
          f"the card holds {cap} waiting barriers)")
    t0 = time.perf_counter()
    cases = 0
    for n in LOOPBACK_RANKS:
        for dtype in ("float32", "bfloat16", "int32"):
            # even chunks (16-byte units and a tail), and an odd one
            for chunk in (1 << 16, (1 << 16) + 6, (1 << 16) + 3):
                _loopback_kernels(n, dtype, chunk)
                cases += 1
    print(f"{cases} cases at n = {LOOPBACK_RANKS}, float32, bfloat16 and "
          "int32, even and odd chunks: the copies, the all-to-all, the "
          "bidirectional gather, the tiled reduce-scatter and the ring, "
          "pair and all-rank barriers (with pl_barrier's tail copy) equal "
          f"their plain versions bit for bit ({time.perf_counter() - t0:.1f}"
          " s)")
    for n in LOOPBACK_RANKS:
        _loopback_chain(n, (1 << 16) + 5)
    _loopback_barrier_chains()
    t0 = time.perf_counter()
    cases = 0
    for n in LOOPBACK_RANKS:
        for op in PEER_OPS:
            dtypes = ["float32"]
            if n == 4:
                dtypes += ["bfloat16"] if op in ("pl_allreduce",
                                                 "pl_reduce_scatter") else [
                    "bfloat16", "int32"]
            for dtype in dtypes:
                for nbytes in STEP_BYTES:
                    if op in ("pl_exchange", "pl_pingpong") and n % 2:
                        continue
                    _loopback_steps(n, op, nbytes, dtype)
                    cases += 1
    print(f"{cases} cases of every peer op's own steps at n = "
          f"{LOOPBACK_RANKS} and {STEP_BYTES} B a rank, float32 (and at n = "
          f"4 bfloat16 and int32): {STEP_CHAIN} eager steps and "
          f"{STEP_REPLAYS} replays of each rank's graph of a step equal the "
          f"sim kernels' chain bit for bit ({time.perf_counter() - t0:.1f} s)")
    entries = _loopback_timing()
    for k in entries:
        library = k.get("library_call", "")
        print(f"{k['name']} at 8 x 256 MiB, 8 streams: {k['ms']:.4f} ms "
              f"(sim kernel {k.get('sim_kernel_ms', float('nan')):.4f}), "
              f"plain {k['plain_ms']:.4f}, bound {k['bound_ms']:.4f} ms, "
              f"library {library} {k['library_ms'] or float('nan'):.4f} ms"
              + (f", kernel / library {k['ms'] / k['library_ms']:.4f}"
                 if library else "") + f" ({card_line()})")
        for extra in ("graph_ms", "ring_graph_ms", "pair_graph_ms"):
            if extra in k:
                print(f"{k['name']}: {extra} {k[extra] * 1e3:.3f} us a "
                      "barrier, 8 ranks from graphs of "
                      f"{GRAPH_LAUNCHES} chained barriers a rank")
        if "cat_ms" in k:
            print(f"{k['name']}: torch.cat on every rank's stream "
                  f"{k['cat_ms']:.4f} ms (kernel / cat "
                  f"{k['ms'] / k['cat_ms']:.4f}), expand copy "
                  f"{k['library_ms']:.4f} ms, the pull gather "
                  f"{k['pull_ms']:.4f} ms (push / pull "
                  f"{k['ms'] / k['pull_ms']:.4f})")
        if k["name"] == "peer_all_to_all":
            print(f"{k['name']}: the pull in each rank's order "
                  f"{k['pull_ms']:.4f} ms (push / pull "
                  f"{k['ms'] / k['pull_ms']:.4f})")
        if "tiled_ms" in k:
            print(f"{k['name']} tiled (pl_reduce_scatter): "
                  f"{k['tiled_ms']:.4f} ms, plain {k['tiled_plain_ms']:.4f},"
                  f" bound {k['tiled_bound_ms']:.4f} ms")
        if "schedule_bound_ms" in k:
            print(f"{k['name']}: the legs' schedule bound "
                  f"{k['schedule_bound_ms']:.4f} ms")
    print("LOOPBACK_KERNELS " + json.dumps(entries))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import torch

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()


#: the phase main() is in, and when it began (perf_counter seconds)
PHASE = ["setup", 0.0]


def main() -> int:
    """Every phase, then the kernels' JSON line and the ok line.  A phase
    that raises ends the run: one ``chip_smoke: FAILED in phase <name>
    after <s> s: <type>: <message>`` line on stdout, the traceback (and
    the message whole, with any child process's stderr tail) on stderr,
    exit code 1 and no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    PHASE[:] = ["setup", time.perf_counter()]
    try:
        return _main(torch)
    except Exception as e:  # noqa: BLE001 — named, then the run fails
        import traceback

        name, t0 = PHASE
        first = str(e).strip().splitlines()[0] if str(e).strip() else ""
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        print(f"chip_smoke: FAILED in phase {name} after "
              f"{time.perf_counter() - t0:.1f} s: {type(e).__name__}: "
              f"{first[:600]}", flush=True)
        return 1


def _main(torch) -> int:
    # the port itself; in a directory without the repository this import
    # fails and the script exits non-zero before printing any result
    import tpu_perf_torch  # noqa: F401

    smi = card_line()
    print(smi)
    global CARD
    CARD = smi
    # the card's published rates, for every bound below; a card the port's
    # table does not hold fails here
    hbm, f32 = card_rates()
    print(f"card rates: {hbm / 1e12:g} TB/s device memory, {f32 / 1e12:g} "
          "TFLOP/s float32 (tpu_perf_torch.chips)")
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn):
        PHASE[:] = [name, time.perf_counter()]
        result = fn()
        phase_s[name] = round(time.perf_counter() - PHASE[1], 1)
        PHASE[:] = ["kernels", time.perf_counter()]
        return result

    global REPORT_DIR
    import shutil
    import tempfile

    REPORT_DIR = tempfile.mkdtemp(prefix="chip_smoke-report-")
    try:
        designs = timed("build", phase_build)
        timed("check", phase_check)
        launches = timed("paths", phase_main_path)
        timed("fused", phase_fused)
        timed("fences", phase_fences)
        timed("profile", phase_profile)
        timed("daemon", phase_daemon)
        timed("health", phase_health)
        timed("report", phase_report)
        timed("surface", phase_surface)
        timed("compute", phase_compute)
        timed("streams", phase_streams)
        timed("bench", phase_bench)
        timed("adaptive", phase_adaptive)
        timed("pipeline", phase_pipeline)
        timed("contend", phase_contend_axes)
        _, peer_rows = timed("distributed", phase_distributed)
    finally:
        shutil.rmtree(REPORT_DIR, ignore_errors=True)
    timed("selftest", phase_selftest)
    timed("grid", phase_grid)
    for label, per_rank in (("4MiB", HEADLINE_BYTES), ("256MiB", MAIN_BYTES)):
        rows = _kernel_rows(per_rank, launches, designs)
        for k in rows:
            print(f"kernel @{label}/rank: {k['name']} {k['shape']}: "
                  f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
                  f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
                  f"({k['bound_by']}: {k['bytes']} B at {hbm / 1e12:g} TB/s, "
                  f"{k['ops']} f32 ops at {f32 / 1e12:g} TFLOP/s), "
                  f"{k['bound_ms'] / k['ms']:.1%} of bound")
            if "tiled_ms" in k:
                print(f"kernel @{label}/rank: {k['name']} tiled (n tiles a "
                      f"row): {k['tiled_ms']:.4f} ms, plain "
                      f"{k['tiled_plain_ms']:.4f} ms, bound "
                      f"{k['tiled_bound_ms']:.4f} ms, "
                      f"{k['tiled_bound_ms'] / k['tiled_ms']:.1%} of bound; "
                      "carries: pl_reduce_scatter "
                      f"{k['pl_reduce_scatter_carry_ms']:.4f} ms (before: "
                      f"scale and repeat after the kernel "
                      f"{k['pl_reduce_scatter_carry_before_ms']:.4f}), "
                      f"pl_allreduce {k['pl_allreduce_carry_ms']:.4f} ms "
                      "(before: mul_ after the gather "
                      f"{k['pl_allreduce_carry_before_ms']:.4f})")
            if "schedule_bound_ms" in k:
                print(f"kernel @{label}/rank: {k['name']}: the schedule "
                      f"moves {k['schedule_bytes']} B, bound "
                      f"{k['schedule_bound_ms']:.4f} ms, "
                      f"{k['schedule_bound_ms'] / k['ms']:.1%} of it")
            if "roll_ms" in k:
                print(f"kernel @{label}/rank: {k['name']}: library is the row "
                      f"gather x[idx]; x.index_select(0, idx) "
                      f"{k['index_select_ms']:.4f} ms, torch.roll "
                      f"{k['roll_ms']:.4f} ms")
            if "designs_ms" in k:
                print(f"kernel @{label}/rank: {k['name']}: broadcast copy_ "
                      f"into a preallocated output {k['copy_broadcast_ms']:.4f}"
                      f" ms; pl_all_gather's own-shard carry after it "
                      f"{k['carry_ms']:.4f} ms; designs " + ", ".join(
                          f"{d} {ms:.4f}" for d, ms in k["designs_ms"].items()))
            if "graph_ms" in k and "empty_launch_ms" not in k:
                print(f"kernel @{label}/rank: {k['name']}: from a CUDA graph "
                      f"of {GRAPH_LAUNCHES} chained launches "
                      f"{k['graph_ms']:.4f} ms per launch")
            if "empty_launch_ms" in k:
                print(f"kernel @{label}/rank: {k['name']} {k['shape']}: "
                      f"{k['ms'] * 1e3:.2f} us per launch (the C entry alone "
                      f"{k['launch_ms'] * 1e3:.2f} us), an empty kernel's "
                      f"launch {k['empty_launch_ms'] * 1e3:.2f} us, x.clone() "
                      f"{k['library_ms'] * 1e3:.2f} us (one stream, "
                      f"back to back); from a CUDA graph of "
                      f"{GRAPH_LAUNCHES}: {k['graph_ms'] * 1e3:.3f} us per "
                      f"barrier, {k['empty_launch_graph_ms'] * 1e3:.3f} us "
                      "per empty launch")
    for k in peer_rows:
        print(f"kernel @256MiB/rank: {k['name']} (8 ranks, one stream "
              f"each, loopback): {k['ms']:.4f} ms, "
              f"{k['launches_per_execution']:g} launches an execution "
              f"({k['launches']} on the main path: the world of one's "
              f"runs and the IPC worlds' steps), bound "
              f"{k['bound_ms']:.4f} ms; the sim kernel "
              f"{k.get('sim_kernel_ms', float('nan')):.4f} ms")
    print(f"total: {time.perf_counter() - t_start:.1f} s (phases {phase_s}), "
          f"card: {smi}")
    # the JSON line reports the main path's largest shape, the last rows,
    # and the peer kernels at 8 ranks x 256 MiB
    for k in rows:
        for extra in ("shape", "dtype", "bytes", "ops", "schedule_bytes"):
            k.pop(extra, None)
    print(json.dumps({"kernels": rows + peer_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
