"""Time the designs of the peer kernels and of the push steps' last
executions, on one card or, under torchrun, across the cards of a host.

Run from the repository root on a machine with NVIDIA Hopper GPUs::

    python -m tpu_perf_torch.tools.peer_designs [--parts reduce,barrier,steps]
        [--reduce 1x4,2x2] [--tma 4096x2,8192x2] [--reps 10] [--rounds 3]
    python -m tpu_perf_torch.tools.peer_designs --parts a2a,pingpong,steps
    torchrun --nproc-per-node 4 -m tpu_perf_torch.tools.peer_designs \
        --parts a2a,pingpong,steps

On one card the ranks are a loopback (every rank's buffers its own
allocations, every rank's launch on its own stream); under torchrun each
process is a rank on card ``LOCAL_RANK`` of an NCCL world, its buffers
opened by its peers through CUDA IPC, and only the parts a2a, pingpong
and steps run.

1. Writes each design's copy of ``csrc/peer_collectives.cu`` (with the
   shared headers) under ``tpu_perf_torch/_build/peer_designs/`` and
   builds them, one nvcc each, all started together (printing what
   ``-Xptxas -v`` says): the barrier variants of :data:`BARRIER_DESIGNS`;
   the reduce-scatter at each ``--reduce`` units x
   CTAs an SM (``kReduceUnits``, 16-byte units a thread in flight from
   each peer, the tile being 256 threads x units x 16 bytes, and
   ``kCtasPerSm`` of ``csrc/row_copy.cuh``), the shipped one with plain
   stores in place of its streaming ones (``plain stores``), with
   evict-first or non-coherent loads (``loads cs``, ``loads nc``), and
   the TMA design below at each ``--tma`` span x stages.
2. In the one-card loopback of the paths' largest point, 8 ranks x 256
   MiB float32 (each rank's input its own allocation, each rank's launch
   on its own stream), checks every design's output against the shipped
   kernel's bit for bit, then times in turns, ``--rounds`` times: each
   design scaled by 1/n (``pl_allreduce``'s call) and tiled n times
   (``pl_reduce_scatter``'s), with ``view(n, n, c).sum(0)`` over the
   stacked inputs.
3. ``barrier``: in one-card loopbacks of 1, 2 and 8 ranks (a stream a
   rank), each rank's CUDA graph of ``--launches`` chained all-rank
   barriers of every variant, and of as many empty launches (the floor),
   all replayed together, in turns, ``--rounds`` times: the time a
   barrier; every variant's pads and generations must count its rounds.
4. ``steps``: ``pl_allreduce``, ``pl_all_gather``, ``pl_all_to_all``
   and ``pl_pingpong`` at -i 5 (8 ranks in the loopback, the world's
   ranks across cards) at 4 KiB and 256 MiB a rank, each rank's step a
   CUDA graph, as shipped and with the other way of the last execution
   (an edit of ``ops/pallas_ring.py``, :data:`STEP_DESIGNS`: pulling into
   a new tensor, or pushing and returning a copy), each output held to
   the sim kernels' step first: the time an execution.
5. ``a2a``: the all-to-all at 256 MiB and 4 KiB a rank: the push
   (``peer_all_to_all_push``) and the pull over chunk d of every rank's
   input in its three tile orders (:data:`PULL_DESIGNS`: the shipped
   source and edits of it), each output first held bit for bit to the
   sim ``all_to_all``; across cards beside NCCL's ``all_to_all_single``.
6. ``pingpong``: an execution of each schedule of :data:`PINGPONG_DESIGNS`
   (pair barrier, leg 1, pair barrier, leg 2) at 256 MiB and 4 KiB a
   rank, each first held bit for bit (every rank's output its input,
   group 1's stage its partner's input), across cards beside NCCL's
   isend / irecv there and back; and at 256 MiB the parts one by one:
   each leg, pulled and pushed, group 1's local copy, a pair barrier.

Each time is the mean device time of ``--reps`` back-to-back executions
(every rank's launch, or every rank's graph) between two CUDA events;
across cards every rank starts after a host barrier and the slowest
rank's time is kept.  Prints the card's name and power limit (every
card's across cards), one line per measurement, and a JSON summary as
the last line (rank 0 alone across cards).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from tpu_perf_torch.tools.row_copy_designs import (
    CTAS_PER_SM, cuda_ms, finish_variants, start_variants, write_design,
)

MIB = 1024**2
SOURCE = "peer_collectives.cu"

#: The TMA design of the reduce-scatter (float32 only): a persistent grid
#: draws tiles of PEER_TMA_SPAN bytes of the owned chunk in order from the
#: same counters; one thread of each CTA arms a stage's mbarrier with the n
#: spans' bytes and issues n bulk loads (one a peer, in ring order) into
#: it, PEER_TMA_STAGES stages ahead; every thread sums its 16-byte units of
#: the stage's n spans in ring order, scales, and stores the unit and its
#: copies evict-first.
TMA_REDUCE = r"""
#include "bulk_copy.cuh"
#include "row_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = PEER_TMA_SPAN;
constexpr int kStages = PEER_TMA_STAGES;
constexpr int kMaxRanks = 64;

__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bulk::smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fetch(void* smem, const void* gmem,
                                      uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(bulk::smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(bulk::smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
tma_reduce(const float* const* __restrict__ parts, float* __restrict__ out,
           unsigned int* counters, int n, int rank, long long chunk,
           float scale, int tiles) {
  extern __shared__ __align__(128) uint8_t stage[];  // kStages x n x kSpan
  __shared__ uint64_t bars[kStages];
  __shared__ const float* src[kMaxRanks];
  __shared__ unsigned int tile_of[kStages];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    src[k] = parts[(rank + 1 + k) % n];
  }
  const long long total = chunk * (long long)sizeof(float);
  const unsigned int ntiles = (unsigned int)((total + kSpan - 1) / kSpan);
  auto issue = [&](int k) {
    const unsigned int t = row_copy::draw(counters);
    tile_of[k] = t;
    if (t >= ntiles) return;
    const long long off = (long long)t * kSpan;
    const uint32_t b = total - off < kSpan ? (uint32_t)(total - off) : kSpan;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    expect(&bars[k], b * (uint32_t)n);
    uint8_t* to = stage + (long long)k * n * kSpan;
    for (int p = 0; p < n; ++p) {
      fetch(to + (long long)p * kSpan,
            reinterpret_cast<const uint8_t*>(src[p]) + off, b, &bars[k]);
    }
  };
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) bulk::barrier_init(&bars[k]);
    for (int k = 0; k < kStages; ++k) issue(k);
  }
  __syncthreads();
  const long long units = chunk / 4;
  for (long long it = 0;; ++it) {
    const int k = (int)(it % kStages);
    const unsigned int t = tile_of[k];
    if (t >= ntiles) break;
    bulk::wait(&bars[k], (uint32_t)((it / kStages) & 1));
    const float4* s = reinterpret_cast<const float4*>(
        stage + (long long)k * n * kSpan);
    const long long first = (long long)t * (kSpan / 16);
    for (int u = threadIdx.x; u < kSpan / 16; u += kThreads) {
      const long long i = first + u;
      if (i >= units) break;
      float4 acc = s[u];
      for (int p = 1; p < n; ++p) {
        const float4 v = s[(long long)p * (kSpan / 16) + u];
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
      }
      acc.x = __fmul_rn(acc.x, scale);
      acc.y = __fmul_rn(acc.y, scale);
      acc.z = __fmul_rn(acc.z, scale);
      acc.w = __fmul_rn(acc.w, scale);
      for (int c = 0; c < tiles; ++c) {
        __stcs(reinterpret_cast<float4*>(out + c * chunk) + i, acc);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) issue(k);
  }
  if (threadIdx.x == 0) row_copy::retire(counters);
}

}  // namespace

extern "C" int peer_reduce_scatter(const void* table, void* out,
                                   void* counters, int n, int rank,
                                   long long chunk, int dtype, float scale,
                                   int tiles, int vec, void* stream) {
  if (n < 1 || n > kMaxRanks || dtype != 0 || !vec || tiles < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kStages * n * kSpan;
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        tma_reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tma_reduce,
                                                        kThreads, smem);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (chunk * 4 + kSpan - 1) / kSpan;
  int grid = row_copy::grid_for(ntiles, per_sm * sms, &err);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) grid = 1;
  tma_reduce<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float* const*>(table), static_cast<float*>(out),
      static_cast<unsigned int*>(counters), n, rank, chunk, scale, tiles);
  return (int)cudaGetLastError();
}
"""
#: the shipped constant of csrc/peer_collectives.cu that a design edits
UNITS = "constexpr int kReduceUnits = 1;"
STREAMING_STORE = ("__stcs(reinterpret_cast<uint4*>(out + c * chunk) + i, "
                   "bits);")
PLAIN_STORE = "reinterpret_cast<uint4*>(out + c * chunk)[i] = bits;"
PLAIN_LOAD = "if (i < units) v[g][j] = s[i];"
#: the loads' cache hints: evict-first (ld.global.cs) and non-coherent
LOADS = {
    "cs": ("if (i < units) { const uint4 b = __ldcs(reinterpret_cast<"
           "const uint4*>(s + i)); v[g][j] = *reinterpret_cast<const P*>(&b);"
           " }"),
    "nc": ("if (i < units) { const uint4 b = __ldg(reinterpret_cast<"
           "const uint4*>(s + i)); v[g][j] = *reinterpret_cast<const P*>(&b);"
           " }"),
}


#: the shipped barrier's lines that its variants edit (csrc/
#: peer_collectives.cu, peer_barrier_kernel), and the fences they add
SIGNALS = """  for (int k = threadIdx.x; k < peers; k += blockDim.x) {
    store_release_sys("""
AFTER_WAITS = """  __syncthreads();
  for (long long i = threadIdx.x; i < nbytes; i += blockDim.x)"""
SC_FENCE = "  __threadfence_system();\n"
ACQ_REL_FENCE = '  asm volatile("fence.acq_rel.sys;" ::: "memory");\n'
SLEEP = "      __nanosleep(64);\n"
WAIT = """    const unsigned long long t0 = now_ns();
    while ((int)(load_acquire_sys(slot) - g) < 0) {
      if (now_ns() - t0 > kTimeoutNs) __trap();
      __nanosleep(64);
    }
"""
#: the wait with the timer read only once the first probe has failed
WAIT_PROBE_FIRST = """    if ((int)(load_acquire_sys(slot) - g) < 0) {
      const unsigned long long t0 = now_ns();
      while ((int)(load_acquire_sys(slot) - g) < 0) {
        if (now_ns() - t0 > kTimeoutNs) __trap();
        __nanosleep(64);
      }
    }
"""
#: the generation in a register of every thread (shipped), and through
#: shared memory from thread 0 (the earlier kernel)
GENERATION = """  const unsigned int g = *generation + 1u;
  __syncwarp();
  if (threadIdx.x == 0) *generation = g;
"""
GENERATION_SHARED = """  __shared__ unsigned int gen;
  if (threadIdx.x == 0) {
    gen = *generation + 1u;
    *generation = gen;
  }
  __syncthreads();
  const unsigned int g = gen;
"""
SIGNAL_SYS = '"st.release.sys.global.u32 [%0], %1;"'
WAIT_SYS = '"ld.acquire.sys.global.u32 %0, [%1];"'


def _fences(lead: str, trail: str) -> list[tuple[str, str]]:
    # a fence before the signals and one after the waits
    edits = [(SIGNALS, lead + SIGNALS)] if lead else []
    return edits + ([(AFTER_WAITS, trail + AFTER_WAITS)] if trail else [])


#: the barrier's variants: name -> edits of the shipped source (release
#: and acquire at system scope, no fence, the generation in a register).
#: The earlier kernel had a fence.sc.sys on each side and passed the
#: generation through shared memory.  The gpu scope is a yardstick only:
#: it is wrong across two cards.
BARRIER_DESIGNS = {
    "shipped": [],
    "fence.sc.sys before the signals": _fences(SC_FENCE, ""),
    "fence.sc.sys after the waits": _fences("", SC_FENCE),
    "fence.sc.sys before and after, generation through shared memory "
    "(the earlier kernel)": [*_fences(SC_FENCE, SC_FENCE), (GENERATION,
                                              GENERATION_SHARED)],
    "fence.acq_rel.sys before and after": _fences(ACQ_REL_FENCE,
                                                  ACQ_REL_FENCE),
    "poll without nanosleep": [(SLEEP, "")],
    "timer after the first probe": [(WAIT, WAIT_PROBE_FIRST)],
    "generation through shared memory": [(GENERATION, GENERATION_SHARED)],
    "gpu scope (yardstick)": [
        (SIGNAL_SYS, SIGNAL_SYS.replace(".sys", ".gpu")),
        (WAIT_SYS, WAIT_SYS.replace(".sys", ".gpu"))],
}


def barrier_designs(out_dir) -> dict:
    """The barrier variants' sources, ``name -> (source file, defines)``."""
    return {f"barrier {name}": write_design(
        out_dir / f"barrier_{k}", SOURCE, [], source_edits=edits)
        for k, (name, edits) in enumerate(BARRIER_DESIGNS.items())}


#: the push steps' last execution, as edits of ops/pallas_ring.py: op ->
#: (the shipped way, the edited way, edits).  pl_allreduce's last
#: execution pulls the mids into a new tensor; the edit pushes, and the
#: step returns a copy after its last barrier.  pl_all_gather's pushes and
#: returns a copy; the edit pulls every rank's own slot into a new tensor.
ALLREDUCE_LAST_PULL = """\
        if final:
            return peer_all_gather(mids, rank, out=_fresh(world, elems,
                                                          tdtype))
"""
ALLREDUCE_CHAIN = """\
    return _peer_chain(buffers, rank, iters, "all", ins[0][rank].copy_,
                       execution)


def _gloo_path"""
GATHER_PUSH = """\
    def execution(cur, final):
        peer_all_gather_push(gathered[cur][rank][mine]"""
GATHER_LAST_PULL = """\
    owns = [PeerParts(_sub(p, s * chunk, chunk) for s, p in enumerate(parts))
            for parts in gathered]

    def execution(cur, final):
        if final:
            return gather(owns[cur], out=_fresh(world, n * chunk, tdtype))[mine]
        peer_all_gather_push(gathered[cur][rank][mine]"""
GATHER_CHAIN = "gathered[0][rank][mine].copy_, execution, torch.clone)"
#: pl_all_to_all's last execution pulls chunk d of every rank's input
#: into a new tensor; the edit pushes, and the step returns a copy.
A2A_LAST_PULL = """\
        if final:
            return peer_all_to_all(reads[cur], rank,
                                   out=_fresh(world, elems, tdtype))
"""
A2A_CHAIN = """\
    return _peer_chain(buffers, rank, iters, "all", ins[0][rank].copy_,
                       execution)


def _dist_reduce_scatter_step"""
#: pl_pingpong's last execution pulls leg 2 into a new tensor; the edit
#: pushes it into group 0's input buffer, and group 0's step returns a
#: copy
PINGPONG_OUT = """\
        out = _fresh(world, elems, tdtype) if final else ins[1 - cur][rank]
"""
PINGPONG_LEG2 = """\
        if group1 and not final:
            peer_copy("peer_pingpong", stage[rank], out=ins[1 - cur][partner])
        elif not group1 and final:
            peer_copy("peer_pingpong", stage[partner], out=out)
"""
PINGPONG_CHAIN = """\
    return _peer_chain(buffers, rank, iters, "pair", ins[0][rank].copy_,
                       execution)
"""
STEP_DESIGNS = {
    "pl_allreduce": ("last pull", "last copy", [
        (ALLREDUCE_LAST_PULL, ""),
        (ALLREDUCE_CHAIN, ALLREDUCE_CHAIN.replace(
            "execution)", "execution, torch.clone)"))]),
    "pl_all_gather": ("last copy", "last pull", [
        (GATHER_PUSH, GATHER_LAST_PULL),
        (GATHER_CHAIN, GATHER_CHAIN.replace(", torch.clone", ""))]),
    "pl_all_to_all": ("last pull", "last copy", [
        (A2A_LAST_PULL, ""),
        (A2A_CHAIN, A2A_CHAIN.replace("execution)",
                                      "execution, torch.clone)"))]),
    "pl_pingpong": ("last pull", "last copy", [
        (PINGPONG_OUT, """\
        out = (_fresh(world, elems, tdtype) if final and group1
               else ins[1 - cur][rank])
"""),
        (PINGPONG_LEG2, """\
        if group1:
            peer_copy("peer_pingpong", stage[rank], out=ins[1 - cur][partner])
"""),
        (PINGPONG_CHAIN, PINGPONG_CHAIN.replace("execution)", """execution,
                       None if group1 else torch.clone)"""))]),
}


def step_designs(out_dir) -> dict:
    """Each op's edited copy of ``ops/pallas_ring.py`` (every edit of
    :data:`STEP_DESIGNS` made exactly once), written to ``out_dir``: op ->
    its path."""
    from tpu_perf_torch.ops import pallas_ring

    shipped = Path(pallas_ring.__file__).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    found = {}
    for op, (_, _, edits) in STEP_DESIGNS.items():
        text = shipped
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"pallas_ring.py holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        found[op] = out_dir / f"steps_{op}.py"
        found[op].write_text(text)
    return found


def load_steps(path):
    """The module an edited copy of ``ops/pallas_ring.py`` makes, imported
    under a name of its own (its tile counters and pointer tables are its
    own; the kernels and their counts are the package's)."""
    name = f"tpu_perf_torch.tools._peer_designs_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def designs(out_dir, reduce: str, tma: str = "") -> dict:
    """The designs' sources, ``name -> (source file, defines)``."""
    found = {}
    for hint, load in LOADS.items():
        found[f"reduce loads {hint}"] = write_design(
            out_dir / f"reduce_{hint}", SOURCE, [],
            source_edits=[(PLAIN_LOAD, load)])
    for spec in filter(None, tma.split(",")):
        span, stages = spec.split("x")
        found[f"reduce tma span {span} stages {stages}"] = write_design(
            out_dir / f"tma_{spec}", TMA_REDUCE, [],
            [f"PEER_TMA_SPAN={span}", f"PEER_TMA_STAGES={stages}"])
    for spec in reduce.split(","):
        units, cap = spec.split("x")
        found[f"reduce units {units} ctas/sm {cap}"] = write_design(
            out_dir / f"reduce_{spec}", SOURCE,
            [(CTAS_PER_SM, f"constexpr int kCtasPerSm = {cap};")],
            source_edits=[(UNITS, f"constexpr int kReduceUnits = {units};")])
    found["reduce plain stores"] = write_design(
        out_dir / "reduce_plain", SOURCE, [],
        source_edits=[(STREAMING_STORE, PLAIN_STORE)])
    return found


#: the shipped pull's tile order (csrc/peer_collectives.cu, peer_gather)
#: and the edits that give the others: whole-chunk pulls take the sources
#: fastest from the rank on, or the pages fastest from the rank on, or
#: the pages fastest from rank 0 on, the address order (the earlier pull)
RANKS_FASTEST = "  const bool ranks_fastest = push || halves == 1;"
PULL_SOURCE = ("          const int s = halves == 1 ? ahead : "
               "(h == 0 ? behind : ahead);")
PAGES_FASTEST = (RANKS_FASTEST, "  const bool ranks_fastest = push;")
PULL_DESIGNS = {
    "pull, sources fastest from the rank on (shipped)": [],
    "pull, pages fastest from the rank on": [PAGES_FASTEST],
    "pull, pages fastest in address order (earlier)": [
        PAGES_FASTEST, (PULL_SOURCE, PULL_SOURCE.replace(
            "halves == 1 ? ahead", "halves == 1 ? (int)k"))],
}


def pull_designs(out_dir) -> dict:
    """The pull's edited sources, ``name -> (source file, defines)``."""
    return {name: write_design(out_dir / f"pull_{k}", SOURCE, [],
                               source_edits=edits)
            for k, (name, edits) in enumerate(PULL_DESIGNS.items()) if edits}


def _on_streams(streams, launch) -> None:
    # launch(r) on each rank's stream, forked from and joined to the
    # current one
    import torch

    main_stream = torch.cuda.current_stream()
    for s in streams:
        s.wait_stream(main_stream)
    for r, s in enumerate(streams):
        with torch.cuda.stream(s):
            launch(r)
    for s in streams:
        main_stream.wait_stream(s)


def _graphs(streams, launch, count: int) -> list:
    # each rank's CUDA graph of `count` launch(r), captured on its stream
    import torch

    graphs = []
    for r, s in enumerate(streams):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            for _ in range(count):
                launch(r)
        graphs.append(g)
    return graphs


def _entries(libs: dict, symbol: str) -> dict:
    # each design's C entry `symbol` of peer_collectives, from its library
    from tpu_perf_torch.kernels import _build

    main_symbol, main_argtypes = _build._ENTRIES["peer_collectives"]
    argtypes = (main_argtypes if symbol == main_symbol
                else _build._EXTRA_ENTRIES[("peer_collectives", symbol)])
    entries = {}
    for name, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def time_barriers(entries: dict, args, say, results) -> None:
    """Each variant's time a barrier from graphs in loopbacks of 1, 2 and
    8 ranks, beside an empty launch's; then every variant's pads and
    generations must count every barrier it ran."""
    import torch

    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops import pallas_ring as pr

    dev = torch.device("cuda", torch.cuda.current_device())
    empty = _build.entry("barrier", "empty_launch")
    for n in (1, 2, 8):
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        cases, state = {}, {}
        for name, entry in entries.items():
            pads = pr.PeerParts(torch.zeros(n, dtype=torch.int32, device=dev)
                                for _ in range(n))
            gens = [torch.zeros(1, dtype=torch.int32, device=dev)
                    for _ in range(n)]

            def one(r, entry=entry, pads=pads, gens=gens, name=name):
                _build.check(name, entry(
                    pads.table.data_ptr(), gens[r].data_ptr(), n, r, 0, None,
                    None, 0, pr._stream_of(gens[r])))

            state[name] = (pads, gens)
            cases[name] = _graphs(streams, one, args.launches)
        cases["empty_launch"] = _graphs(
            streams, lambda r: _build.check("empty_launch", empty(
                torch._C._cuda_getCurrentRawStream(dev.index))),
            args.launches)
        what = f"barrier from graphs, {n} ranks"
        for rd in range(args.rounds):
            for name, graphs in cases.items():
                ms = cuda_ms(lambda g=graphs: _on_streams(
                    streams, lambda r: g[r].replay()), args.reps)
                us = ms * 1e3 / args.launches
                results.setdefault(what, {}).setdefault(name, []).append(us)
                say(f"{what} round {rd}: {name} {us:.3f} us a barrier")
        torch.cuda.synchronize()
        count = args.rounds * (args.reps + 1) * args.launches
        for name, (pads, gens) in state.items():
            got = torch.cat([*pads, *gens])
            if not bool((got == count).all()):
                raise RuntimeError(f"{what}: {name} counts {got.tolist()}, "
                                   f"want {count}")


class Ranks:
    """The ranks this process drives, and how it times them: every rank of
    a one-card loopback, a stream a rank (``worlds`` from
    ``loopback_ranks``), or under torchrun this process' own rank of a
    world across cards (``worlds`` its one DistWorld).  ``ranks[i]`` is
    the i-th driven rank's world."""

    def __init__(self, worlds: list):
        import torch

        self.worlds = worlds
        self.n = worlds[0].n
        self.device = worlds[0].device
        self.across = worlds[0].peer_memory is None
        self.streams = [torch.cuda.Stream(self.device) for _ in worlds]

    def __iter__(self):
        return iter(self.worlds)

    def each(self, launch) -> None:
        """``launch(i, rank)`` for each driven rank on its stream, forked
        from and joined to the current one."""
        _on_streams(self.streams,
                    lambda i: launch(i, self.worlds[i].rank))

    def sync(self) -> None:
        """The card idle, and across cards every rank's too."""
        import torch

        torch.cuda.synchronize(self.device)
        if self.across:
            import torch.distributed as dist

            dist.barrier()
            torch.cuda.synchronize(self.device)

    def ms(self, fn, reps: int) -> float:
        """Device ms a call of ``fn`` (after one warm call): the mean of
        ``reps`` back-to-back calls, the slowest rank's across cards."""
        import torch

        if not self.across:
            return cuda_ms(fn, reps)
        import torch.distributed as dist

        fn()
        self.sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize(self.device)
        t = torch.tensor([e0.elapsed_time(e1) / reps], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def timed(self, launch, count: int, reps: int) -> float:
        """Device ms a ``launch(i, rank)`` of every driven rank: each
        rank's CUDA graph of ``count`` launches (captured on its stream
        after one eager launch of every rank) replayed together."""
        self.each(launch)
        self.sync()
        graphs = _graphs(self.streams, lambda i: launch(
            i, self.worlds[i].rank), count)
        ms = self.ms(lambda: _on_streams(
            self.streams, lambda i: graphs[i].replay()), reps) / count
        self.sync()
        return ms

    def eager(self, launch, count: int, reps: int) -> float:
        """Device ms a ``launch(i, rank)`` of every driven rank, ``count``
        back to back a call, eagerly (a rank may launch nothing)."""
        ms = self.ms(lambda: self.each(
            lambda i, r: [launch(i, r) for _ in range(count)]), reps) / count
        self.sync()
        return ms

    def check(self, what: str, got: list, want: list) -> None:
        """Each driven rank's ``got[i]`` bit for bit its ``want[i]``."""
        import torch

        self.sync()
        for g, w, world in zip(got, want, self.worlds):
            if not torch.equal(g, w):
                raise RuntimeError(f"{what}: rank {world.rank} is not the "
                                   "plain version's")


def _rows(ranks, elems: int):
    """The sim world's input rows of the ranks (``example_input``) and the
    driven ranks' own rows."""
    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import SimWorld

    rows = example_input(SimWorld(ranks.n, ranks.device), elems, "float32")
    return rows, [rows[w.rank] for w in ranks]


def _turns(ranks, what: str, cases: dict, args, say, results) -> None:
    # every case once a round, --rounds rounds: case() gives its ms
    for rd in range(args.rounds):
        for name, case in cases.items():
            ms = case()
            results.setdefault(what, {}).setdefault(name, []).append(ms)
            say(f"{what} round {rd}: {name} {ms:.4f} ms")


#: the sizes a rank the a2a and pingpong parts time, and the launches (or
#: executions) a graph holds at each
TIMED = ((256 * MIB, 10), (4096, 100))


def time_a2a(ranks, pulls: dict, args, say, results) -> None:
    """The all-to-all's designs at each size of TIMED: the push and each
    pull of ``pulls`` (name -> the design's ``peer_gather_pull`` entry),
    each first held bit for bit to the sim all-to-all's rows; across cards
    NCCL's ``all_to_all_single`` on the same input beside them.  Then
    each pull as the gather's (``pl_allreduce``'s last execution: every
    rank reads the same chunk of every rank), held to the chunks in rank
    order, across cards beside ``all_gather_into_tensor``."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    n = ranks.n
    for nbytes, count in TIMED:
        chunk = nbytes // 4 // n
        elems = n * chunk
        bufs = [pr.PeerBuffers(w, {"x": (elems, torch.float32),
                                   "out": (elems, torch.float32)})
                for w in ranks]
        rows, own = _rows(ranks, elems)
        want = [pr.all_to_all(rows)[w.rank].clone() for w in ranks]
        gathered = [rows[:, :chunk].reshape(-1).clone()] * len(bufs)
        del rows
        for b, w, x in zip(bufs, ranks, own):
            b["x"][w.rank].copy_(x)
        outs = [pr.PeerParts(b["out"]) for b in bufs]
        reads = [pr.PeerParts(pr._sub(p, w.rank * chunk, chunk)
                              for p in b["x"]) for b, w in zip(bufs, ranks)]
        firsts = [pr.PeerParts(pr._sub(p, 0, chunk) for p in b["x"])
                  for b in bufs]
        nb = chunk * 4

        def push(i, r):
            pr.peer_all_to_all_push(bufs[i]["x"][r], outs[i], r)

        def pull(entry, tables):
            def one(i, r):
                out = bufs[i]["out"][r]
                word = pr._widest_word(nb, out.data_ptr(), *(
                    p.data_ptr() for p in tables[i]))
                counters = pr.row_copy_counters("peer_gather", ranks.device)
                pr._build.check("pull design", entry(
                    tables[i].table.data_ptr(), out.data_ptr(),
                    counters.data_ptr(), n, r, nb, 1, word,
                    pr._stream_of(out)))
            return one

        designs = {"push": (push, want),
                   **{name: (pull(e, reads), want)
                      for name, e in pulls.items()},
                   **{f"gather, {name}": (pull(e, firsts), gathered)
                      for name, e in pulls.items()}}
        cases = {}
        for name, (launch, expect) in designs.items():
            ranks.sync()
            for b, w in zip(bufs, ranks):
                b["out"][w.rank].zero_()
            ranks.sync()
            ranks.each(launch)
            ranks.check(f"all-to-all {name} at {nbytes} B a rank",
                        [b["out"][w.rank] for b, w in zip(bufs, ranks)],
                        expect)
            cases[name] = (lambda launch=launch: ranks.timed(
                launch, count, args.reps))
        if ranks.across:
            import torch.distributed as dist

            x, y = own[0].clone(), torch.empty_like(own[0])
            cases["NCCL all_to_all_single"] = lambda: ranks.eager(
                lambda i, r: dist.all_to_all_single(y, x), count, args.reps)
            cases["NCCL all_gather_into_tensor (graph)"] = (
                lambda: ranks.timed(lambda i, r: dist.all_gather_into_tensor(
                    y, x[:chunk]), count, args.reps))
        _turns(ranks, f"all-to-all at {nbytes} B a rank x {n}", cases, args,
               say, results)
        ranks.sync()
        del bufs, outs, reads, firsts


#: the pingpong's schedules: name -> (leg 1, local copy early, leg 2), each
#: leg "pull" or "push"; the local copy is group 1's, under leg 1 (early)
#: or under leg 2
PINGPONG_DESIGNS = {
    "pushed legs, local copy under leg 1 (shipped)": ("push", True, "push"),
    "pulled legs, local copy before the second barrier (earlier)": (
        "pull", True, "pull"),
    "pulled legs, local copy under leg 2": ("pull", False, "pull"),
}


def time_pingpong(ranks, args, say, results) -> None:
    """The pingpong's schedules (:data:`PINGPONG_DESIGNS`) at each size of
    TIMED: an execution a launch (pair barrier, leg 1 and group 1's local
    copy, pair barrier, leg 2), each first held bit for bit; across cards
    NCCL's isend / irecv there and back beside them; at the first size the
    parts one by one (each leg pulled and pushed, the local copy, eagerly;
    a pair barrier from graphs)."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr

    n, half = ranks.n, ranks.n // 2
    for nbytes, count in TIMED:
        elems = nbytes // 4
        bufs = [pr.PeerBuffers(w, {"x": (elems, torch.float32),
                                   "out": (elems, torch.float32),
                                   "stage": (elems, torch.float32)})
                for w in ranks]
        rows, own = _rows(ranks, elems)
        for b, w, x in zip(bufs, ranks, own):
            b["x"][w.rank].copy_(x)
        group1 = [i for i, w in enumerate(ranks) if w.rank >= half]

        def copy(src, dst):
            pr.peer_copy("peer_pingpong", src, out=dst)

        def leg1(i, r, how):
            b = bufs[i]
            if how == "push" and r < half:
                copy(b["x"][r], b["stage"][r + half])
            elif how == "pull" and r >= half:
                copy(b["x"][r - half], b["stage"][r])

        def leg2(i, r, how):
            b = bufs[i]
            if how == "push" and r >= half:
                copy(b["stage"][r], b["out"][r - half])
            elif how == "pull" and r < half:
                copy(b["stage"][r + half], b["out"][r])

        def local(i, r):
            if r >= half:
                copy(bufs[i]["x"][r], bufs[i]["out"][r])

        def barrier(i, r):
            pr.peer_barrier(bufs[i].pads, bufs[i].generation, r, peers="pair")

        def execution(design):
            first, early, second = design

            def one(i, r):
                barrier(i, r)
                leg1(i, r, first)
                if early:
                    local(i, r)
                barrier(i, r)
                leg2(i, r, second)
                if not early:
                    local(i, r)
            return one

        cases = {}
        for name, design in PINGPONG_DESIGNS.items():
            ranks.sync()
            for b, w in zip(bufs, ranks):
                b["out"][w.rank].zero_()
                b["stage"][w.rank].zero_()
            ranks.sync()
            ranks.each(execution(design))
            what = f"pingpong {name} at {nbytes} B a rank"
            ranks.check(what, [b["out"][w.rank] for b, w in zip(bufs, ranks)],
                        own)
            ranks.check(f"{what}: group 1's stage", [
                bufs[i]["stage"][ranks.worlds[i].rank] for i in group1], [
                rows[ranks.worlds[i].rank - half] for i in group1])
            cases[name] = (lambda design=design: ranks.timed(
                execution(design), count, args.reps))
        del rows
        if ranks.across:
            import torch.distributed as dist

            x, y = own[0].clone(), torch.empty_like(own[0])

            def nccl(i, r):
                # group 0 sends and takes it back; group 1 returns it
                legs = (((True, x), (False, y)) if r < half
                        else ((False, y), (True, y)))
                for send, buf in legs:
                    for q in dist.batch_isend_irecv([dist.P2POp(
                            dist.isend if send else dist.irecv, buf,
                            (r + half) % n)]):
                        q.wait()

            cases["NCCL isend / irecv there and back"] = lambda: ranks.eager(
                nccl, count, args.reps)
        if nbytes == TIMED[0][0]:
            for how in ("pull", "push"):
                cases[f"leg 1 alone, {how}ed"] = (
                    lambda how=how: ranks.eager(
                        lambda i, r: leg1(i, r, how), count, args.reps))
                cases[f"leg 2 alone, {how}ed"] = (
                    lambda how=how: ranks.eager(
                        lambda i, r: leg2(i, r, how), count, args.reps))
            cases["group 1's local copy alone"] = lambda: ranks.eager(
                local, count, args.reps)
            cases["a pair barrier alone"] = lambda: ranks.timed(
                barrier, 100, args.reps)
        _turns(ranks, f"pingpong at {nbytes} B a rank x {n}", cases, args,
               say, results)
        ranks.sync()
        del bufs


def time_steps(steps_paths: dict, ranks, args, say, results) -> None:
    """Each op of :data:`STEP_DESIGNS` at -i 5 at 4 KiB and 256 MiB a rank,
    each driven rank's step one CUDA graph, shipped and edited (the
    edited module of ``steps_paths[op]``); each output first held bit for
    bit to its row of the sim kernels' step."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import SimWorld, loopback_ranks

    dev, n, iters = ranks.device, ranks.n, 5
    for op, (shipped, other, _) in STEP_DESIGNS.items():
        modules = {shipped: pr, other: load_steps(steps_paths[op])}
        for nbytes in (4096, 256 * MIB):
            elems, chunk, _ = pr._pallas_sizes(op, n, nbytes, 4)
            sim = SimWorld(n, dev)
            rows = example_input(sim, elems, "float32")
            want = pr.build_pallas_step(op, sim, nbytes, iters)[0](rows)
            want = [want[w.rank].clone() for w in ranks]
            xs = [rows[w.rank].clone() for w in ranks]
            del rows
            cases = {}
            for name, mod in modules.items():
                # each module keeps its own tile counters
                mod.warm_loopback_streams(ranks.streams, dev, n * chunk * 4)
                # a loopback's steps share a memory of their own
                worlds = (ranks.worlds if ranks.across
                          else loopback_ranks(n, dev))
                step = {"pl_allreduce": lambda w: mod._dist_allreduce_step(
                            w, elems, chunk, iters, torch.float32),
                        "pl_all_to_all": lambda w: mod._dist_all_to_all_step(
                            w, elems, chunk, iters, torch.float32),
                        "pl_pingpong": lambda w: mod._dist_pingpong_step(
                            w, elems, iters, torch.float32)}.get(
                    op, lambda w: mod._dist_gather_step(
                        op, w, chunk, iters, torch.float32))
                steps = [step(w) for w in worlds]
                outs = [None] * len(steps)

                def eager(i, r, steps=steps, outs=outs):
                    outs[i] = steps[i](xs[i])

                ranks.each(eager)
                ranks.check(f"{op} at {nbytes} B, {name}: the sim kernels' "
                            "step", outs, want)
                # the graphs replay into the steps' symmetric buffers, which
                # the steps' memory frees with them: a graph kept without
                # its steps writes freed memory (an illegal address)
                graphs = _graphs(ranks.streams, lambda i, steps=steps: steps[
                    i](xs[i]), 1)
                cases[name] = (graphs, steps)
            what = f"{op} at {nbytes} B a rank, {n} ranks, -i {iters}"
            for rd in range(args.rounds):
                for name, (graphs, _) in cases.items():
                    ms = ranks.ms(lambda g=graphs: _on_streams(
                        ranks.streams, lambda i: g[i].replay()),
                        args.reps) / iters
                    results.setdefault(what, {}).setdefault(name, []).append(
                        ms)
                    say(f"{what} round {rd}: {name} {ms:.4f} ms an "
                        "execution")
            ranks.sync()
            del cases


def _smi(index: int | None) -> str:
    # the card's name and power limit (every card's when index is None)
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    if index is not None:
        cmd.append(f"--id={index}")
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="reduce,barrier,steps",
                    help="what to time: reduce, barrier, steps, a2a, "
                    "pingpong (across cards: steps, a2a, pingpong)")
    ap.add_argument("--reduce", default="1x4,1x8,2x2,2x4,4x1,4x2",
                    help="units x CTAs an SM of the reduce-scatter")
    ap.add_argument("--tma", default="4096x2,4096x3,8192x2,2048x4",
                    help="span bytes x stages of the TMA reduce design")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--launches", type=int, default=100,
                    help="barriers in each rank's graph")
    args = ap.parse_args(argv)
    chosen = set(args.parts.split(","))
    unknown = chosen - {"reduce", "barrier", "steps", "a2a", "pingpong"}
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    across = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if across and chosen & {"reduce", "barrier"}:
        ap.error("across cards the parts are steps, a2a and pingpong")
    # one hardware queue a stream, so that no rank's launch queues behind
    # another rank's waiting barrier, and every kernel loaded when its
    # library is (a kernel loaded at its first launch waits for the card,
    # where one rank's barrier waits for a rank not yet enqueued); both
    # read when the card is first used
    os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "32")
    os.environ.setdefault("CUDA_MODULE_LOADING", "EAGER")

    import torch

    if not torch.cuda.is_available():
        print("peer_designs: no CUDA device is visible", file=sys.stderr)
        return 1
    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import SimWorld, dist_world, loopback_ranks

    lead = True
    if across:
        import torch.distributed as dist

        from tpu_perf_torch.parallel import initialize_distributed
        from tpu_perf_torch.parallel.multihost import leave_world

        initialize_distributed(device="cuda")
        lead = dist.get_rank() == 0
    smi = _smi(None if across else torch.cuda.current_device())
    if lead:
        print(smi, flush=True)
    card = smi.splitlines()[0]

    def say(line: str) -> None:
        if lead:
            print(f"{line} ({card})", flush=True)

    out_dir = _build.BUILD_DIR / "peer_designs"
    made = [None]
    if lead:
        # one process writes and builds the designs; the others load them
        shutil.rmtree(out_dir, ignore_errors=True)
        found = designs(out_dir, args.reduce, args.tma) if "reduce" in \
            chosen else {}
        barriers = barrier_designs(out_dir) if "barrier" in chosen else {}
        pulls = pull_designs(out_dir) if "a2a" in chosen else {}
        _build.build_all()
        jobs = start_variants(
            {name: (src, "peer_collectives", defines) for name, (
                src, defines) in {**found, **barriers, **pulls}.items()})
        finish_variants(jobs)
        libs = {name: lib for name, _, lib, _ in jobs}
        made[0] = {
            "reduce": {k: libs[k] for k in found},
            "barrier": {k: libs[k] for k in barriers},
            "a2a": {k: libs[k] for k in pulls},
            "steps": step_designs(out_dir) if "steps" in chosen else {}}
    if across:
        dist.broadcast_object_list(made)
    made = made[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    results = {}
    if made["barrier"]:
        time_barriers(_entries(made["barrier"], "peer_barrier"), args, say,
                      results)
    if chosen & {"steps", "a2a", "pingpong"}:
        ranks = Ranks([dist_world(dev)] if across else loopback_ranks(8, dev))
        if "a2a" in chosen:
            pulls = _entries(made["a2a"], "peer_gather_pull")
            pulls[next(iter(PULL_DESIGNS))] = _build.entry(
                "peer_collectives", "peer_gather_pull")
            time_a2a(ranks, pulls, args, say, results)
        if "pingpong" in chosen:
            time_pingpong(ranks, args, say, results)
        if "steps" in chosen:
            time_steps(made["steps"], ranks, args, say, results)
    if across:
        leave_world()
    if "reduce" not in chosen:
        if lead:
            print(json.dumps({"card": smi, "reps": args.reps, "ms": results}))
        return 0
    entries = _entries(made["reduce"], "peer_reduce_scatter")
    entries["shipped"] = _build.entry("peer_collectives")

    n = 8
    chunk = 256 * MIB // 4 // n
    rows = example_input(SimWorld(n, dev), n * chunk, "float32")
    xs = [rows[r].clone() for r in range(n)]
    parts = [pr.PeerParts(x.view(n, chunk)[r] for x in xs) for r in range(n)]
    outs = [torch.empty_like(x) for x in xs]
    streams = [torch.cuda.Stream(dev) for _ in range(n)]
    scale = pr.mean_scale(n, torch.float32)

    def reduce(entry, tiles):
        def one(r):
            counters = pr.row_copy_counters("peer_reduce", dev)
            _build.check("design", entry(
                parts[r].table.data_ptr(), outs[r].data_ptr(),
                counters.data_ptr(), n, r, chunk, 0, scale, tiles, 1,
                pr._stream_of(outs[r])))
        return lambda: _on_streams(streams, one)

    def turns(what: str, cases: dict, checked: set) -> None:
        # each design checked once against the shipped kernel's output,
        # then every case once a round
        cases["shipped"]()
        torch.cuda.synchronize()
        want = torch.stack(outs).clone()
        for name in checked:
            for o in outs:
                o.zero_()
            cases[name]()
            torch.cuda.synchronize()
            if not torch.equal(torch.stack(outs), want):
                raise RuntimeError(f"{what}: {name} differs from the "
                                   "shipped kernel")
        for r in range(args.rounds):
            for name, fn in cases.items():
                ms = cuda_ms(fn, args.reps)
                results.setdefault(what, {}).setdefault(name, []).append(ms)
                say(f"{what} round {r}: {name} {ms:.4f} ms")

    for tiles in (1, n):
        cases = {name: reduce(e, tiles) for name, e in entries.items()}
        if tiles == 1:
            cases["view(n,n,c).sum(0)"] = lambda: rows.view(n, n, chunk).sum(0)
        turns(f"reduce-scatter 8 x 256 MiB, tiles {tiles}", cases,
              set(entries) - {"shipped"})
    for s in streams:
        with torch.cuda.stream(s):
            if pr.row_copy_counters("peer_reduce", dev).any():
                raise RuntimeError("peer_reduce counters left non-zero")
    print(json.dumps({"card": smi, "reps": args.reps, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
