"""Time the designs of the peer reduce-scatter and the peer barrier, and
the gather steps' two last executions, on one card.

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python -m tpu_perf_torch.tools.peer_designs [--parts reduce,barrier,steps]
        [--reduce 1x4,2x2] [--tma 4096x2,8192x2] [--reps 10] [--rounds 3]

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
4. ``steps``: ``pl_allreduce`` and ``pl_all_gather`` at -i 5 in the
   loopback of 8 ranks at 4 KiB and 256 MiB, each rank's step a CUDA
   graph, as shipped and with the other way of the last execution (an
   edit of ``ops/pallas_ring.py``, :data:`STEP_DESIGNS`: pulling into a
   new tensor, or pushing and returning a copy), each output held to the
   sim kernels' step first: the time an execution.

Each time is the mean device time of ``--reps`` back-to-back executions
(every rank's launch, or every rank's graph) between two CUDA events.
Prints the card's name and power limit, one line per measurement, and a
JSON summary as the last line.
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
            return peer_all_gather(mids, out=_fresh(world, elems, tdtype))
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
STEP_DESIGNS = {
    "pl_allreduce": ("last pull", "last copy", [
        (ALLREDUCE_LAST_PULL, ""),
        (ALLREDUCE_CHAIN, ALLREDUCE_CHAIN.replace(
            "execution)", "execution, torch.clone)"))]),
    "pl_all_gather": ("last copy", "last pull", [
        (GATHER_PUSH, GATHER_LAST_PULL),
        (GATHER_CHAIN, GATHER_CHAIN.replace(", torch.clone", ""))]),
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


def _barrier_entries(jobs: list) -> dict:
    # each barrier variant's peer_barrier entry, from its built library
    from tpu_perf_torch.kernels import _build

    argtypes = _build._EXTRA_ENTRIES[("peer_collectives", "peer_barrier")]
    entries = {}
    for name, _, lib, _ in jobs:
        fn = ctypes.CDLL(str(lib)).peer_barrier
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


def time_steps(out_dir, args, say, results) -> None:
    """Each op of :data:`STEP_DESIGNS` at -i 5 in the 8-rank loopback at 4
    KiB and 256 MiB, each rank's step one CUDA graph, shipped and edited;
    each output first held bit for bit to the sim kernels' step."""
    import torch

    from tpu_perf_torch.ops import pallas_ring as pr
    from tpu_perf_torch.ops.collectives import example_input
    from tpu_perf_torch.world import SimWorld, loopback_ranks

    dev = torch.device("cuda", torch.cuda.current_device())
    n, iters = 8, 5
    streams = [torch.cuda.Stream(dev) for _ in range(n)]
    edited = step_designs(out_dir)
    for op, (shipped, other, _) in STEP_DESIGNS.items():
        modules = {shipped: pr, other: load_steps(edited[op])}
        for nbytes in (4096, 256 * MIB):
            elems, chunk, _ = pr._pallas_sizes(op, n, nbytes, 4)
            sim = SimWorld(n, dev)
            rows = example_input(sim, elems, "float32")
            want = pr.build_pallas_step(op, sim, nbytes, iters)[0](rows)
            xs = [rows[r].clone() for r in range(n)]
            cases = {}
            for name, mod in modules.items():
                # each module keeps its own tile counters
                mod.warm_loopback_streams(streams, dev, n * chunk * 4)
                if op == "pl_allreduce":
                    steps = [mod._dist_allreduce_step(
                        w, elems, chunk, iters, torch.float32)
                        for w in loopback_ranks(n, dev)]
                else:
                    steps = [mod._dist_gather_step(
                        op, w, chunk, iters, torch.float32)
                        for w in loopback_ranks(n, dev)]
                outs = [None] * n

                def eager(r, steps=steps, outs=outs):
                    outs[r] = steps[r](xs[r])

                _on_streams(streams, eager)
                torch.cuda.synchronize()
                if not torch.equal(torch.stack(outs), want):
                    raise RuntimeError(f"{op} at {nbytes} B, {name}: "
                                       "not the sim kernels' step")
                # the graphs replay into the steps' symmetric buffers, which
                # the steps' loopback memory frees with them: a graph kept
                # without its steps writes freed memory (an illegal address)
                cases[name] = (_graphs(
                    streams, lambda r, steps=steps: steps[r](xs[r]), 1),
                    steps)
            what = f"{op} at {nbytes} B a rank, 8 ranks, -i {iters}"
            for rd in range(args.rounds):
                for name, (graphs, _) in cases.items():
                    ms = cuda_ms(lambda g=graphs: _on_streams(
                        streams, lambda r: g[r].replay()), args.reps) / iters
                    results.setdefault(what, {}).setdefault(name, []).append(
                        ms)
                    say(f"{what} round {rd}: {name} {ms:.4f} ms an "
                        "execution")
            del cases
            torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="reduce,barrier,steps",
                    help="what to time: reduce, barrier, steps")
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
    from tpu_perf_torch.world import SimWorld

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    def say(line: str) -> None:
        print(f"{line} ({smi})")

    out_dir = _build.BUILD_DIR / "peer_designs"
    shutil.rmtree(out_dir, ignore_errors=True)
    found = designs(out_dir, args.reduce, args.tma) if "reduce" in chosen \
        else {}
    barriers = barrier_designs(out_dir) if "barrier" in chosen else {}
    _build.build_all()
    jobs = start_variants(
        {name: (src, "peer_collectives", defines)
         for name, (src, defines) in {**found, **barriers}.items()})
    entries = finish_variants(jobs)
    results = {}
    if barriers:
        time_barriers(_barrier_entries(
            [job for job in jobs if job[0] in barriers]), args, say, results)
    if "steps" in chosen:
        time_steps(out_dir, args, say, results)
    if "reduce" not in chosen:
        print(json.dumps({"card": smi, "reps": args.reps, "ms": results}))
        return 0
    entries = {name: e for name, e in entries.items() if name in found}
    entries["shipped"] = _build.entry("peer_collectives")

    dev = torch.device("cuda", torch.cuda.current_device())
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
