"""Time the designs of the peer reduce-scatter on one card.

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python -m tpu_perf_torch.tools.peer_designs [--reduce 1x4,2x2]
        [--tma 4096x2,8192x2] [--reps 10] [--rounds 3]

1. Writes each design's copy of ``csrc/peer_collectives.cu`` (with the
   shared headers) under ``tpu_perf_torch/_build/peer_designs/`` and
   builds them, one nvcc each, all started together (printing what
   ``-Xptxas -v`` says): the reduce-scatter at each ``--reduce`` units x
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

Each time is the mean device time of ``--reps`` back-to-back executions
(every rank's launch) between two CUDA events.  Prints the card's name and
power limit, one line per measurement, and a JSON summary as the last
line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduce", default="1x4,1x8,2x2,2x4,4x1,4x2",
                    help="units x CTAs an SM of the reduce-scatter")
    ap.add_argument("--tma", default="4096x2,4096x3,8192x2,2048x4",
                    help="span bytes x stages of the TMA reduce design")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

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
    out_dir = _build.BUILD_DIR / "peer_designs"
    shutil.rmtree(out_dir, ignore_errors=True)
    found = designs(out_dir, args.reduce, args.tma)
    _build.build_all()
    entries = finish_variants(start_variants(
        {name: (src, "peer_collectives", defines)
         for name, (src, defines) in found.items()}))
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

    def on_streams(launch):
        main_stream = torch.cuda.current_stream()
        for s in streams:
            s.wait_stream(main_stream)
        for r, s in enumerate(streams):
            with torch.cuda.stream(s):
                launch(r)
        for s in streams:
            main_stream.wait_stream(s)

    def reduce(entry, tiles):
        def one(r):
            counters = pr.row_copy_counters("peer_reduce", dev)
            _build.check("design", entry(
                parts[r].table.data_ptr(), outs[r].data_ptr(),
                counters.data_ptr(), n, r, chunk, 0, scale, tiles, 1,
                pr._stream_of(outs[r])))
        return lambda: on_streams(one)

    results = {}

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
                print(f"{what} round {r}: {name} {ms:.4f} ms ({smi})")

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
