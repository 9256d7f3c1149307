"""Time the designs of the port's all-gather kernel on one card.

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python -m tpu_perf_torch.tools.gather_designs [--fanouts 2x4,2x2,4x2]
        [--tma 32768x4,65536x3] [--outputs 4] [--reps 20] [--rounds 3]

1. Writes each design's sources under
   ``tpu_perf_torch/_build/gather_designs/`` and builds them, one nvcc
   each, all started together (printing what ``-Xptxas -v`` says), each
   from an edited copy of ``csrc/all_gather.cu`` and ``csrc/row_copy.cuh``
   (:func:`designs`):

   * (a) the register fan-out: tile (c, t) of own chunk c is loaded into
     registers once and stored to out[d][c] for every rank d with
     streaming stores (``st.global.cs``);
   * (b) destination-major, which ships: the tile list is (c, t, d) with d
     fastest, and each destination tile loads its source tile again (from
     L2, likely), with streaming stores;
   * (a) and (b) at each ``--fanouts`` unroll x CTAs an SM, and at the
     first of them with plain stores too;
   * (c) a TMA fan-out: one ``cp.async.bulk`` load of a piece into shared
     memory, then n bulk stores of it, one to each row, through a ring of
     stages, at each ``--tma`` piece bytes x stages;

2. At the ``pl_allreduce`` path's gather input, 8 ranks x 32 MiB float32
   (256 MiB a rank): checks every design against the plain gather exactly,
   then times in turns, ``--rounds`` times, each design and the shipped
   entry into each of ``--outputs`` preallocated outputs (a store-bound
   gather's time moves with the physical pages of its output), the
   wrapper (which allocates its output), the expand copy
   ``own.reshape(1, -1).expand(n, -1).contiguous()`` and a broadcast
   ``copy_`` into a preallocated output; prints each design's mean over
   the outputs.

Each time is the mean device time of ``--reps`` back-to-back calls between
two CUDA events.  Prints the card's name and power limit, one line per
measurement, and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

from tpu_perf_torch.tools.row_copy_designs import (
    CTAS_PER_SM, UNROLL, cuda_ms, finish_variants, start_variants,
    write_design,
)

MIB = 1024**2

#: the shipped gather's tile list, tile body and grid (csrc/all_gather.cu:
#: destination-major, streaming stores), which the fan-out design edits
TILE_LIST = """\
counters, (unsigned int)(n * n) * per_chunk, [&](unsigned int u) {
        const unsigned int t = u / (unsigned int)n;  // source tile (c, t)
        const int d = (int)(u - t * (unsigned int)n);"""
TILE_BODY = """\
        row_copy::copy_tile<true>(src + (long long)c * src_step,
                                  out + ((long long)d * n + c) * chunk, chunk,
                                  t0);"""
GRID = "row_copy::grid_for((long long)n * n * per_chunk,"


def fan_out(store: str) -> list[tuple[str, str]]:
    """The edits of csrc/all_gather.cu for the register fan-out: one tile
    list entry per source tile (c, t), whose words a thread loads once and
    stores to out[d][c] for every d, each by ``store`` (a statement of
    ``o``, ``i`` and ``v[r][k]``)."""
    return [
        (TILE_LIST,
         "counters, (unsigned int)n * per_chunk, [&](unsigned int t) {"),
        (TILE_BODY, f"""\
        using row_copy::kUnroll;
        constexpr int kRounds = (int)(16 / sizeof(W));
        const W* s = src + (long long)c * src_step;
        const long long lane0 =
            t0 + (long long)(threadIdx.x & ~31) * kUnroll + (threadIdx.x & 31);
        W v[kRounds][kUnroll];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {{
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {{
            const long long i = lane0 + (long long)r * kThreads * kUnroll + 32 * k;
            if (i < chunk) v[r][k] = s[i];
          }}
        }}
        for (int d = 0; d < n; ++d) {{
          W* o = out + ((long long)d * n + c) * chunk;
#pragma unroll
          for (int r = 0; r < kRounds; ++r) {{
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {{
              const long long i = lane0 + (long long)r * kThreads * kUnroll + 32 * k;
              if (i < chunk) {store}
            }}
          }}
        }}"""),
        (GRID, "row_copy::grid_for((long long)n * per_chunk,"),
    ]


#: the stores of the register designs: streaming (st.global.cs), as the
#: gather ships, and plain
STREAMING_STORE = "__stcs(&o[i], v[r][k]);"
PLAIN_STORE = "o[i] = v[r][k];"

TMA_GATHER = r"""
#include "bulk_copy.cuh"
#include "row_copy.cuh"

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kPiece = GATHER_PIECE_BYTES;
constexpr int kStages = GATHER_STAGES;
constexpr int kLead = kStages - 1;  // loads in flight

// all but the newest committed store group have read shared memory
__device__ __forceinline__ void wait_read_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

// Pieces of the n own chunks in address order of the source: piece (c, p)
// is loaded once into a stage and stored from there to out[d][c] for
// every d, one bulk group a piece.
__global__ void __launch_bounds__(kThreads)
tma_gather(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
           unsigned int* counters, int n, long long chunk, long long src_step,
           unsigned int per_chunk) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bars[kStages];
  if (threadIdx.x != 0) return;
  for (int k = 0; k < kStages; ++k) bulk::barrier_init(&bars[k]);
  const unsigned int pieces = (unsigned int)n * per_chunk;
  const long long row = (long long)n * chunk;
  uint8_t* to[kStages];
  uint32_t bytes[kStages];
  auto load_next = [&](long long i) -> bool {
    const unsigned int t = row_copy::draw(counters);
    if (t >= pieces) return false;
    const int c = (int)(t / per_chunk);
    const long long off = (long long)(t - (unsigned int)c * per_chunk) * kPiece;
    const int k = (int)(i % kStages);
    const long long left = chunk - off;
    bytes[k] = left < kPiece ? (uint32_t)left : kPiece;
    to[k] = out + (long long)c * chunk + off;
    bulk::load(stage + (long long)k * kPiece, src + (long long)c * src_step + off,
               bytes[k], &bars[k]);
    return true;
  };
  long long issued = 0;
  bool more = true;
  while (issued < kLead && (more = load_next(issued))) ++issued;
  for (long long stored = 0; stored < issued; ++stored) {
    const int k = (int)(stored % kStages);
    bulk::wait(&bars[k], (uint32_t)((stored / kStages) & 1));
    for (int d = 0; d < n; ++d) {
      bulk::store(to[k] + (long long)d * row, stage + (long long)k * kPiece,
                  bytes[k]);
    }
    bulk::commit();
    if (more) {
      wait_read_but_newest();  // the refill's stage is the store before's
      if ((more = load_next(issued))) ++issued;
    }
  }
  bulk::wait_done();
  row_copy::retire(counters);
}

}  // namespace

extern "C" int direct_all_gather(const void* src, void* out, void* counters,
                                 int n, long long chunk_bytes,
                                 long long src_row_bytes,
                                 long long src_own_bytes, void* stream) {
  const long long step = src_row_bytes + src_own_bytes;
  if (n < 1 || chunk_bytes < 1 || !bulk::aligned(src) || !bulk::aligned(out) ||
      (chunk_bytes | step) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  static int resident = 0;
  const size_t smem = (size_t)kStages * kPiece;
  cudaError_t err = cudaSuccess;
  if (resident == 0) {
    int device = 0, per_sm = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          tma_gather, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tma_gather,
                                                          kThreads, smem);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const long long per_chunk = (chunk_bytes + kPiece - 1) / kPiece;
  const int grid = row_copy::grid_for(n * per_chunk, resident, &err);
  if (err != cudaSuccess) return (int)err;
  tma_gather<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out),
      static_cast<unsigned int*>(counters), n, chunk_bytes, step,
      (unsigned int)per_chunk);
  return (int)cudaGetLastError();
}
"""


def designs_dir() -> Path:
    """Where the designs' sources and libraries are written (gitignored)."""
    from tpu_perf_torch.kernels import _build

    return _build.BUILD_DIR / "gather_designs"


def designs(out_dir: Path, fanouts: str = "2x4",
            tma: str = "65536x3") -> dict:
    """Write each design's sources under ``out_dir``: ``name -> (source
    file, -D defines)``, each built against the ``all_gather`` entry: (a)
    and (b) at each of ``fanouts`` (unroll x CTAs an SM), with plain
    stores too at the first, and (c) at each of ``tma`` (piece bytes x
    stages)."""
    found = {}
    for i, spec in enumerate(fanouts.split(",")):
        unroll, cap = spec.split("x")
        at = [(UNROLL, f"constexpr int kUnroll = {unroll};"),
              (CTAS_PER_SM, f"constexpr int kCtasPerSm = {cap};")]
        for tag, label, edits, plain_edits in (
                ("dest_major", "(b) destination-major", [],
                 [(TILE_BODY, TILE_BODY.replace("<true>", "<false>"))]),
                ("fan_out", "(a) fan-out", fan_out(STREAMING_STORE),
                 fan_out(PLAIN_STORE))):
            name = f"{label} unroll {unroll} ctas/sm {cap}"
            found[name] = write_design(out_dir / f"{tag}_{spec}",
                                       "all_gather.cu", at,
                                       source_edits=edits)
            if i == 0:
                found[f"{name}, plain stores"] = write_design(
                    out_dir / f"{tag}_{spec}_plain", "all_gather.cu", at,
                    source_edits=plain_edits)
    for spec in tma.split(","):
        piece, stages = spec.split("x")
        found[f"(c) tma piece {piece} stages {stages}"] = write_design(
            out_dir / f"tma_{spec}", TMA_GATHER, [],
            [f"GATHER_PIECE_BYTES={piece}", f"GATHER_STAGES={stages}"])
    return found


def start(out_dir: Path, **kw) -> list:
    """Write the designs (see :func:`designs`) and start their builds."""
    shutil.rmtree(out_dir, ignore_errors=True)
    return start_variants({name: (src, "all_gather", defines)
                           for name, (src, defines)
                           in designs(out_dir, **kw).items()})


def launcher(entry, own, out):
    """A call of design ``entry`` gathering ``own`` (n, chunk) into
    ``out`` (n, n*chunk), through the card's all-gather tile counters."""
    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.pallas_ring import _stream_of, row_copy_counters

    n, chunk = own.shape
    nbytes = chunk * own.element_size()
    ctr = row_copy_counters("all_gather", own.device).data_ptr()
    stream = _stream_of(own)
    return lambda: _build.check("design", entry(
        own.data_ptr(), out.data_ptr(), ctr, n, nbytes, nbytes, 0, stream))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fanouts", default="2x4,2x2,4x2",
                    help="unroll x CTAs an SM of the register designs")
    ap.add_argument("--tma", default="32768x4,65536x3",
                    help="piece bytes x stages of the TMA fan-out")
    ap.add_argument("--outputs", type=int, default=4,
                    help="output buffers each design writes into in turn")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gather_designs: no CUDA device is visible", file=sys.stderr)
        return 1
    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import (
        direct_all_gather, direct_all_gather_plain, direct_reduce_scatter,
        mean_scale,
    )
    from tpu_perf_torch.world import SimWorld

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    entries = finish_variants(start(designs_dir(),
                                    fanouts=args.fanouts, tma=args.tma))
    dev = torch.device("cuda", torch.cuda.current_device())
    # the pl_allreduce path's gather input: the scaled owned chunks
    x = build_op("pl_allreduce", SimWorld(8, dev), 256 * MIB, 1).example_input
    own = direct_reduce_scatter(x, scale=mean_scale(8, x.dtype))
    del x
    n, chunk = own.shape
    want = direct_all_gather_plain(own)
    # the time of a store-bound gather moves with the physical pages of
    # its output, so every design writes into the same several buffers
    outs = [torch.empty_like(want) for _ in range(args.outputs)]
    entries["shipped entry"] = _build.entry("all_gather")
    cases = {(name, i): launcher(fn, own, out) for name, fn in entries.items()
             for i, out in enumerate(outs)}
    cases[("shipped wrapper", None)] = lambda: direct_all_gather(own)
    cases[("expand copy", None)] = (
        lambda: own.reshape(1, -1).expand(n, -1).contiguous())
    cases[("copy_broadcast", 0)] = lambda: outs[0].view(n, n, chunk).copy_(
        own.unsqueeze(0).expand(n, n, chunk))
    what = f"gather {tuple(own.shape)} -> {tuple(want.shape)}"
    for (name, i), fn in cases.items():
        if i is not None:
            outs[i].zero_()
        got = fn()
        torch.cuda.synchronize()
        got = outs[i] if got is None else got.reshape(want.shape)
        if not torch.equal(got, want):
            raise RuntimeError(f"{what}: {name} gathered wrong bytes")
    results: dict[str, list[float]] = {}
    for r in range(args.rounds):
        for (name, i), fn in cases.items():
            ms = cuda_ms(fn, args.reps)
            key = name if i is None else f"{name} [output {i}]"
            results.setdefault(key, []).append(ms)
            print(f"{what} round {r}: {key} {ms:.4f} ms")
    # per design: the mean over the output buffers of its median round
    summary = {}
    for (name, i) in cases:
        key = name if i is None else f"{name} [output {i}]"
        summary.setdefault(name, []).append(statistics.median(results[key]))
    summary = {name: statistics.fmean(v) for name, v in summary.items()}
    for name, ms in sorted(summary.items(), key=lambda kv: kv[1]):
        print(f"{what}: {name} {ms:.4f} ms (mean over outputs)")
    print(json.dumps({"card": smi, "reps": args.reps, "what": what,
                      "mean_ms": summary, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
