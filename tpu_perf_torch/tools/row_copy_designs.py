"""Time the designs of the port's two row-copy kernels on one card.

Run from the repository root on a machine with an NVIDIA Hopper GPU::

    python -m tpu_perf_torch.tools.row_copy_designs [--copies 2x4,2x8]
        [--shifts 2x4,2x8] [--tma 32768x4,16384x8] [--reps 20] [--rounds 3]

1. Writes each design's sources under ``tpu_perf_torch/_build/designs/``
   and builds them, one nvcc each, all started together (printing what
   ``-Xptxas -v`` says): ``csrc/hbm_copy.cu`` at each ``--copies`` and
   ``csrc/p2p_shift.cu`` at each ``--shifts`` unroll x CTAs an SM (the
   constants ``kUnroll``, 16-byte spans in flight a thread, the tile being
   256 threads x unroll x 16 bytes, and ``kCtasPerSm`` of
   ``csrc/row_copy.cuh``, which ships 2 x 4, edited in a copy);
   ``csrc/p2p_shift.cu`` with a static deal of tiles (CTA b takes tiles
   b, b + grid, ... instead of drawing them from the counter); and the TMA
   design of the copy below, at each ``--tma`` piece size x stage count.
2. At the ``pl_hbm_copy`` path's row, 1 x 256 MiB float32: checks every
   copy against ``x``, then times in turns, ``--rounds`` times, each
   design, ``y.copy_(x)`` and ``x.clone()``.
3. At the ``pl_ring`` path's 8 x 256 MiB: the row shift at shift 1 (ring)
   and n/2 (exchange) at each unroll x CTAs an SM, its static deal, the
   row gather ``x[idx]``, ``x.index_select(0, idx)`` and ``torch.roll``,
   checked and timed the same way.

Each time is the mean device time of ``--reps`` back-to-back calls between
two CUDA events.  Prints the card's name and power limit, one line per
measurement, and a JSON summary as the last line.

The TMA design (``TMA_COPY`` below) is the copy's Hopper counterpart of the
TPU's DMA: a persistent grid takes pieces of the rows' 16-byte aligned
bodies in order from the same counter, and one thread of each CTA runs a
ring of stages in shared memory, stages - 1 bulk loads in flight, a stage
loaded again once the store issued from it has read it (plain byte stores
for the rows' heads and tails).  ``csrc/hbm_copy.cu`` ships the register
design instead, which this script found faster.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

MIB = 1024**2

TMA_COPY = r"""
#include "bulk_copy.cuh"
#include "row_copy.cuh"

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kPiece = HBM_COPY_PIECE_BYTES;
constexpr int kStages = HBM_COPY_STAGES;
constexpr int kLead = kStages - 1;  // loads in flight

// all but the newest committed store group have read shared memory
__device__ __forceinline__ void wait_read_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void split_row(const uint8_t* s, const uint8_t* d,
                                          long long row_bytes, long long* head,
                                          long long* body) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  *head = row_bytes;
  *body = 0;
  if (((sa ^ reinterpret_cast<uintptr_t>(d)) & 15) == 0) {
    long long h = (long long)((16 - (sa & 15)) & 15);
    if (h > row_bytes) h = row_bytes;
    *head = h;
    *body = (row_bytes - h) & ~15ll;
  }
}

__global__ void __launch_bounds__(kThreads)
tma_copy(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
         unsigned int* counters, int n, long long row_bytes,
         unsigned int per_row) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bars[kStages];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int r = 0; r < n; ++r) {
    const uint8_t* s = src + (long long)r * row_bytes;
    uint8_t* d = dst + (long long)r * row_bytes;
    long long head, body;
    split_row(s, d, row_bytes, &head, &body);
    for (long long i = first; i < head; i += stride) d[i] = s[i];
    for (long long i = head + body + first; i < row_bytes; i += stride) {
      d[i] = s[i];
    }
  }
  if (threadIdx.x != 0) return;
  for (int k = 0; k < kStages; ++k) bulk::barrier_init(&bars[k]);
  const unsigned int pieces = (unsigned int)n * per_row;
  uint8_t* to[kStages];
  uint32_t bytes[kStages];
  auto load_next = [&](long long i) -> bool {
    for (;;) {
      const unsigned int t = row_copy::draw(counters);
      if (t >= pieces) return false;
      const unsigned int r = t / per_row;
      const long long off = (long long)(t - r * per_row) * kPiece;
      const uint8_t* s = src + (long long)r * row_bytes;
      uint8_t* d = dst + (long long)r * row_bytes;
      long long head, body;
      split_row(s, d, row_bytes, &head, &body);
      if (off >= body) continue;
      const int k = (int)(i % kStages);
      const long long left = body - off;
      bytes[k] = left < kPiece ? (uint32_t)left : kPiece;
      to[k] = d + head + off;
      bulk::load(stage + (long long)k * kPiece, s + head + off, bytes[k],
                 &bars[k]);
      return true;
    }
  };
  long long issued = 0;
  bool more = true;
  while (issued < kLead && (more = load_next(issued))) ++issued;
  for (long long stored = 0; stored < issued; ++stored) {
    const int k = (int)(stored % kStages);
    bulk::wait(&bars[k], (uint32_t)((stored / kStages) & 1));
    bulk::store(to[k], stage + (long long)k * kPiece, bytes[k]);
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

extern "C" int hbm_copy_rows(const void* src, void* dst, void* counters, int n,
                             long long row_bytes, void* stream) {
  // as many CTAs as the card holds with their stages
  static int resident = 0;
  const size_t smem = (size_t)kStages * kPiece;
  cudaError_t err = cudaSuccess;
  if (resident == 0) {
    int device = 0, per_sm = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          tma_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tma_copy,
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
  const long long per_row = (row_bytes + kPiece - 1) / kPiece;
  const int grid = row_copy::grid_for(n * per_row, resident, &err);
  if (err != cudaSuccess) return (int)err;
  tma_copy<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<unsigned int*>(counters), n, row_bytes,
      (unsigned int)per_row);
  return (int)cudaGetLastError();
}
"""


def cuda_ms(fn, reps: int) -> float:
    import torch

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


#: the shipped constants of csrc/row_copy.cuh that a design edits
UNROLL = "constexpr int kUnroll = 2;"
CTAS_PER_SM = "constexpr int kCtasPerSm = 4;"
#: for the static deal, put before the tile draw of row_copy::for_each_tile
DRAW = "  __shared__ unsigned int drawn[2];"
STATIC_DEAL = ("  for (unsigned int t = blockIdx.x; t < tiles; t += gridDim.x) "
               "body(t);\n  return;\n")


def write_design(out_dir: Path, source: str, edits: list[tuple[str, str]],
                 defines: list[str] = (),
                 source_edits: list[tuple[str, str]] = ()
                 ) -> tuple[Path, list[str]]:
    """A copy of the kernel sources in ``out_dir`` with each ``(old, new)``
    edit made in ``row_copy.cuh`` and each of ``source_edits`` in the
    source, exactly once; ``source`` is the name of a file of ``csrc/`` or
    the text of a source.  Returns the source file to build and its -D
    defines."""
    from tpu_perf_torch.kernels import _build

    def edited(what: str, text: str, pairs) -> str:
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{what} holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        return text

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    cuh = out_dir / "row_copy.cuh"
    cuh.write_text(edited("row_copy.cuh", cuh.read_text(), edits))
    if source.endswith(".cu"):
        path = out_dir / source
        text = (_build.CSRC / source).read_text()
    else:
        path = out_dir / "design.cu"
        text = source
    path.write_text(edited(path.name, text, source_edits))
    return path, list(defines)


def start_variants(variants: dict[str, tuple[Path, str, list[str]]]) -> list:
    """Start one nvcc for each variant, ``name -> (source file, entry key
    of _build._ENTRIES, -D defines)``, all at once; finish_variants waits
    for them."""
    from tpu_perf_torch.kernels import _build

    jobs = []
    for name, (source, key, defines) in variants.items():
        lib = source.parent / f"lib{key}.so"
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *(f"-D{d}" for d in defines), "-o", str(lib),
               str(source)]
        jobs.append((name, key, lib,
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    return jobs


def finish_variants(jobs: list) -> dict:
    """Wait for the builds of start_variants, printing each kernel's
    register and shared-memory use; returns ``name -> C entry``."""
    from tpu_perf_torch.kernels import _build

    entries = {}
    for name, key, lib, proc in jobs:
        said, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{said}")
        usage = [ln.strip() for ln in said.splitlines() if "Used" in ln]
        print(f"build: {name}: {usage}")
        symbol, argtypes = _build._ENTRIES[key]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--copies", default="2x4,2x8,2x2,4x2",
                    help="unroll x CTAs an SM of the copy")
    ap.add_argument("--shifts", default="2x4,2x8,4x2",
                    help="unroll x CTAs an SM of the row shift")
    ap.add_argument("--tma", default="8192x16,16384x8,32768x4,65536x3",
                    help="piece bytes x stages of the TMA design")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("row_copy_designs: no CUDA device is visible", file=sys.stderr)
        return 1
    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.ops.pallas_ring import _stream_of, row_copy_counters
    from tpu_perf_torch.world import SimWorld

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out_dir = _build.BUILD_DIR / "designs"
    shutil.rmtree(out_dir, ignore_errors=True)
    copies, shifts = {}, {}

    def at(spec):
        unroll, cap = spec.split("x")
        return (f"unroll {unroll} ctas/sm {cap}",
                [(UNROLL, f"constexpr int kUnroll = {unroll};"),
                 (CTAS_PER_SM, f"constexpr int kCtasPerSm = {cap};")])

    for spec in args.copies.split(","):
        name, edits = at(spec)
        copies[f"registers {name}"] = write_design(
            out_dir / f"copy_{spec}", "hbm_copy.cu", edits)
    for spec in args.shifts.split(","):
        name, edits = at(spec)
        shifts[f"kernel {name}"] = write_design(
            out_dir / f"shift_{spec}", "p2p_shift.cu", edits)
    for spec in args.tma.split(","):
        piece, stages = spec.split("x")
        copies[f"tma piece {piece} stages {stages}"] = write_design(
            out_dir / f"tma_{spec}", TMA_COPY, [],
            [f"HBM_COPY_PIECE_BYTES={piece}", f"HBM_COPY_STAGES={stages}"])
    shifts["static deal"] = write_design(
        out_dir / "shift_static", "p2p_shift.cu", [(DRAW, STATIC_DEAL + DRAW)])
    keys = {**dict.fromkeys(copies, "hbm_copy"),
            **dict.fromkeys(shifts, "p2p_shift")}
    entries = finish_variants(start_variants(
        {name: (src, keys[name], defines)
         for name, (src, defines) in {**copies, **shifts}.items()}))
    dev = torch.device("cuda", torch.cuda.current_device())
    copy_ctr = row_copy_counters("hbm_copy", dev).data_ptr()
    shift_ctr = row_copy_counters("p2p_shift", dev).data_ptr()
    results = {}

    def turns(what: str, cases: dict, want, y) -> None:
        # each design checked once, then every case once a round
        for name, fn in cases.items():
            y.zero_()
            fn()
            torch.cuda.synchronize()
            if name in entries and not torch.equal(y, want):
                raise RuntimeError(f"{what}: {name} copied wrong bytes")
        for r in range(args.rounds):
            for name, fn in cases.items():
                ms = cuda_ms(fn, args.reps)
                results.setdefault(what, {}).setdefault(name, []).append(ms)
                print(f"{what} round {r}: {name} {ms:.4f} ms")

    def launch(entry, ctr, x, y, *rest):
        stream = _stream_of(x)
        return lambda: _build.check("design", entry(
            x.data_ptr(), y.data_ptr(), ctr, x.shape[0],
            x.shape[1] * x.element_size(), *rest, stream))

    # the copy at the pl_hbm_copy path's row
    x = build_op("pl_hbm_copy", SimWorld(1, dev), 256 * MIB, 1).example_input
    y = torch.empty_like(x)
    cases = {name: launch(entries[name], copy_ctr, x, y) for name in copies}
    cases["copy_"] = lambda: y.copy_(x)
    cases["clone"] = lambda: x.clone()
    turns(f"copy {tuple(x.shape)}", cases, x, y)
    del x, y

    # the row shift at the pl_ring path's input
    x = build_op("pl_ring", SimWorld(8, dev), 256 * MIB, 1).example_input
    y = torch.empty_like(x)
    n = x.shape[0]
    for what, k in (("ring", 1), ("exchange", n // 2)):
        idx = (torch.arange(n, device=dev) - k) % n
        cases = {name: launch(entries[name], shift_ctr, x, y, k)
                 for name in shifts}
        cases["x[idx]"] = lambda idx=idx: x[idx]
        cases["index_select"] = lambda idx=idx: x.index_select(0, idx)
        cases["roll"] = lambda k=k: torch.roll(x, k, 0)
        turns(f"{what} {tuple(x.shape)}", cases, x.index_select(0, idx), y)
    print(json.dumps({"card": smi, "reps": args.reps, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
