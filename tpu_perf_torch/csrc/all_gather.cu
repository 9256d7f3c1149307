// Direct all-gather, every rank of the sim world in one launch.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_all_gather_kernel` (both modes,
// with its neighbour barrier `_ring_barrier`) and `_all_gather_bidir_kernel`
// (with `_ring_barrier`).
//
// What it computes.  Rank c's own chunk is src row c (in `src_full` mode,
// chunk c of the n-chunk row c: the all-gather phase of the ring
// all-reduce, whose input is the reduce-scatter phase's output).  Every
// row d of out gets all n own chunks, out[d][c] = own chunk c.  The TPU
// kernels forward the chunks round the ring, n - 1 steps (the
// bidirectional one sends first halves clockwise and second halves
// counter-clockwise); nothing is added on the way, so the order of
// forwarding cannot change a bit, and both compute this same output.  On
// one card the two directions are copies in the same device memory, so the
// half-chunk split is no schedule of its own here; it comes back with a
// multi-card world, where the two directions are two links.
//
// Ordering.  src and out are distinct buffers and the kernels of one stream
// run in order, so the launch boundary stands in for `_ring_barrier` and
// the per-step semaphores: every rank of one execution shares one launch.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  Each own chunk is
// read once and written into every row: n * chunk bytes read and
// n * n * chunk written, no arithmetic.  The ring moved each chunk
// n - 1 times through the rows (read and written at every step).
//
// Design (row_copy.cuh): the work is one list of n * F * n tiles of 8 KB,
// F tiles a chunk, in address order of the source with the destination
// fastest: tile (c, t, d) copies tile t of own chunk c into out[d][c].  A
// persistent grid (four CTAs an SM, no more than the tiles) takes them in
// order from a device counter, so the n copies of a source tile run side
// by side: the first reads it from device memory and the others likely
// find it in L2, so each source byte should cross the memory bus about
// once.  Each tile
// goes through registers and is stored evict-first (st.global.cs): the
// n-fold output is 8/9 of the traffic and nothing reads it back here.
// Loading a source tile once and storing it to all n rows (a register
// fan-out), a TMA fan-out (one bulk load, n bulk stores) and plain stores
// were slower, and the fan-out's time moved with its output's pages
// (python -m tpu_perf_torch.tools.gather_designs).  The copy is typeless:
// the host picks the widest word (16, 4, 2 or 1 bytes) that divides both
// base addresses, the chunk and, in `src_full` mode, the source row and
// offset, so any payload dtype moves at 16 bytes per thread where it can.

#include "row_copy.cuh"

namespace {

using row_copy::kThreads;

// Sizes and offsets in words of W: own chunk c starts at
// src + c * src_step; `per_chunk` tiles a chunk.
template <typename W>
__global__ void __launch_bounds__(kThreads)
gather(const W* __restrict__ src, W* __restrict__ out, unsigned int* counters,
       int n, long long chunk, long long src_step, unsigned int per_chunk) {
  row_copy::for_each_tile(
      counters, (unsigned int)(n * n) * per_chunk, [&](unsigned int u) {
        const unsigned int t = u / (unsigned int)n;  // source tile (c, t)
        const int d = (int)(u - t * (unsigned int)n);
        const int c = (int)(t / per_chunk);
        const long long t0 = (long long)(t - (unsigned int)c * per_chunk) *
                             row_copy::kTileWords<W>;
        row_copy::copy_tile<true>(src + (long long)c * src_step,
                                  out + ((long long)d * n + c) * chunk, chunk,
                                  t0);
      });
}

template <typename W>
int launch(const void* src, void* out, void* counters, int n,
           long long chunk_b, long long src_step_b, cudaStream_t stream) {
  static int resident_cache[row_copy::kMaxDevices] = {0};
  cudaError_t err = cudaSuccess;
  const int resident =
      row_copy::resident_ctas((const void*)gather<W>, resident_cache, &err);
  if (err != cudaSuccess) return (int)err;
  const long long chunk = chunk_b / (long long)sizeof(W);
  constexpr long long tile = row_copy::kTileWords<W>;
  const long long per_chunk = (chunk + tile - 1) / tile;
  const int grid =
      row_copy::grid_for((long long)n * n * per_chunk, resident, &err);
  if (err != cudaSuccess) return (int)err;
  gather<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out),
      static_cast<unsigned int*>(counters), n, chunk,
      src_step_b / (long long)sizeof(W), (unsigned int)per_chunk);
  return (int)cudaGetLastError();
}

int gather_rows(const void* src, void* out, void* counters, int n,
                long long chunk_bytes, long long src_step_bytes,
                void* stream) {
  if (n < 1 || chunk_bytes < 1 || src_step_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)chunk_bytes | (uintptr_t)src_step_bytes;
  if ((bits & 15) == 0) {
    return launch<uint4>(src, out, counters, n, chunk_bytes, src_step_bytes, s);
  }
  if ((bits & 3) == 0) {
    return launch<uint32_t>(src, out, counters, n, chunk_bytes, src_step_bytes,
                            s);
  }
  if ((bits & 1) == 0) {
    return launch<uint16_t>(src, out, counters, n, chunk_bytes, src_step_bytes,
                            s);
  }
  return launch<uint8_t>(src, out, counters, n, chunk_bytes, src_step_bytes, s);
}

}  // namespace

// Sizes in bytes.  src row c starts at c * src_row_bytes and its own chunk
// at a further c * src_own_bytes (0 unless src_full); out is (n, n *
// chunk_bytes), distinct from src.  counters is 2 uint32 words, zero, that
// only launches ordered on one stream touch (the kernel leaves them zero).
// Returns the occupancy query's error, else cudaGetLastError().
extern "C" int direct_all_gather(const void* src, void* out, void* counters,
                                 int n, long long chunk_bytes,
                                 long long src_row_bytes,
                                 long long src_own_bytes, void* stream) {
  return gather_rows(src, out, counters, n, chunk_bytes,
                     src_row_bytes + src_own_bytes, stream);
}

// The bidirectional gather's entry: src is (n, chunk_bytes), one own chunk
// a row; the same launch as direct_all_gather's plain mode.
extern "C" int direct_all_gather_bidir(const void* src, void* out,
                                       void* counters, int n,
                                       long long chunk_bytes, void* stream) {
  return gather_rows(src, out, counters, n, chunk_bytes, chunk_bytes, stream);
}
