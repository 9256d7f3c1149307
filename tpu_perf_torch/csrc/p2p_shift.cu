// Row shift for the point-to-point ops, every rank of the sim world in one
// launch.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_ring_kernel` (pl_ring: each
// device sends its buffer to (my+1) mod n, after the neighbour barrier
// `_ring_barrier`) and `_exchange_kernel` (pl_exchange: each device swaps
// its buffer with my + n/2, after the pair barrier `_pair_barrier`).
//
// What it computes.  out[d] = src[(d - shift) mod n] for every rank d:
// shift 1 is the ring, shift n/2 the exchange.  The wrappers count the two
// ops apart (kernels.LAUNCHES["ring"] and ["exchange"]).
//
// Ordering.  On the TPU a device meets its partners at a barrier before the
// remote copy, so that no write lands in a buffer its owner is still using.
// Here src and out are distinct buffers and the kernels of one stream run
// in order, so the launch boundary stands in for both barriers: all ranks
// of one execution share one launch with no race.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  Each byte is read
// once and written once, 2 * n * row_bytes in all; there is no arithmetic.
//
// Design (row_copy.cuh).  All n rows form one list of n * F tiles of 8 KB,
// F tiles a row: tile (d, t) copies tile t of source row (d - shift) mod n
// into row d.  A persistent grid (four CTAs an SM, no more than the tiles)
// takes the tiles in address order from a device counter, so row 7 is
// copied beside row 0 from the start and no tail wave is left.  The
// copy is typeless: the host picks the widest word (16, 4, 2 or 1 bytes)
// that divides both addresses and the row, so any payload dtype moves at
// 16 bytes per thread where it can.  Rows need not be 16-byte aligned (the
// default 456131-byte buffer is 456132 bytes of float32 per rank); such
// rows move in smaller words.

#include "row_copy.cuh"

namespace {

using row_copy::kThreads;

// The row length is in words of W; `per_row` tiles a row.
template <typename W>
__global__ void __launch_bounds__(kThreads)
shift_rows(const W* __restrict__ src, W* __restrict__ out,
           unsigned int* counters, int n, long long row, int shift,
           unsigned int per_row) {
  row_copy::for_each_tile(
      counters, (unsigned int)n * per_row, [&](unsigned int t) {
        const int d = (int)(t / per_row);
        const long long t0 = (long long)(t - (unsigned int)d * per_row) *
                             row_copy::kTileWords<W>;
        const int from = d >= shift ? d - shift : d - shift + n;
        row_copy::copy_tile(src + (long long)from * row,
                            out + (long long)d * row, row, t0);
      });
}

template <typename W>
int launch(const void* src, void* out, void* counters, int n, long long row_b,
           int shift, cudaStream_t stream) {
  static int resident_cache[row_copy::kMaxDevices] = {0};
  cudaError_t err = cudaSuccess;
  const int resident =
      row_copy::resident_ctas((const void*)shift_rows<W>, resident_cache, &err);
  if (err != cudaSuccess) return (int)err;
  const long long row = row_b / (long long)sizeof(W);
  constexpr long long tile = row_copy::kTileWords<W>;
  const long long per_row = (row + tile - 1) / tile;
  const int grid = row_copy::grid_for(n * per_row, resident, &err);
  if (err != cudaSuccess) return (int)err;
  shift_rows<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out),
      static_cast<unsigned int*>(counters), n, row, shift,
      (unsigned int)per_row);
  return (int)cudaGetLastError();
}

}  // namespace

// src and out are distinct (n, row_bytes) buffers, 0 <= shift < n;
// counters is 2 uint32 words, zero, that only launches ordered on one
// stream touch (the kernel leaves them zero).  Returns the occupancy
// query's error, else cudaGetLastError().
extern "C" int p2p_shift_rows(const void* src, void* out, void* counters,
                              int n, long long row_bytes, int shift,
                              void* stream) {
  if (n < 1 || shift < 0 || shift >= n || row_bytes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)row_bytes;
  if ((bits & 15) == 0) {
    return launch<uint4>(src, out, counters, n, row_bytes, shift, s);
  }
  if ((bits & 3) == 0) {
    return launch<uint32_t>(src, out, counters, n, row_bytes, shift, s);
  }
  if ((bits & 1) == 0) {
    return launch<uint16_t>(src, out, counters, n, row_bytes, shift, s);
  }
  return launch<uint8_t>(src, out, counters, n, row_bytes, shift, s);
}
