// Local device-memory copy, out = x, for every rank of the sim world.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_hbm_copy_kernel`, the TPU's one
// full-buffer HBM->HBM async DMA of `pl_hbm_copy`.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  Each byte is read
// once and written once, so the least time is 2 * nbytes / 3.35 TB/s.
//
// Design (row_copy.cuh), the row shift's routine at shift 0.  All n rows
// form one list of n * F tiles of 8 KB, F tiles a row, and a persistent
// grid (four CTAs an SM, no more than the tiles) takes them in address
// order from a device counter; each tile goes through registers, two
// 16-byte words in flight a thread.  The TPU kernel hands the copy to its
// DMA engine, whose Hopper counterpart is the TMA bulk copy; bulk copies
// through a ring of shared-memory stages, with the same tiles in order,
// trailed this design at every piece size and stage count tried
// (python -m tpu_perf_torch.tools.row_copy_designs times both), so the
// copy goes through registers.
//
// Alignment.  `pl_hbm_copy` only rounds to the itemsize (the default
// 456131-byte buffer is 456132 bytes), so at n > 1 a row starts at an
// unaligned offset.  Each row is cut into an unaligned head, a 16-byte
// aligned body (the tiles, in 16-byte words) and a tail shorter than 16
// bytes; the CTA that takes a row's first tile copies head and tail by
// plain byte stores.  Where source and destination are misaligned to each
// other, each tile goes by plain byte stores.

#include "row_copy.cuh"

namespace {

using row_copy::kThreads;
constexpr long long kTile = row_copy::kTileBytes;

__global__ void __launch_bounds__(kThreads)
copy_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
          unsigned int* counters, int n, long long row_bytes,
          unsigned int per_row) {
  row_copy::for_each_tile(
      counters, (unsigned int)n * per_row, [&](unsigned int t) {
        const unsigned int r = t / per_row;
        const long long k = (long long)(t - r * per_row);
        const uint8_t* s = src + (long long)r * row_bytes;
        uint8_t* d = dst + (long long)r * row_bytes;
        const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
        if ((sa ^ reinterpret_cast<uintptr_t>(d)) & 15) {
          // one byte a thread at a time: a register tile of bytes would
          // take registers, and so residency, from every tile
          const long long end = (k + 1) * kTile < row_bytes ? (k + 1) * kTile
                                                            : row_bytes;
          for (long long i = k * kTile + threadIdx.x; i < end; i += kThreads) {
            d[i] = s[i];
          }
          return;
        }
        long long head = (long long)((16 - (sa & 15)) & 15);
        if (head > row_bytes) head = row_bytes;
        const long long words = (row_bytes - head) / 16;
        row_copy::copy_tile(reinterpret_cast<const uint4*>(s + head),
                            reinterpret_cast<uint4*>(d + head), words,
                            k * row_copy::kTileWords<uint4>);
        if (k == 0) {
          // head [0, head) by threads 0-15, tail [head + 16 * words,
          // row_bytes) by threads 16-31: under 16 bytes each
          const long long i = threadIdx.x < 16
                                  ? (long long)threadIdx.x
                                  : head + 16 * words + threadIdx.x - 16;
          if ((threadIdx.x < 16 && i < head) ||
              (threadIdx.x >= 16 && threadIdx.x < 32 && i < row_bytes)) {
            d[i] = s[i];
          }
        }
      });
}

}  // namespace

// src and dst are (n, row_bytes) byte buffers; counters is 2 uint32 words,
// zero, that only launches ordered on one stream touch (the kernel leaves
// them zero).  Returns the occupancy query's error, else
// cudaGetLastError().
extern "C" int hbm_copy_rows(const void* src, void* dst, void* counters, int n,
                             long long row_bytes, void* stream) {
  if (n < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  static int resident_cache[row_copy::kMaxDevices] = {0};
  cudaError_t err = cudaSuccess;
  const int resident =
      row_copy::resident_ctas((const void*)copy_rows, resident_cache, &err);
  if (err != cudaSuccess) return (int)err;
  const long long per_row = (row_bytes + kTile - 1) / kTile;
  const int grid = row_copy::grid_for(n * per_row, resident, &err);
  if (err != cudaSuccess) return (int)err;
  copy_rows<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<unsigned int*>(counters), n, row_bytes,
      (unsigned int)per_row);
  return (int)cudaGetLastError();
}
