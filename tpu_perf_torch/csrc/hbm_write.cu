// Local device-memory write sweep for every rank of the sim world: the
// first block of each row, tiled over the whole output row (the tiling cut
// at the row's end).
//
// Replaces: tpu_perf/ops/pallas_ring.py `_hbm_write_kernel`, the TPU's
// VMEM->HBM DMA sweep of `pl_hbm_write` (one scratch block seeded once from
// the input's first block, DMA'd over every output block and a `rem`
// tail).
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory, nbytes written plus
// one block read: (nbytes + block) / 3.35 TB/s.
//
// Design.  The block is part of the op's function (the JAX package's
// `hbm_dma_block_elems`, 2 MiB of float32), and it does not fit in the
// 227 KB of shared memory a CUDA block may have.  So the block is cut into
// 16 KiB column slices (this kernel's own tile).  A CUDA block takes one
// slice of its rank's seed (rank = blockIdx.y): one thread bulk-loads the
// slice once, then bulk-stores it into that column of every output block
// it owns, and of the `rem` tail, with no wait between stores (the shared
// buffer is never written again).  "Seed once, write many" holds per
// block: where slices alone would leave SMs idle, the output blocks are
// dealt out to `groups` blocks per slice, each of which loads its slice
// once; device-memory traffic is nbytes written plus `groups` blocks read.

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kSlice = 16384;  // bytes of the seed block per CUDA block
constexpr long long kTargetBlocks = 264;  // two per SM of an H100

__global__ void __launch_bounds__(kThreads)
hbm_write_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 long long row_bytes, long long block_bytes, int groups) {
  __shared__ __align__(128) uint8_t buf[kSlice];
  __shared__ uint64_t bar;
  if (threadIdx.x != 0) return;
  const long long slices = (block_bytes + kSlice - 1) / kSlice;
  const long long slice = blockIdx.x % slices;
  const long long group = blockIdx.x / slices;
  const long long nblocks = row_bytes / block_bytes;
  const long long rem = row_bytes - nblocks * block_bytes;
  const long long targets = nblocks + (rem > 0 ? 1 : 0);
  if (group >= targets) return;
  const long long col = slice * kSlice;
  const long long left = block_bytes - col;
  const uint32_t width = left < kSlice ? (uint32_t)left : kSlice;
  const long long base = (long long)blockIdx.y * row_bytes;
  bulk::barrier_init(&bar);
  bulk::load(buf, src + base + col, width, &bar);
  bulk::wait(&bar, 0);
  for (long long b = group; b < targets; b += groups) {
    long long bytes = width;
    if (b == nblocks) {  // the rem tail: the seed's first rem bytes
      bytes = rem - col;
      if (bytes > width) bytes = width;
      if (bytes <= 0) continue;
    }
    bulk::store(dst + base + b * block_bytes + col, buf, (uint32_t)bytes);
  }
  bulk::commit();
  bulk::wait_done();
}

}  // namespace

// src and dst are (n, row_bytes) byte buffers; the seed is the first
// block_bytes of each src row.  Both buffers, row_bytes and block_bytes must
// be 16-byte aligned, with block_bytes <= row_bytes.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it refuses.
extern "C" int hbm_write_rows(const void* src, void* dst, int n,
                              long long row_bytes, long long block_bytes,
                              void* stream) {
  if (!bulk::aligned(src) || !bulk::aligned(dst) ||
      ((row_bytes | block_bytes) & (bulk::kAlign - 1)) != 0 ||
      block_bytes <= 0 || block_bytes > row_bytes)
    return (int)cudaErrorInvalidValue;
  const long long slices = (block_bytes + kSlice - 1) / kSlice;
  const long long nblocks = row_bytes / block_bytes;
  const long long targets = nblocks + (row_bytes % block_bytes ? 1 : 0);
  long long groups = (kTargetBlocks + slices * n - 1) / (slices * n);
  if (groups > targets) groups = targets;
  if (groups < 1) groups = 1;
  const dim3 grid((unsigned)(slices * groups), (unsigned)n);
  hbm_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), row_bytes,
      block_bytes, (int)groups);
  return (int)cudaGetLastError();
}
