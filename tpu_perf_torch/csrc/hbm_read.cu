// Local device-memory read sweep for every rank of the sim world: every
// byte is pulled into shared memory and nothing is written.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_hbm_read_kernel`, the TPU's
// HBM->VMEM DMA sweep of `pl_hbm_read` (block by block into one scratch
// block, plus a `rem` tail; the output aliases the input).
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory, nbytes read once:
// nbytes / 3.35 TB/s.
//
// Design.  A read whose value is never used is dropped by the compiler, so
// loads by threads would time nothing.  A TMA bulk copy into shared memory
// cannot be dropped: each block owns 32 KiB pieces of its rank's row (rank
// = blockIdx.y, pieces strided over blockIdx.x), and one thread bulk-loads
// a piece into one buffer and waits on the mbarrier before the next (one
// stage, the JAX kernel's start-then-wait).  The pieces cover the JAX
// blocks and their `rem` tail exactly, so the traffic is the same; the
// piece is this kernel's own tile.  The op sizes each row to a 4 KiB
// multiple (as the TPU's DMA tiling forced), so every piece is 16-byte
// aligned; the entry point refuses anything else.

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kPiece = 32768;       // bytes per bulk load (this kernel's tile)
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

__global__ void __launch_bounds__(kThreads)
hbm_read_kernel(const uint8_t* __restrict__ src, long long row_bytes) {
  __shared__ __align__(128) uint8_t buf[kPiece];
  __shared__ uint64_t bar;
  if (threadIdx.x != 0) return;
  const long long pieces = (row_bytes + kPiece - 1) / kPiece;
  if ((long long)blockIdx.x >= pieces) return;
  const uint8_t* s = src + (long long)blockIdx.y * row_bytes;
  bulk::barrier_init(&bar);
  uint32_t phase = 0;
  for (long long p = blockIdx.x; p < pieces; p += gridDim.x) {
    const long long left = row_bytes - p * kPiece;
    const uint32_t bytes = left < kPiece ? (uint32_t)left : kPiece;
    bulk::load(buf, s + p * kPiece, bytes, &bar);
    bulk::wait(&bar, phase);
    phase ^= 1;
  }
}

}  // namespace

// src is an (n, row_bytes) byte buffer; src and row_bytes must be 16-byte
// aligned.  Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unaligned buffer.
extern "C" int hbm_read_rows(const void* src, int n, long long row_bytes,
                             void* stream) {
  if (!bulk::aligned(src) || (row_bytes & (bulk::kAlign - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  long long bx = (row_bytes + kPiece - 1) / kPiece;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  hbm_read_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), row_bytes);
  return (int)cudaGetLastError();
}
