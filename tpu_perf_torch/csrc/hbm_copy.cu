// Local device-memory copy, out = x, for every rank of the sim world.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_hbm_copy_kernel`, the TPU's one
// full-buffer HBM->HBM async DMA of `pl_hbm_copy`.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  Each byte is read
// once and written once, so the least time is 2 * nbytes / 3.35 TB/s.
//
// Design.  The TPU kernel hands the whole copy to the DMA engine; Hopper's
// counterpart is the TMA bulk copy, so the data never passes through the
// threads' registers.  Each block owns 32 KiB pieces of its rank's row
// (rank = blockIdx.y, pieces strided over blockIdx.x): one thread bulk-loads
// a piece into shared memory, waits on the mbarrier, bulk-stores it and
// waits until the store has read the buffer before loading the next piece
// (one stage, like the JAX kernel's start-then-wait).  Many resident
// blocks per SM keep enough pieces in flight to fill the memory pipe.
//
// Alignment.  A bulk copy needs 16-byte aligned addresses and sizes, but
// `pl_hbm_copy` only rounds to the itemsize (the default 456131-byte
// buffer is 456132 bytes), so at n > 1 a row starts at an unaligned
// offset.  Each row is cut into an unaligned head, a 16-byte aligned body
// (bulk) and a tail shorter than 16 bytes; head and tail are copied by
// plain byte stores.  Where source and destination are misaligned to each
// other no bulk copy is possible, and the whole row goes by plain stores.

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kPiece = 32768;       // bytes per bulk copy (this kernel's tile)
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

__global__ void __launch_bounds__(kThreads)
hbm_copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                long long row_bytes) {
  __shared__ __align__(128) uint8_t buf[kPiece];
  __shared__ uint64_t bar;
  const long long base = (long long)blockIdx.y * row_bytes;
  const uint8_t* s = src + base;
  uint8_t* d = dst + base;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  const uintptr_t da = reinterpret_cast<uintptr_t>(d);
  long long head = row_bytes, body = 0;
  if (((sa ^ da) & (bulk::kAlign - 1)) == 0) {
    head = (long long)((bulk::kAlign - (sa & (bulk::kAlign - 1))) & (bulk::kAlign - 1));
    if (head > row_bytes) head = row_bytes;
    body = (row_bytes - head) & ~(bulk::kAlign - 1);
  }
  // plain stores: [0, head) and the tail [head + body, row_bytes)
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < head; i += stride) d[i] = s[i];
  for (long long i = head + body + first; i < row_bytes; i += stride) d[i] = s[i];

  if (threadIdx.x != 0 || body == 0) return;
  const long long pieces = (body + kPiece - 1) / kPiece;
  if ((long long)blockIdx.x >= pieces) return;
  bulk::barrier_init(&bar);
  uint32_t phase = 0;
  for (long long p = blockIdx.x; p < pieces; p += gridDim.x) {
    const long long off = head + p * kPiece;
    const long long left = body - p * kPiece;
    const uint32_t bytes = left < kPiece ? (uint32_t)left : kPiece;
    bulk::load(buf, s + off, bytes, &bar);
    bulk::wait(&bar, phase);
    phase ^= 1;
    bulk::store(d + off, buf, bytes);
    bulk::commit();
    bulk::wait_read();
  }
  bulk::wait_done();
}

}  // namespace

// src and dst are (n, row_bytes) byte buffers.  Returns cudaGetLastError().
extern "C" int hbm_copy_rows(const void* src, void* dst, int n,
                             long long row_bytes, void* stream) {
  long long bx = (row_bytes + kPiece - 1) / kPiece;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  hbm_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), row_bytes);
  return (int)cudaGetLastError();
}
