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
// The copy is typeless: the host picks the widest word (16, 4, 2 or 1
// bytes) that divides both addresses and the row, so any payload dtype
// moves at 16 bytes per thread where it can.  Rows need not be 16-byte
// aligned (the default 456131-byte buffer is 456132 bytes of float32 per
// rank); such rows move in smaller words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

// The row length is in words of W.
template <typename W>
__global__ void __launch_bounds__(kThreads)
shift_rows(const W* __restrict__ src, W* __restrict__ out, int n,
           long long row, int shift) {
  const int d = blockIdx.y;
  const int from = ((d - shift) % n + n) % n;
  const W* s = src + (long long)from * row;
  W* o = out + (long long)d * row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < row; u += stride) {
    o[u] = s[u];
  }
}

template <typename W>
int launch(const void* src, void* out, int n, long long row_b, int shift,
           cudaStream_t stream) {
  const long long row = row_b / (long long)sizeof(W);
  long long bx = (row + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  shift_rows<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out), n, row, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// src and out are distinct (n, row_bytes) buffers.  Returns
// cudaGetLastError().
extern "C" int p2p_shift_rows(const void* src, void* out, int n,
                              long long row_bytes, int shift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)row_bytes;
  if ((bits & 15) == 0) return launch<uint4>(src, out, n, row_bytes, shift, s);
  if ((bits & 3) == 0) return launch<uint32_t>(src, out, n, row_bytes, shift, s);
  if ((bits & 1) == 0) return launch<uint16_t>(src, out, n, row_bytes, shift, s);
  return launch<uint8_t>(src, out, n, row_bytes, shift, s);
}
