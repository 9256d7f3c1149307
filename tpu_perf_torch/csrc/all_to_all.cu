// Direct all-to-all, every (destination, source) pair of the sim world in
// one launch.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_all_to_all_direct_kernel` (with
// its global barrier `_global_barrier`).
//
// What it computes.  Every rank's row is n chunks; chunk d of rank s goes
// to rank d at slot s: out[d][s] = src[s][d], the chunk transpose.  On the
// TPU each device starts its local copy and all n-1 remote copies before
// it waits for any; here block (x, d, s) of the grid copies chunk d of
// rank s, so every pair is in flight at once.
//
// Ordering.  `_global_barrier` only makes sure every peer's output buffer
// is ready before remote writes land.  Here src and out are distinct
// buffers and the kernels of one stream run in order, so the launch
// boundary does that job; the signal barrier of `barrier.cu` would guard
// nothing inside one card and would add its launch path to every
// execution.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  Each byte is read
// once and written once, 2 * n * row_bytes in all; there is no arithmetic.
// The copy is typeless: the host picks the widest word (16, 4, 2 or 1
// bytes) that divides both addresses and the chunk, so any payload dtype
// moves at 16 bytes per thread where it can.  Chunks are often not 16-byte
// aligned (uint8 at 150 B over 8 ranks is 19-byte chunks); such chunks move
// in smaller words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr long long kTargetBlocks = 4096;  // over all pairs; the loop strides

// The chunk length is in words of W.
template <typename W>
__global__ void __launch_bounds__(kThreads)
transpose_chunks(const W* __restrict__ src, W* __restrict__ out, int n,
                 long long chunk) {
  const int d = blockIdx.y;  // destination rank
  const int s = blockIdx.z;  // source rank
  const long long row = (long long)n * chunk;
  const W* from = src + s * row + (long long)d * chunk;
  W* to = out + d * row + (long long)s * chunk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < chunk; u += stride) {
    to[u] = from[u];
  }
}

template <typename W>
int launch(const void* src, void* out, int n, long long chunk_b,
           cudaStream_t stream) {
  const long long chunk = chunk_b / (long long)sizeof(W);
  const long long pairs = (long long)n * n;
  long long bx = (chunk + kThreads - 1) / kThreads;
  if (bx > kTargetBlocks / pairs) bx = kTargetBlocks / pairs;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n, (unsigned)n);
  transpose_chunks<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out), n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// src and out are distinct (n, n * chunk_bytes) buffers.  Returns
// cudaGetLastError().
extern "C" int all_to_all_rows(const void* src, void* out, int n,
                               long long chunk_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)chunk_bytes;
  if ((bits & 15) == 0) return launch<uint4>(src, out, n, chunk_bytes, s);
  if ((bits & 3) == 0) return launch<uint32_t>(src, out, n, chunk_bytes, s);
  if ((bits & 1) == 0) return launch<uint16_t>(src, out, n, chunk_bytes, s);
  return launch<uint8_t>(src, out, n, chunk_bytes, s);
}
