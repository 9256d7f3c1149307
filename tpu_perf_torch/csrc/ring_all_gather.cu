// Ring all-gather, one ring step for every rank of the sim world.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_all_gather_kernel` (both modes,
// with its neighbour barrier `_ring_barrier`).
//
// What it computes.  Rank d's own chunk is src row d (in `src_full` mode,
// chunk d of the n-chunk row d: the all-gather phase of the ring
// all-reduce, whose input is the reduce-scatter phase's output).  At ring
// step k rank d receives chunk c = (d-1-k) mod n from its left neighbour
// L = d-1 and stores it at out[d][c]; L forwards what it received at step
// k-1 (its own chunk at step 0, read from src).  Step 0 also copies the
// rank's own chunk to out[d][d].  After n-1 steps (one step when n = 1)
// every row of out holds all n chunks.
//
// Ordering.  One launch per step on one stream: stream order stands in for
// `_ring_barrier` and the per-step recv semaphores.  Within a step rank d
// writes chunk d-1-k of its row while its right neighbour reads chunk d-k
// of it, so all ranks of a step share one launch with no race.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory; it does no
// arithmetic.  The copy is typeless: the host picks the widest word
// (16, 4, 2 or 1 bytes) that divides the chunk and the row offsets, so
// any payload dtype moves at 16 bytes per thread where it can.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

// Offsets and sizes are in words of W.
template <typename W>
__global__ void __launch_bounds__(kThreads)
ag_step(const W* __restrict__ src, W* out, int n, long long chunk,
        long long src_row, long long src_own, int step) {
  const int d = blockIdx.y;
  const int left = (d + n - 1) % n;
  const int c = ((left - step) % n + n) % n;  // the chunk `left` forwards
  const long long row = (long long)n * chunk;
  const W* from = step == 0 ? src + left * src_row + left * src_own
                            : out + left * row + c * chunk;
  W* to = out + d * row + c * chunk;
  const W* own_src = src + d * src_row + d * src_own;
  W* own_dst = out + d * row + (long long)d * chunk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < chunk; u += stride) {
    to[u] = from[u];
    if (step == 0) own_dst[u] = own_src[u];
  }
}

template <typename W>
int launch(const void* src, void* out, int n, long long chunk_b,
           long long src_row_b, long long src_own_b, int step,
           cudaStream_t stream) {
  const long long chunk = chunk_b / sizeof(W);
  long long bx = (chunk + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  ag_step<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out), n, chunk,
      src_row_b / (long long)sizeof(W), src_own_b / (long long)sizeof(W), step);
  return (int)cudaGetLastError();
}

}  // namespace

// Sizes in bytes.  src row d starts at d*src_row_bytes and its own chunk
// at a further d*src_own_bytes (0 unless src_full).  Returns
// cudaGetLastError().
extern "C" int ring_all_gather_step(const void* src, void* out, int n,
                                    long long chunk_bytes,
                                    long long src_row_bytes,
                                    long long src_own_bytes, int step,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)chunk_bytes | (uintptr_t)src_row_bytes |
                         (uintptr_t)src_own_bytes;
  if ((bits & 15) == 0) return launch<uint4>(src, out, n, chunk_bytes, src_row_bytes, src_own_bytes, step, s);
  if ((bits & 3) == 0) return launch<uint32_t>(src, out, n, chunk_bytes, src_row_bytes, src_own_bytes, step, s);
  if ((bits & 1) == 0) return launch<uint16_t>(src, out, n, chunk_bytes, src_row_bytes, src_own_bytes, step, s);
  return launch<uint8_t>(src, out, n, chunk_bytes, src_row_bytes, src_own_bytes, step, s);
}
