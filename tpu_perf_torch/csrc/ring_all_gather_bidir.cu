// Bidirectional ring all-gather, one ring step for every rank of the sim
// world.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_all_gather_bidir_kernel` (with
// its neighbour barrier `_ring_barrier`).
//
// What it computes.  Rank d's own chunk is src row d, of an even length
// split into two halves.  First halves travel clockwise, second halves
// counter-clockwise: at ring step k rank d stores the first half of chunk
// (d-1-k) mod n from its left neighbour d-1 and the second half of chunk
// (d+1+k) mod n from its right neighbour d+1, each forwarding what it
// received at step k-1 (its own chunk, read from src, at step 0).  Step 0
// also copies the rank's own chunk to out[d][d].  After n-1 steps (one
// step when n = 1, which only places the own chunk) every row of out holds
// all n chunks.
//
// Ordering.  One launch per step on one stream: stream order stands in for
// `_ring_barrier` and the per-step recv semaphores.  Within a step rank d
// writes the first half of chunk d-1-k and the second half of chunk d+1+k
// of its row, while its right neighbour reads the first half of chunk d-k
// and its left neighbour the second half of chunk d+k of it, so all ranks
// of a step share one launch with no race.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory; it does no
// arithmetic.  Inside one card both directions are copies in the same
// device memory, so the split buys nothing over `ring_all_gather.cu`: it
// moves the same bytes.  The copy is typeless: the host picks the widest
// word (16, 4, 2 or 1 bytes) that divides both addresses and the
// half-chunk, which in bfloat16 and uint8 is rarely 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

// Sizes are in words of W; chunk = 2 * half.
template <typename W>
__global__ void __launch_bounds__(kThreads)
bidir_step(const W* __restrict__ src, W* out, int n, long long half,
           int step) {
  const int d = blockIdx.y;
  const int left = (d + n - 1) % n;
  const int right = (d + 1) % n;
  const int cw = ((left - step) % n + n) % n;  // the chunk `left` forwards
  const int ccw = (right + step) % n;          // the chunk `right` forwards
  const long long chunk = 2 * half;
  const long long row = (long long)n * chunk;
  const W* cw_from = step == 0 ? src + left * chunk
                               : out + left * row + cw * chunk;
  const W* ccw_from = (step == 0 ? src + right * chunk
                                 : out + right * row + ccw * chunk) + half;
  W* cw_to = out + d * row + cw * chunk;
  W* ccw_to = out + d * row + ccw * chunk + half;
  const W* own_src = src + d * chunk;
  W* own_dst = out + d * row + (long long)d * chunk;
  const bool ring = n > 1;  // one rank only places its own chunk
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < half; u += stride) {
    if (ring) {
      cw_to[u] = cw_from[u];
      ccw_to[u] = ccw_from[u];
    }
    if (step == 0) {
      own_dst[u] = own_src[u];
      own_dst[half + u] = own_src[half + u];
    }
  }
}

template <typename W>
int launch(const void* src, void* out, int n, long long half_b, int step,
           cudaStream_t stream) {
  const long long half = half_b / (long long)sizeof(W);
  long long bx = (half + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  bidir_step<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(out), n, half, step);
  return (int)cudaGetLastError();
}

}  // namespace

// src is (n, 2 * half_bytes), out (n, n * 2 * half_bytes); sizes in bytes.
// Returns cudaGetLastError().
extern "C" int ring_all_gather_bidir_step(const void* src, void* out, int n,
                                          long long half_bytes, int step,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)half_bytes;
  if ((bits & 15) == 0) return launch<uint4>(src, out, n, half_bytes, step, s);
  if ((bits & 3) == 0) return launch<uint32_t>(src, out, n, half_bytes, step, s);
  if ((bits & 1) == 0) return launch<uint16_t>(src, out, n, half_bytes, step, s);
  return launch<uint8_t>(src, out, n, half_bytes, step, s);
}
