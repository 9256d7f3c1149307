// Serialized round trip between the two groups of the sim world, one leg
// per launch.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_pingpong_kernel` (pl_pingpong),
// the blocking ping-pong of the reference (mpi_perf.c:66-83) done with
// remote DMA: group 0 (ranks d < n/2) sends its buffer into its partner's
// stage; the partner (d + n/2), once the payload has landed, sends it
// straight back into group 0's output.  Group 1 keeps its own payload by a
// local copy, so the op is the identity on both groups and chains.
//
// What it computes, per leg (half = n/2):
//   leg 1, ranks 0..n-1:  d < half:  stage[d + half] = x[d]
//                         d >= half: out[d] = x[d]   (the local keep-own copy)
//   leg 2, ranks 0..half-1:          out[d] = stage[d + half]
// Stage rows below half are not written, as on the TPU, where group 0's
// stage output is never a target.
//
// Ordering.  The TPU kernel's return leg starts only after `fwd.wait_recv()`
// on the partner: the payload must have arrived before it can go back.
// Here the two legs are two launches on one stream, and stream order is
// that dependence.  (One launch handing off through a flag would save a
// launch per round trip; that is later, performance work.)
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  The function reads
// x once and writes out once (2 * n * row_bytes); the schedule moves
// 3 * n * row_bytes, since group 0's payload passes through the stage.
// The copy is typeless, in the widest word (16, 4, 2 or 1 bytes) that
// divides the three addresses and the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

// The row length is in words of W.  Stage is written by leg 1 and read by
// leg 2, so its pointer carries no __restrict__.
template <typename W>
__global__ void __launch_bounds__(kThreads)
pingpong_leg_kernel(const W* __restrict__ x, W* out, W* stage, int n,
                    long long row, int leg) {
  const int half = n / 2;
  const int d = blockIdx.y;
  const W* s;
  W* o;
  if (leg == 1) {
    s = x + (long long)d * row;
    o = d < half ? stage + (long long)(d + half) * row
                 : out + (long long)d * row;
  } else {
    s = stage + (long long)(d + half) * row;
    o = out + (long long)d * row;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < row; u += stride) {
    o[u] = s[u];
  }
}

template <typename W>
int launch(const void* x, void* out, void* stage, int n, long long row_b,
           int leg, cudaStream_t stream) {
  const long long row = row_b / (long long)sizeof(W);
  long long bx = (row + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  // leg 1 covers every rank, leg 2 only group 0
  const dim3 grid((unsigned)bx, (unsigned)(leg == 1 ? n : n / 2));
  pingpong_leg_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), static_cast<W*>(stage),
      n, row, leg);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out and stage are distinct (n, row_bytes) buffers, n even; leg is 1 or
// 2.  Returns cudaGetLastError().
extern "C" int pingpong_leg(const void* x, void* out, void* stage, int n,
                            long long row_bytes, int leg, void* stream) {
  if ((leg != 1 && leg != 2) || n < 2 || n % 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(stage) |
                         (uintptr_t)row_bytes;
  if ((bits & 15) == 0) return launch<uint4>(x, out, stage, n, row_bytes, leg, s);
  if ((bits & 3) == 0) return launch<uint32_t>(x, out, stage, n, row_bytes, leg, s);
  if ((bits & 1) == 0) return launch<uint16_t>(x, out, stage, n, row_bytes, leg, s);
  return launch<uint8_t>(x, out, stage, n, row_bytes, leg, s);
}
