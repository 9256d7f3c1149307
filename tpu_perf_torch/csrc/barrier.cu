// Global signal barrier over the ranks of the sim world, then a copy of
// each rank's row.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_barrier_kernel` (pl_barrier)
// with `_global_barrier`: every device signals all n devices (itself
// included) on a barrier semaphore and waits for n signals, then copies its
// one element, so that the chained carry depends on the barrier.
//
// What it computes.  One CTA per rank, all launched together with
// cudaLaunchCooperativeKernel, which guarantees that the n spinning CTAs
// are resident at once (if they cannot be, the launch fails instead of
// hanging).  CTA d:
//   1. adds 1 to every rank's arrival counter (n atomics, release order);
//   2. spins with acquire loads until its own counter reaches
//      n * generation;
//   3. copies row d of src to row d of out.
// The counters are a uint64 buffer the host wrapper owns, one per rank,
// never reset: the host passes the generation (launches so far, this one
// included) and advances it, so no reset can race a late arrival.
//
// A barrier that never completes must fail loudly: after about a second of
// spinning (the device's global timer) the CTA calls __trap(), which
// aborts the launch with an error the next synchronize reports.
//
// Bound on an H100: latency, not bytes (a few bytes per rank move).  The
// cost is the launch plus one round of device-scope atomics through L2;
// chip_smoke.py sets it beside an empty kernel's launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr unsigned long long kTimeoutNs = 1000000000ull;  // about a second

__device__ __forceinline__ void add_release(unsigned long long* p) {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(kThreads)
barrier_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
               unsigned long long* counters, int n, long long row_bytes,
               unsigned long long generation) {
  const int d = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int r = 0; r < n; ++r) add_release(counters + r);
    const unsigned long long target = (unsigned long long)n * generation;
    const unsigned long long t0 = now_ns();
    while (load_acquire(counters + d) < target) {
      if (now_ns() - t0 > kTimeoutNs) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  const long long base = (long long)d * row_bytes;
  for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) {
    out[base + i] = src[base + i];
  }
}

__global__ void empty_kernel() {}

}  // namespace

// src and out are (n, row_bytes) buffers, counters n uint64 words that only
// barrier launches on this stream touch.  generation is the number of
// launches on these counters, this one included.  Returns the launch's
// error, else cudaGetLastError().
extern "C" int barrier_rows(const void* src, void* out, void* counters, int n,
                            long long row_bytes, long long generation,
                            void* stream) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* o = static_cast<uint8_t*>(out);
  unsigned long long* c = static_cast<unsigned long long*>(counters);
  unsigned long long g = (unsigned long long)generation;
  void* args[] = {&s, &o, &c, &n, &row_bytes, &g};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)barrier_kernel, dim3((unsigned)n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// One launch of an empty kernel: the launch cost the barrier is set beside.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
