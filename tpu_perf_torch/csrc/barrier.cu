// Global signal barrier over the ranks of the sim world, then a copy of
// each rank's row, on Hopper's thread-block cluster barrier.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_barrier_kernel` (pl_barrier)
// with `_global_barrier`: every device signals all n devices (itself
// included) on a barrier semaphore and waits for n signals, then copies its
// one element, so that the chained carry depends on the barrier.
//
// What it computes.  The n ranks are laid out over one thread-block
// cluster of C = min(n, 8) CTAs (the portable cluster size) with W =
// ceil(n / C) warps each: rank r is warp r % W of CTA r / W (the host
// computes C and W, `barrier_layout` in ops/pallas_ring.py).  At the path's
// n = 8 that is one CTA per rank, the TPU kernel's own picture; up to
// 8 x 32 = 256 ranks fit.  Every thread of the cluster arrives on the
// hardware cluster barrier with release semantics and waits on it with
// acquire semantics: "signal all n ranks, wait for n signals" in one
// instruction pair.  Then each rank's warp copies its row of src to out.
//
// State.  None is kept between launches: no counters, no generation.  The
// hardware co-schedules the CTAs of a cluster on one GPC, so no CTA can
// wait for one that is not resident; a cluster the card cannot hold is
// refused at launch (an error the wrapper raises), and the wrapper asks
// cudaOccupancyMaxActiveClusters before its first launch of a layout.
// There is nothing to time out.
//
// Bound on an H100: latency, not bytes (a few bytes per rank move).  The
// cost is the launch plus one cluster barrier, a round through the SMs'
// distributed shared-memory network; chip_smoke.py sets it beside an empty
// kernel's launch, back to back from the host and replayed in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void barrier_kernel(const uint8_t* __restrict__ src,
                               uint8_t* __restrict__ out, int n, int warps,
                               long long row_bytes) {
  // every thread takes part, those of warps past rank n - 1 included
  cluster_barrier();
  const int rank = blockIdx.x * warps + (int)(threadIdx.x / 32);
  if (rank >= n) return;
  const long long base = (long long)rank * row_bytes;
  for (long long i = threadIdx.x % 32; i < row_bytes; i += 32) {
    out[base + i] = src[base + i];
  }
}

__global__ void empty_kernel() {}

cudaLaunchConfig_t cluster_config(int ctas, int warps, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)ctas);
  config.blockDim = dim3((unsigned)(32 * warps));
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

// How many clusters of `ctas` CTAs of `warps` warps the current device can
// hold at once, into *clusters (0: the barrier cannot launch).  Returns the
// query's error, else cudaGetLastError().
extern "C" int barrier_max_active_clusters(int ctas, int warps, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(ctas, warps, 0, &attr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      clusters, (const void*)barrier_kernel, &config);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// src and out are (n, row_bytes) buffers; n ranks over `ctas` CTAs of
// `warps` warps, ctas <= 8, ctas * warps >= n.  Returns the launch's error,
// else cudaGetLastError().
extern "C" int barrier_rows(const void* src, void* out, int n, int ctas,
                            int warps, long long row_bytes, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(
      ctas, warps, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, barrier_kernel, static_cast<const uint8_t*>(src),
      static_cast<uint8_t*>(out), n, warps, row_bytes);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// One launch of an empty kernel: the launch cost the barrier is set beside.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
