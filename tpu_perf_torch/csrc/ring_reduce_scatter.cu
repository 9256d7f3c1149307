// Ring reduce-scatter, one ring step for every rank of the sim world.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_reduce_scatter_kernel` (with its
// tiled accumulate `_acc_add` and its neighbour barrier `_ring_barrier`).
//
// What it computes.  Rank d's buffer is row d of x, n chunks of `chunk`
// elements.  At ring step k rank d receives from its left neighbour
// L = d-1 the running partial of chunk r = (d-2-k) mod n (the chunk L
// forwards, s_L = (L-1-k) mod n), writes it to its staging row k (the
// "wire" copy the TPU kernel's remote DMA makes), and adds it into its own
// chunk r: out[d][r] = x[d][r] + partial.  After n-1 steps rank d owns the
// full sum of chunk d (psum_scatter(tiled=True) ownership).  Step 0 reads
// the partial from x, later steps from out; step 0 also copies the rank's
// own forwarded chunk (d-1) unreduced into out, so out matches the TPU
// kernel's output (its local copy of x) in every chunk.
//
// Ordering.  The host launches one grid per step on one stream, so stream
// order stands in for `_ring_barrier` and the per-step recv semaphores.
// Within a step the chunk a rank writes (r_d) is never the chunk its right
// neighbour reads from it (s_d = r_d + 1 mod n), so all ranks of a step run
// in one launch with no race.  No persistent kernel spins on flags: blocks
// of different ranks need not be resident together.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  Per step and rank
// it moves 4 chunks (read partial, write stage, read own chunk, write the
// sum) and does one add per element, far below the card's operation rate.
// The design keeps each element in registers between its loads and stores
// (no shared memory), moves 16 bytes per thread per access, and sums in
// float32 with one rounding to the working type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr long long kMaxBlocksX = 1024;  // blocks per rank; the loop strides

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rs_step(const T* __restrict__ x, T* out, T* __restrict__ stage,
        int n, long long chunk, int step) {
  using P = Pack<T, V>;
  const int d = blockIdx.y;
  const int left = (d + n - 1) % n;
  const int r = (d + 2 * n - 2 - step) % n;  // == the chunk `left` forwards
  const int own = (d + n - 1) % n;           // my chunk forwarded at step 0
  const long long row = (long long)n * chunk;
  const T* partial = (step == 0 ? x : out) + left * row + r * chunk;
  const T* mine = x + d * row + r * chunk;
  T* sum = out + d * row + r * chunk;
  T* wire = stage + ((long long)d * (n - 1) + step) * chunk;
  const long long units = chunk / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    const P p = reinterpret_cast<const P*>(partial)[u];
    reinterpret_cast<P*>(wire)[u] = p;
    const P m = reinterpret_cast<const P*>(mine)[u];
    P o;
#pragma unroll
    for (int i = 0; i < V; ++i) o.v[i] = from_f32<T>(to_f32(m.v[i]) + to_f32(p.v[i]));
    reinterpret_cast<P*>(sum)[u] = o;
    if (step == 0) {
      reinterpret_cast<P*>(out + d * row + own * chunk)[u] =
          reinterpret_cast<const P*>(x + d * row + own * chunk)[u];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* x, void* out, void* stage, int n, long long chunk,
           int step, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = chunk % V == 0 && aligned16(x) && aligned16(out) && aligned16(stage);
  const long long units = vec ? chunk / V : chunk;
  long long bx = (units + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  T* ss = static_cast<T*>(stage);
  if (vec) {
    rs_step<T, V><<<grid, kThreads, 0, stream>>>(xs, os, ss, n, chunk, step);
  } else {
    rs_step<T, 1><<<grid, kThreads, 0, stream>>>(xs, os, ss, n, chunk, step);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns cudaGetLastError().
extern "C" int ring_reduce_scatter_step(const void* x, void* out, void* stage,
                                        int n, long long chunk, int step,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, out, stage, n, chunk, step, s);
    case 1: return launch<__nv_bfloat16>(x, out, stage, n, chunk, step, s);
    case 2: return launch<__half>(x, out, stage, n, chunk, step, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
