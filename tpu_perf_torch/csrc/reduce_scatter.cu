// Reduce-scatter over the ranks of the sim world as one direct reduce: every
// rank's owned chunk in one launch.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_reduce_scatter_kernel` (with its
// tiled accumulate `_acc_add` and its neighbour barrier `_ring_barrier`).
//
// What it computes.  Rank s's buffer is row s of x, n chunks of `chunk`
// elements.  Rank d owns chunk d (psum_scatter(tiled=True) ownership):
// out[d] = sum over s of x[s][d*chunk : (d+1)*chunk], out of shape
// (n, chunk).  On the TPU the ring forwards the partial of chunk c from rank
// c+1 round to rank c, and each rank adds its own chunk to the partial that
// arrives (`_acc_add`: own + incoming).  Float addition is commutative, so
// the TPU's sum of chunk c is
//     ((x[c+1] + x[c+2]) + x[c+3]) + ... + x[c+n]      (ranks mod n),
// rounded to the working type after every add.  This kernel adds in exactly
// that order, rounding after every add, so in float32 it is bit-identical to
// the ring (and to the plain version), and in bfloat16 and float16 it
// rounds where `_acc_add` rounds.
//
// Why no ring.  In the sim world all ranks share one allocation, so the
// ring's n-1 steps (each reading a partial, writing it to a staging row,
// reading the own chunk and writing the sum) are traffic the function does
// not need: 7.5 GiB at 8 ranks x 256 MiB where the function needs 2.25 GiB.
// A multi-card world reads peer chunks over NVLink the same way (symmetric
// memory), so the direct reduce has a counterpart there.
//
// The carry's epilogue.  Both JAX carries scale the owned chunk by 1/n
// (`pl_reduce_scatter` tiles it over the row, `pl_allreduce` gathers it
// first; the gather only moves values), so the kernel takes them: each
// reduced element is multiplied by `scale` (1/n already rounded to the
// dtype) and rounded once more, and the unit is stored `tiles` times along
// the owner's output row (tiles = 1: out is (n, chunk); tiles = n: out is
// (n, n*chunk), row c chunk c's scaled sum n times, JAX's
// `jnp.tile(mine * inv, n)`).  A product of two bfloat16 or two float16
// values is exact in float32, so that one rounding is the framework's
// multiply in the dtype; __fmul_rn keeps the compiler from fusing the last
// add into it.  A scale of 1.0 changes no bit.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  x is read once and
// each rank's output row written once, (n*n*chunk + tiles*n*chunk)
// elements; one add per element read and one multiply per reduced element,
// far below the card's operation rate.  The design:
// one thread owns one 16-byte unit of one owned chunk and issues the loads
// of all n ranks' units (up to kGroup at a time) before it adds, so n x 16
// bytes per thread are in flight; a grid-stride loop over (chunk, unit)
// sized to the SMs keeps every SM streaming; registers only, no staging
// buffer and no shared memory.  Chunks whose element count or addresses are
// not 16-byte aligned take the same loop one element per thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kBlocksPerSm = 8;    // grid = SMs x this, the loop strides
constexpr int kGroup = 8;          // rank loads issued before their adds

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

// One unit is V consecutive elements; block row c of the grid owns chunk c.
// Unit u of out[c] is the sum over ring offsets j = 1..n of unit u of
// x[(c + j) % n][c], taken in that order, times scale; it is stored at
// tiles offsets chunk apart along out's row c.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
direct_reduce(const T* __restrict__ x, T* __restrict__ out, int n,
              long long chunk, float scale, int tiles) {
  using P = Pack<T, V>;
  const int c = blockIdx.y;  // the owned chunk, and its owner
  const long long units = chunk / V;
  const long long row = (long long)n * chunk;
  T* const out_row = out + (long long)c * tiles * chunk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    const long long off = (long long)c * chunk + u * V;
    P acc;
    for (int j0 = 1; j0 <= n; j0 += kGroup) {
      P v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = j0 + g;
        if (j <= n) {
          const int s = c + j < n ? c + j : c + j - n;
          v[g] = *reinterpret_cast<const P*>(x + s * row + off);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = j0 + g;
        if (j == 1) {
          acc = v[g];
        } else if (j <= n) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc.v[e] = from_f32<T>(to_f32(acc.v[e]) + to_f32(v[g].v[e]));
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc.v[e] = from_f32<T>(__fmul_rn(to_f32(acc.v[e]), scale));
    }
    for (int t = 0; t < tiles; ++t) {
      *reinterpret_cast<P*>(out_row + t * chunk + u * V) = acc;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* x, void* out, int n, long long chunk, float scale,
           int tiles, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = chunk % V == 0 && aligned16(x) && aligned16(out);
  const long long units = vec ? chunk / V : chunk;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // about kBlocksPerSm blocks per SM over all n owned chunks
  long long bx = (units + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm / n;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)n);
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  if (vec) {
    direct_reduce<T, V><<<grid, kThreads, 0, stream>>>(xs, os, n, chunk,
                                                       scale, tiles);
  } else {
    direct_reduce<T, 1><<<grid, kThreads, 0, stream>>>(xs, os, n, chunk,
                                                       scale, tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x is (n, n * chunk), out (n, tiles * chunk), both contiguous and
// distinct; tiles is 1 or n.  scale is exact in the dtype.  dtype: 0
// float32, 1 bfloat16, 2 float16.  Returns cudaGetLastError().
extern "C" int direct_reduce_scatter(const void* x, void* out, int n,
                                     long long chunk, int dtype, float scale,
                                     int tiles, void* stream) {
  if (tiles != 1 && tiles != n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, out, n, chunk, scale, tiles, s);
    case 1: return launch<__nv_bfloat16>(x, out, n, chunk, scale, tiles, s);
    case 2: return launch<__half>(x, out, n, chunk, scale, tiles, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
