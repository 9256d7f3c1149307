// Peer collectives of a multi-rank world: the reduce-scatter and the
// all-gather of pl_allreduce and the barrier between them, each launch one
// rank's, reading its peers' buffers through a table of device pointers and
// meeting them on signal pads.
//
// Replaces, for a world of ranks on their own cards:
//   tpu_perf/ops/pallas_ring.py `_reduce_scatter_kernel` (with `_acc_add`)
//     -> peer_reduce;
//   `_all_gather_kernel` (`src_full`, the all-reduce's second phase)
//     -> peer_gather;
//   the barrier semaphores `_ring_barrier` / `_global_barrier` that both
//   start with -> peer_barrier_kernel.
// The sim world's kernels (reduce_scatter.cu, all_gather.cu) do every rank
// of one card in one launch; here each rank launches its own, on its own
// card (or, in the one-card loopback that proves the protocol, on its own
// stream), and a rank's buffers are never assumed to sit next to another's:
// every kernel takes a table of the n pointers, never a row stride.
//
// What they compute (rank d of n; `parts[s]` is the s-th pointer of the
// table the kernel gets):
//   peer_reduce:  out = ((parts[d+1] + parts[d+2]) + ...) + parts[d+n]
//                 (ranks mod n; parts[s] is rank s's chunk d), rounded to
//                 the working type after every add, then times `scale`
//                 rounded once more.  That is the order of reduce_scatter.cu
//                 and of the TPU ring (each rank adds its own chunk to the
//                 partial that arrives), so a float32 sum is bit-identical
//                 to the sim kernel's and to JAX's.
//   peer_gather:  out[s*chunk : (s+1)*chunk] = parts[s][0 : chunk] for
//                 every rank s: the rank pulls every peer's owned chunk
//                 into its own output, so every write stays on its card.
//   peer_barrier: the rank signals slot d of every peer's pad (its own
//                 included) with its barrier generation and waits until
//                 every slot of its own pad holds that generation.
//
// Memory order.  Peers sit on other cards, so the signal is a release and
// the wait an acquire at system scope (st.release.sys / ld.acquire.sys,
// after a __threadfence_system()); gpu scope would pass on one card and be
// wrong across two.  A rank's earlier kernels are done when its barrier
// starts (stream order), so what they wrote is visible to a peer that has
// seen the signal.
//
// Generations, and graph replay.  A CUDA graph freezes its kernels'
// arguments, so no host-side epoch can tell one replay's barrier from the
// next.  Each rank keeps its barrier count in a word of device memory that
// only its own barrier launches touch (in stream order): a launch bumps it
// and signals the new value, and a slot counts as arrived when it holds at
// least that value (compared mod 2^32).  A peer is never more than one
// barrier ahead (it cannot pass barrier k+1 before this rank signals it),
// so a slot never skips a value a waiter needs.  The pads start at zero.
//
// Hangs.  A wait that passes kTimeoutNs of the device's global timer calls
// __trap(), which aborts the launch with an error the next synchronize
// reports: a lost peer fails, never hangs.  Only the barrier waits; it is
// one CTA of one warp, so the n barriers of a one-card loopback are
// resident together as long as n CTAs fit (peer_barrier_capacity), and the
// data kernels never wait on anything.
//
// Bounds on an H100 (80 GB HBM3 at 3.35 TB/s): the two data kernels are
// memory-bound, the barrier latency-bound.  Across cards each rank reads
// its n chunks (peer_reduce) or n owned chunks (peer_gather) over NVLink
// (450 GB/s each way) and writes its own output; in the loopback the n
// launches share one card's memory and move the sim kernels' bytes in all.
// The design is the sim kernels' first one: one thread a 16-byte unit,
// the loads of up to kGroup peers issued before their adds, a grid-stride
// loop sized to the SMs; ragged or misaligned chunks go one element (or
// word) a thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;     // threads per data block
constexpr int kBlocksPerSm = 4;   // data grid = SMs x this, the loop strides
constexpr int kGroup = 8;         // peer loads issued before their adds
constexpr int kMaxRanks = 64;     // pointer-table entries a block stages
constexpr int kBarrierThreads = 32;
constexpr unsigned long long kTimeoutNs = 60ull * 1000000000ull;

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

// Sum in ring order: unit u of out is the sum over k = 0..n-1 of unit u of
// parts[(rank + 1 + k) % n], times scale.  The table is staged in shared
// memory in that order once a block.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
peer_reduce(const T* const* __restrict__ parts, T* __restrict__ out, int n,
            int rank, long long chunk, float scale) {
  using P = Pack<T, V>;
  __shared__ const T* src[kMaxRanks];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    src[k] = parts[(rank + 1 + k) % n];
  }
  __syncthreads();
  const long long units = chunk / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    P acc;
    for (int k0 = 0; k0 < n; k0 += kGroup) {
      P v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (k0 + g < n) v[g] = *reinterpret_cast<const P*>(src[k0 + g] + u * V);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = k0 + g;
        if (k == 0) {
          acc = v[g];
        } else if (k < n) {
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
    *reinterpret_cast<P*>(out + u * V) = acc;
  }
}

// Row s of the grid pulls rank s's chunk (`words` words of W) into
// out[s * words ...].
template <typename W>
__global__ void __launch_bounds__(kThreads)
peer_gather(const W* const* __restrict__ parts, W* __restrict__ out,
            long long words) {
  const int s = blockIdx.y;
  const W* __restrict__ src = parts[s];
  W* __restrict__ dst = out + (long long)s * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += stride) {
    dst[i] = src[i];
  }
}

__device__ __forceinline__ void store_release_sys(unsigned int* p,
                                                  unsigned int v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned int load_acquire_sys(
    const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One CTA of one warp: bump this rank's generation, signal slot `rank` of
// every pad, wait for every slot of this rank's pad.
__global__ void __launch_bounds__(kBarrierThreads)
peer_barrier_kernel(unsigned int* const* __restrict__ pads,
                    unsigned int* __restrict__ generation, int n, int rank) {
  __shared__ unsigned int gen;
  if (threadIdx.x == 0) {
    gen = *generation + 1u;
    *generation = gen;
  }
  __syncthreads();
  const unsigned int g = gen;
  __threadfence_system();
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    store_release_sys(pads[s] + rank, g);
  }
  const unsigned int* mine = pads[rank];
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const unsigned long long t0 = now_ns();
    while ((int)(load_acquire_sys(mine + s) - g) < 0) {
      if (now_ns() - t0 > kTimeoutNs) __trap();
      __nanosleep(64);
    }
  }
  // what each waiter acquired, ordered before the rank's next kernel
  __threadfence_system();
  __syncthreads();
}

int data_grid(long long work) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <typename T>
int launch_reduce(const void* table, void* out, int n, int rank,
                  long long chunk, float scale, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* const* parts = static_cast<const T* const*>(table);
  T* o = static_cast<T*>(out);
  if (vec) {
    peer_reduce<T, V><<<data_grid(chunk / V), kThreads, 0, stream>>>(
        parts, o, n, rank, chunk, scale);
  } else {
    peer_reduce<T, 1><<<data_grid(chunk), kThreads, 0, stream>>>(
        parts, o, n, rank, chunk, scale);
  }
  return (int)cudaGetLastError();
}

template <typename W>
int launch_gather(const void* table, void* out, int n, long long chunk_bytes,
                  cudaStream_t stream) {
  const long long words = chunk_bytes / (long long)sizeof(W);
  const dim3 grid((unsigned)data_grid(words), (unsigned)n);
  peer_gather<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W* const*>(table), static_cast<W*>(out), words);
  return (int)cudaGetLastError();
}

}  // namespace

// Rank `rank`'s reduce-scatter: `table` is a device array of n pointers,
// entry s at rank s's chunk `rank` (chunk elements); out holds chunk
// elements.  vec: every pointer, out and the chunk's bytes are multiples
// of 16 bytes.  dtype: 0 float32, 1 bfloat16, 2 float16.  scale is exact
// in the dtype.  Returns cudaGetLastError().
extern "C" int peer_reduce_scatter(const void* table, void* out, int n,
                                   int rank, long long chunk, int dtype,
                                   float scale, int vec, void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_reduce<float>(table, out, n, rank, chunk, scale, vec, s);
    case 1: return launch_reduce<__nv_bfloat16>(table, out, n, rank, chunk, scale, vec, s);
    case 2: return launch_reduce<__half>(table, out, n, rank, chunk, scale, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A rank's all-gather: `table` is a device array of n pointers, entry s at
// rank s's owned chunk of chunk_bytes; out holds n * chunk_bytes.  word
// (16, 4, 2 or 1) divides every pointer, out and chunk_bytes.
extern "C" int peer_all_gather(const void* table, void* out, int n,
                               long long chunk_bytes, int word,
                               void* stream) {
  if (n < 1 || (word != 16 && word != 4 && word != 2 && word != 1) ||
      chunk_bytes % word) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16: return launch_gather<uint4>(table, out, n, chunk_bytes, s);
    case 4: return launch_gather<uint32_t>(table, out, n, chunk_bytes, s);
    case 2: return launch_gather<uint16_t>(table, out, n, chunk_bytes, s);
    case 1: return launch_gather<uint8_t>(table, out, n, chunk_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A rank's barrier: `table` is a device array of the n ranks' signal pads
// (n uint32 each, zero at first); `generation` is this rank's own uint32
// count, zero at first, touched by nothing else.
extern "C" int peer_barrier(const void* table, void* generation, int n,
                            int rank, void* stream) {
  if (n < 1 || rank < 0 || rank >= n) return (int)cudaErrorInvalidValue;
  peer_barrier_kernel<<<1, kBarrierThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int* const*>(table),
      static_cast<unsigned int*>(generation), n, rank);
  return (int)cudaGetLastError();
}

// How many barrier CTAs the current card holds at once: a one-card
// loopback of n ranks needs its n waiting barriers resident together.
extern "C" int peer_barrier_capacity(int* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, peer_barrier_kernel, kBarrierThreads, 0);
  *ctas = per_sm * sms;
  return (int)err;
}

// The symmetric buffers of a rank in a multi-process world: one
// allocation, zeroed, whose IPC handle the peers open.
extern "C" int peer_alloc(long long bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

extern "C" int peer_free(void* ptr) { return (int)cudaFree(ptr); }

// The allocation's IPC handle, copied into 64 bytes at `handle`.
extern "C" int peer_ipc_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

// A peer's allocation, mapped into this process from its 64-byte handle.
extern "C" int peer_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int peer_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}
