// Peer collectives of a multi-rank world: every pl_* op that reaches
// another rank's memory, one launch a rank, reading or writing its peers'
// buffers through a table of device pointers (or one pointer) and meeting
// them on signal pads.
//
// Replaces, for a world of ranks on their own cards:
//   tpu_perf/ops/pallas_ring.py `_reduce_scatter_kernel` (with `_acc_add`,
//     and pl_reduce_scatter's tiled carry) -> peer_reduce;
//   `_all_gather_kernel` (pl_all_gather, and `src_full`, the all-reduce's
//     second phase) and `_all_to_all_direct_kernel` -> peer_gather;
//   `_all_gather_bidir_kernel` -> peer_gather in its half-chunk mode;
//   `_ring_kernel`, `_exchange_kernel` and the two legs of
//     `_pingpong_kernel` -> peer_copy_kernel;
//   the barrier semaphores `_ring_barrier`, `_pair_barrier` and
//     `_global_barrier`, and `_barrier_kernel` (the global barrier and its
//     tiny local copy) -> peer_barrier_kernel.
// The sim world's kernels (reduce_scatter.cu, all_gather.cu, p2p_shift.cu,
// ...) do every rank of one card in one launch; here each rank launches its
// own, on its own card (or, in the one-card loopback that proves the
// protocol, on its own stream), and a rank's buffers are never assumed to
// sit next to another's: every kernel takes pointers, never a row stride.
//
// What they compute (rank d of n; `parts[s]` is the s-th pointer of the
// table the kernel gets):
//   peer_reduce:  out = ((parts[d+1] + parts[d+2]) + ...) + parts[d+n]
//                 (ranks mod n; parts[s] is rank s's chunk d), rounded to
//                 the working type after every add, then times `scale`
//                 rounded once more, stored `tiles` times along out.  That
//                 is the order of reduce_scatter.cu and of the TPU ring
//                 (each rank adds its own chunk to the partial that
//                 arrives), so a float32 sum is bit-identical to the sim
//                 kernel's and to JAX's.
//   peer_gather:  out_s[d*chunk : (d+1)*chunk] = own for every rank s
//                 (push: the rank stores its own chunk into its slot of
//                 every rank's output, as the TPU kernels send theirs; the
//                 all-to-all's push stores chunk s of its input there,
//                 own[s*chunk : (s+1)*chunk]), or out[s*chunk : (s+1)*chunk]
//                 = parts[s][0 : chunk] for every rank s (pull: a gather
//                 or an all-to-all into a tensor no peer can reach).  In
//                 the half-chunk mode the first halves go clockwise (push
//                 to d+k, pull from d-k) and the second counter-clockwise;
//                 the output is the same.
//   peer_copy:    dst = src: a peer's buffer (or the rank's own) pulled
//                 into the rank's own, or the rank's own pushed into a
//                 peer's (the pingpong's legs).
//   peer_barrier: the rank signals slot d of the pad of every rank of its
//                 set with its barrier generation and waits until the
//                 slot of each of them in its own pad holds it; then,
//                 optionally, copies a few local bytes.  The sets, after
//                 the TPU kernels' three barriers: all ranks (its own
//                 included), the ring neighbours {d-1, d+1}, the pair
//                 partner {d+n/2}.  Each set is symmetric: s is in d's set
//                 exactly when d is in s's.
//
// Memory order.  Peers sit on other cards, so every signal is a release
// and every wait an acquire at system scope (st.release.sys /
// ld.acquire.sys); gpu scope would pass on one card and be wrong across
// two.  The hard case is a push: rank d's previous kernel stored into
// peer s's memory, and s's next kernel reads those bytes once s has
// passed the barrier.  Stream order puts d's previous kernels (their
// stores into peers' memory and their loads of it) before its barrier
// kernel, so they happen before each of its signals; the st.release.sys
// of a signal is a release at system scope, and a release is cumulative:
// it orders before the signal every write that happens before it, the
// previous kernel's stores into a peer's memory included.  It is the
// instruction that orders them.  On s, the ld.acquire.sys that sees the
// signal orders every later access of its thread after d's release;
// __syncthreads (bar.sync) orders the rest of the CTA (the tail copy)
// after it, and stream order s's next kernel.  So s reads d's pushed
// bytes, and d's earlier reads of s's memory are done before s
// overwrites it.  No full fence is needed beside them: the kernel's two
// __threadfence_system() (fence.sc.sys, before the signals and after the
// waits) took 4.6-4.9 of its 8.0-8.4 us in a world of one and made no
// order the release and acquire lack (python -m
// tpu_perf_torch.tools.peer_designs --parts barrier, NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
// Sources.  Release and acquire patterns, their scopes and the
// cumulativity of a release through causality order: the PTX ISA's
// "Memory Consistency Model" chapter.  That a stream runs its kernels in
// order, each after the previous one's memory operations are done: the
// CUDA C++ Programming Guide's "Streams" section.  The argument rests on
// that rule holding at system scope, for stores into another card's
// memory over NVLink as for local ones; the PTX model itself has no
// kernel boundaries.  PyTorch's SymmetricMemory rests on the same
// premise: its barrier kernel (c10d CUDASymmetricMemory.cu, with
// put_signal / wait_signal of CUDASymmetricMemory-inl.h) signals with a
// release and waits with an acquire at system scope, with no fence,
// between kernels that store into peers' buffers and kernels that read
// them.  chip_smoke.ipc_across_cards runs the push chain across cards
// bit for bit (PERF.md section 7).
//
// Generations, and graph replay.  A CUDA graph freezes its kernels'
// arguments, so no host-side epoch can tell one replay's barrier from the
// next.  Each rank keeps its barrier count in a word of device memory that
// only its own barrier launches touch (in stream order): a launch bumps it
// and signals the new value, and a slot counts as arrived when it holds at
// least that value (compared mod 2^32).  Slot s of a pad is written by
// rank s alone, and only grows.  Every rank runs the same sequence of
// barriers (an op's steps use one set throughout), so at its k-th barrier
// rank d waits for the k-th of each rank s of its set, and s, which has d
// in its own set, cannot pass that barrier before d signals it: a
// waited-on peer is never more than one generation ahead, and a slot
// never skips a value a waiter needs.  A rank outside d's set may run
// further ahead; d never reads its slot.  The pads start at zero.
//
// Hangs.  A wait that passes kTimeoutNs of the device's global timer calls
// __trap(), which aborts the launch with an error the next synchronize
// reports: a lost peer fails, never hangs.  Only the barrier waits; it is
// one CTA of one warp, so the n barriers of a one-card loopback are
// resident together as long as n CTAs fit (peer_barrier_capacity), and the
// data kernels never wait on anything.
//
// Bounds on an H100 (80 GB HBM3 at 3.35 TB/s): the data kernels are
// memory-bound, the barrier latency-bound.  Across cards each rank reads
// its n chunks (peer_reduce), n parts (the pull gather) or one buffer
// (peer_copy) over NVLink (450 GB/s each way) and writes its own output;
// the push gather reads its own chunk once and writes n slots, n - 1 of
// them over NVLink.  In the loopback the n launches share one card's
// memory: the pushes move the sim gather's bytes (n chunks read, n * n
// written), where n pulls read n * n.
//
// Design.  peer_copy_kernel and peer_reduce's 16-byte path are persistent
// grids that draw tiles in address order from a per-launch counter pair
// (row_copy.cuh: the counters sit in a buffer the host wrapper keeps per
// card and stream, and the last CTA returns them to zero), so the tiles in
// flight stay within a few MB of one another and no tail wave runs with
// few loads in flight; a grid-stride loop (four CTAs an SM, a word a
// thread a trip) trailed PyTorch's copy and its sum (on an H100, 8 ranks x
// 256 MiB in the one-card loopback: 1.50 ms against x[idx]'s 1.43-1.45,
// 0.80 against view(n,n,c).sum(0)'s 0.78).
// The copy is row_copy's own tile copy (8 KB tiles, 2 x 16 bytes a thread
// in flight, four CTAs an SM, streaming stores: its output is not read
// back), in the widest word (16, 4, 2 or 1 bytes) that divides both
// addresses and the length.  peer_reduce's tile is kThreads x
// kReduceUnits 16-byte units of the owned chunk; a thread loads its units
// of up to kGroup peers before it adds, and stores the sum and its `tiles`
// copies evict-first (st.global.cs), so the output does not push the
// peers' chunks out of L2.  Units in flight and CTAs an SM were chosen on
// an H100 at 8 x 256 MiB, n = 8: see kReduceUnits.  The kernels never
// wait on anything: the barrier stays the only waiter.  A chunk that is
// not a whole number of aligned 16-byte units (vec == 0) goes one element
// a thread in a grid-stride loop: it is off the paths' 256 MiB points,
// whose chunks are aligned.  peer_gather is the copy's tile list over n
// destinations (push) or n sources (pull), in the widest word that
// divides every address and the chunk's (or half's) bytes.  Its push
// takes all_gather.cu's order: a source tile, then its n destinations,
// so L2 serves the rereads; each rank starts at its own output (s = d, d
// + 1, ...), so across cards no output takes every rank's first stores.
// The all-to-all's push takes the same order, the TPU kernel's (its
// transfers go to d + 1 + j, all started before any is awaited): at any
// moment every card stores into every card, though each destination's
// source tile is its own (chunk s), with no L2 reuse.  The whole-chunk
// pull starts at the rank's own part too and takes the sources fastest
// (s = d, d + 1, ... for each tile), so every card's memory serves every
// reader at once.  Across four cards at 256 MiB a rank the push took
// 0.5605 ms (all_to_all_single 0.6806), the pull 0.6200-0.6280; the pull
// in address order (s = 0, 1, ..., tile by tile: every rank read rank
// 0's chunk first, one card's link serving n - 1 readers) 0.9576-0.9850,
// and the pages fastest from s = d 0.9333-0.9577, the ranks drifting
// out of step onto one source (4 x NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.across_cards and python -m tpu_perf_torch.tools.peer_designs
// --parts a2a).  In the one-card loopback the address order was the
// faster pull (1.15 against 1.49 ms for the gather at 8 x 256 MiB): there
// the ranks read one tile at once from L2.
// At 8 x 256 MiB in the one-card loopback the push takes 0.874-0.875 ms
// (82% of the gather's bound; the sim gather 0.846-0.853), torch.cat of
// the chunks on every rank's stream 1.447-1.462 and the expand copy
// 1.707-1.726; the pull on the same tiles 1.149-1.158 in address order,
// 1.49 staggered, as a grid-stride loop 1.46-1.48 (each rank reads all n
// chunks: n * n in the loopback) (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "row_copy.cuh"

namespace {

constexpr int kThreads = row_copy::kThreads;  // threads per data block
constexpr int kBlocksPerSm = 4;   // grid-stride grids: SMs x this
constexpr int kGroup = 8;         // peer loads issued before their adds
// peer_reduce's tile: 16-byte units a thread.  One unit a thread (eight
// peers' loads, 128 bytes, in flight; 62 registers in float32, so four
// CTAs fill an SM) at row_copy's four CTAs an SM took 0.7984-0.8002 ms
// scaled and 1.4616-1.4666 tiled; view(n,n,c).sum(0) took 0.7770-0.7894.
// The runner-up scaled, the same with non-coherent loads, took
// 0.7974-0.8003; the best tiled, four units at two CTAs an SM,
// 1.4562-1.4583.  Every other design took within 2.5% of the choice: one,
// two or four units at one to eight CTAs an SM, plain stores, evict-first
// loads (0.8160-0.8228, the slowest), and TMA bulk loads of the n spans
// into shared memory (2-8 KB spans, 2-4 stages: 0.8029-0.8138).  (NVIDIA
// H100 80GB HBM3, 700 W, loopback 8 ranks x 256 MiB float32, three rounds
// each: python -m tpu_perf_torch.tools.peer_designs.)
constexpr int kReduceUnits = 1;
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

// The ring-order sum of one unit of 16 bytes: acc = ((v[0] + v[1]) + ...)
// + v[n-1] with v[k] from src[k] (the table in ring order), rounded to T
// after every add, then times scale, rounded once more.
template <typename T, int V>
__device__ __forceinline__ void add_unit(Pack<T, V>& acc, const Pack<T, V>& v) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc.v[e] = from_f32<T>(to_f32(acc.v[e]) + to_f32(v.v[e]));
  }
}

template <typename T, int V>
__device__ __forceinline__ void scale_unit(Pack<T, V>& acc, float scale) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc.v[e] = from_f32<T>(__fmul_rn(to_f32(acc.v[e]), scale));
  }
}

// Stage the pointer table in shared memory in ring order: src[k] is
// parts[(rank + 1 + k) % n].  All threads call it.
template <typename T>
__device__ __forceinline__ void stage_ring(const T** src,
                                           const T* const* parts, int n,
                                           int rank) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    src[k] = parts[(rank + 1 + k) % n];
  }
  __syncthreads();
}

// Sum in ring order, the 16-byte path: unit u of out (and of each of its
// `tiles` copies) is the sum over k = 0..n-1 of unit u of parts[(rank + 1
// + k) % n], times scale.  Tiles of kThreads x U units are drawn in order
// (row_copy::for_each_tile); within a tile each warp takes 32 x U
// consecutive units, its lanes 32 apart, so every load and store of the
// warp is coalesced.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
peer_reduce(const T* const* __restrict__ parts, T* __restrict__ out,
            unsigned int* counters, int n, int rank, long long chunk,
            float scale, int tiles) {
  constexpr int V = 16 / (int)sizeof(T);
  using P = Pack<T, V>;
  __shared__ const T* staged[kMaxRanks];
  stage_ring(staged, parts, n, rank);
  const T* const* src = staged;
  const long long units = chunk / V;
  constexpr long long per_tile = (long long)kThreads * U;
  row_copy::for_each_tile(
      counters, (unsigned int)((units + per_tile - 1) / per_tile),
      [&](unsigned int t) {
        const long long lane0 = (long long)t * per_tile +
                                (long long)(threadIdx.x & ~31) * U +
                                (threadIdx.x & 31);
        P acc[U];
        for (int k0 = 0; k0 < n; k0 += kGroup) {
          P v[kGroup][U];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (k0 + g >= n) continue;
            const P* s = reinterpret_cast<const P*>(src[k0 + g]);
#pragma unroll
            for (int j = 0; j < U; ++j) {
              const long long i = lane0 + 32 * j;
              if (i < units) v[g][j] = s[i];
            }
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int k = k0 + g;
#pragma unroll
            for (int j = 0; j < U; ++j) {
              if (k == 0) {
                acc[j] = v[g][j];
              } else if (k < n) {
                add_unit(acc[j], v[g][j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const long long i = lane0 + 32 * j;
          if (i >= units) continue;
          scale_unit(acc[j], scale);
          const uint4 bits = *reinterpret_cast<const uint4*>(&acc[j]);
          for (int c = 0; c < tiles; ++c) {
            __stcs(reinterpret_cast<uint4*>(out + c * chunk) + i, bits);
          }
        }
      });
}

// The same sum one element a thread, for chunks that are not whole
// aligned 16-byte units: a grid-stride loop (off the paths' large points).
template <typename T>
__global__ void __launch_bounds__(kThreads)
peer_reduce_elems(const T* const* __restrict__ parts, T* __restrict__ out,
                  int n, int rank, long long chunk, float scale, int tiles) {
  using P = Pack<T, 1>;
  __shared__ const T* src[kMaxRanks];
  stage_ring(src, parts, n, rank);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < chunk; u += stride) {
    P acc;
    for (int k0 = 0; k0 < n; k0 += kGroup) {
      P v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (k0 + g < n) v[g].v[0] = src[k0 + g][u];
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = k0 + g;
        if (k == 0) {
          acc = v[g];
        } else if (k < n) {
          add_unit(acc, v[g]);
        }
      }
    }
    scale_unit(acc, scale);
    for (int t = 0; t < tiles; ++t) out[t * chunk + u] = acc.v[0];
  }
}

// The gather's tile list, in `push` or pull mode.  A part is `words`
// words of W in `halves` rows of len = words / halves (half-chunks when
// halves == 2), each row cut into per_half tiles of 8 KB (the last may be
// ragged).  Ring step k of half h names rank s: in push mode s = rank + k
// for h == 0 (clockwise) and rank - k for h == 1 (counter-clockwise), mod
// n; in pull mode the other way round, s = rank - k and rank + k, and s =
// rank + k when halves == 1.
//   push: tile u = (p, h, k), k fastest: tile p of half h of this rank's
//     part for rank s, own + s * stride (stride 0: the own chunk, every
//     time; the all-to-all's `words`: chunk s of its input), is stored
//     into slot `rank` of rank s's output, table[s] (its base).  In the
//     gather the n stores of one source tile run side by side, so the
//     first reads it from device memory and the others find it in L2.
//   pull, halves == 1: tile u = (p, k), k fastest: tile p of table[s] is
//     stored into slot s of out.
//   pull, halves == 2: tile u = (k, h, p), p fastest: tile p of half h of
//     table[s] is stored into slot s of out.
template <typename W>
__global__ void __launch_bounds__(kThreads)
peer_gather(W* const* __restrict__ table, const W* __restrict__ own,
            W* __restrict__ out, unsigned int* counters, int n, int rank,
            long long words, int halves, int push, long long stride) {
  __shared__ W* ptrs[kMaxRanks];
  for (int k = threadIdx.x; k < n; k += blockDim.x) ptrs[k] = table[k];
  __syncthreads();
  constexpr long long tile = row_copy::kTileWords<W>;
  const long long len = words / halves;
  const unsigned int per_half = (unsigned int)((len + tile - 1) / tile);
  const unsigned int un = (unsigned int)n;
  // the ranks fastest: every card reaches every card at once
  const bool ranks_fastest = push || halves == 1;
  row_copy::for_each_tile(
      counters, un * (unsigned int)halves * per_half, [&](unsigned int u) {
        unsigned int k, q, p;
        if (ranks_fastest) {
          k = u % un;
          q = u / un;
        } else {
          p = u % per_half;
          q = u / per_half;
        }
        const int h = (int)(q % (unsigned int)halves);
        q /= (unsigned int)halves;
        if (ranks_fastest) {
          p = q;
        } else {
          k = q;
        }
        const int ahead = (int)((rank + k) % un);
        const int behind = (int)((rank + un - k) % un);
        const long long at = (long long)h * len;
        const long long t0 = (long long)p * tile;
        if (push) {
          const int s = h == 0 ? ahead : behind;
          row_copy::copy_tile<true>(own + s * stride + at,
                                    ptrs[s] + rank * words + at, len, t0);
        } else {
          const int s = halves == 1 ? ahead : (h == 0 ? behind : ahead);
          row_copy::copy_tile<true>(ptrs[s] + at, out + s * words + at, len,
                                    t0);
        }
      });
}

// dst = src, `words` words of W; src may be a peer's buffer.  One row of
// 8 KB tiles drawn in order; the last tile may be ragged.
template <typename W>
__global__ void __launch_bounds__(kThreads)
peer_copy_kernel(const W* __restrict__ src, W* __restrict__ dst,
                 unsigned int* counters, long long words) {
  constexpr long long tile = row_copy::kTileWords<W>;
  row_copy::for_each_tile(
      counters, (unsigned int)((words + tile - 1) / tile),
      [&](unsigned int t) {
        row_copy::copy_tile<true>(src, dst, words, (long long)t * tile);
      });
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

// The barrier's sets of ranks: all, the ring neighbours, the pair partner.
enum PeerSet { kAll = 0, kRing = 1, kPair = 2 };

__device__ __forceinline__ int set_size(int set, int n) {
  return set == kAll ? n : set == kRing ? 2 : 1;
}

// The k-th rank of `rank`'s set (a ring of one or two names a rank twice).
__device__ __forceinline__ int set_member(int set, int n, int rank, int k) {
  if (set == kRing) return k == 0 ? (rank + n - 1) % n : (rank + 1) % n;
  if (set == kPair) return (rank + n / 2) % n;
  return k;
}

// One CTA of one warp (kBarrierThreads): bump this rank's generation,
// signal slot `rank` of the pad of every rank of its set, wait for those
// ranks' slots of this rank's pad; then copy `nbytes` bytes from src to
// dst (none when 0).
__global__ void __launch_bounds__(kBarrierThreads)
peer_barrier_kernel(unsigned int* const* __restrict__ pads,
                    unsigned int* __restrict__ generation, int n, int rank,
                    int set, const unsigned char* __restrict__ src,
                    unsigned char* __restrict__ dst, long long nbytes) {
  // every thread of the warp loads the count before thread 0 bumps it
  const unsigned int g = *generation + 1u;
  __syncwarp();
  if (threadIdx.x == 0) *generation = g;
  const int peers = set_size(set, n);
  for (int k = threadIdx.x; k < peers; k += blockDim.x) {
    store_release_sys(pads[set_member(set, n, rank, k)] + rank, g);
  }
  const unsigned int* mine = pads[rank];
  for (int k = threadIdx.x; k < peers; k += blockDim.x) {
    const unsigned int* slot = mine + set_member(set, n, rank, k);
    const unsigned long long t0 = now_ns();
    while ((int)(load_acquire_sys(slot) - g) < 0) {
      if (now_ns() - t0 > kTimeoutNs) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = src[i];
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

// The persistent grid of `kernel` for `tiles` tiles: its resident CTAs
// (asked once per card into `cache`), no more than the tiles, and one CTA
// for none (it draws past the end and zeroes the counters); 0 with *err
// set when the query fails or the draws would overflow the counter.
int tile_grid(const void* kernel, int* cache, long long tiles,
              cudaError_t* err) {
  const int resident = row_copy::resident_ctas(kernel, cache, err);
  if (*err != cudaSuccess) return 0;
  const int grid = row_copy::grid_for(tiles, resident, err);
  if (*err != cudaSuccess) return 0;
  return grid < 1 ? 1 : grid;
}

template <typename T>
int launch_reduce(const void* table, void* out, void* counters, int n,
                  int rank, long long chunk, float scale, int tiles, int vec,
                  cudaStream_t stream) {
  const T* const* parts = static_cast<const T* const*>(table);
  T* o = static_cast<T*>(out);
  if (!vec) {
    peer_reduce_elems<T><<<data_grid(chunk), kThreads, 0, stream>>>(
        parts, o, n, rank, chunk, scale, tiles);
    return (int)cudaGetLastError();
  }
  static int resident_cache[row_copy::kMaxDevices] = {0};
  constexpr long long per_tile = (long long)kThreads * kReduceUnits;
  const long long units = chunk / (16 / (long long)sizeof(T));
  cudaError_t err = cudaSuccess;
  const int grid = tile_grid((const void*)peer_reduce<T, kReduceUnits>,
                             resident_cache,
                             (units + per_tile - 1) / per_tile, &err);
  if (err != cudaSuccess) return (int)err;
  peer_reduce<T, kReduceUnits><<<grid, kThreads, 0, stream>>>(
      parts, o, static_cast<unsigned int*>(counters), n, rank, chunk, scale,
      tiles);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_gather(const void* table, const void* own, void* out,
                  void* counters, int n, int rank, long long chunk_bytes,
                  int halves, int push, int scatter, cudaStream_t stream) {
  static int resident_cache[row_copy::kMaxDevices] = {0};
  constexpr long long tile = row_copy::kTileWords<W>;
  const long long words = chunk_bytes / (long long)sizeof(W);
  const long long per_half = (words / halves + tile - 1) / tile;
  cudaError_t err = cudaSuccess;
  const int grid = tile_grid((const void*)peer_gather<W>, resident_cache,
                             (long long)n * halves * per_half, &err);
  if (err != cudaSuccess) return (int)err;
  peer_gather<W><<<grid, kThreads, 0, stream>>>(
      static_cast<W* const*>(const_cast<void*>(table)),
      static_cast<const W*>(own), static_cast<W*>(out),
      static_cast<unsigned int*>(counters), n, rank, words, halves, push,
      scatter ? words : 0);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_copy(const void* src, void* dst, void* counters, long long nbytes,
                cudaStream_t stream) {
  static int resident_cache[row_copy::kMaxDevices] = {0};
  constexpr long long tile = row_copy::kTileWords<W>;
  const long long words = nbytes / (long long)sizeof(W);
  cudaError_t err = cudaSuccess;
  const int grid = tile_grid((const void*)peer_copy_kernel<W>, resident_cache,
                             (words + tile - 1) / tile, &err);
  if (err != cudaSuccess) return (int)err;
  peer_copy_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst),
      static_cast<unsigned int*>(counters), words);
  return (int)cudaGetLastError();
}

bool is_word(int word) {
  return word == 16 || word == 4 || word == 2 || word == 1;
}

// One gather launch in the word `word`, after the entries' common checks;
// `scatter` (a push) stores chunk s of own into rank s's output.
int gather_by_word(const void* table, const void* own, void* out,
                   void* counters, int n, int rank, long long chunk_bytes,
                   int halves, int word, int push, int scatter,
                   void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n ||
      (halves != 1 && halves != 2) || !is_word(word) || chunk_bytes < 0 ||
      chunk_bytes % ((long long)halves * word)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long b = chunk_bytes;
  switch (word) {
    case 16: return launch_gather<uint4>(table, own, out, counters, n, rank, b, halves, push, scatter, s);
    case 4: return launch_gather<uint32_t>(table, own, out, counters, n, rank, b, halves, push, scatter, s);
    case 2: return launch_gather<uint16_t>(table, own, out, counters, n, rank, b, halves, push, scatter, s);
    default: return launch_gather<uint8_t>(table, own, out, counters, n, rank, b, halves, push, scatter, s);
  }
}

}  // namespace

// Rank `rank`'s reduce-scatter: `table` is a device array of n pointers,
// entry s at rank s's chunk `rank` (chunk elements); out holds tiles *
// chunk elements (tiles >= 1).  vec: every pointer, out and the chunk's
// bytes are multiples of 16 bytes.  counters is 2 uint32 words, zero, that
// only launches ordered on one stream touch (the kernel leaves them zero;
// the vec == 0 path does not use them).  dtype: 0 float32, 1 bfloat16, 2
// float16.  scale is exact in the dtype.  Returns the occupancy query's
// error, else cudaGetLastError().
extern "C" int peer_reduce_scatter(const void* table, void* out,
                                   void* counters, int n, int rank,
                                   long long chunk, int dtype, float scale,
                                   int tiles, int vec, void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || tiles < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* c = counters;
  switch (dtype) {
    case 0: return launch_reduce<float>(table, out, c, n, rank, chunk, scale, tiles, vec, s);
    case 1: return launch_reduce<__nv_bfloat16>(table, out, c, n, rank, chunk, scale, tiles, vec, s);
    case 2: return launch_reduce<__half>(table, out, c, n, rank, chunk, scale, tiles, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rank `rank`'s push all-gather: its own part `own` (chunk_bytes) is
// stored into bytes [rank * chunk_bytes, (rank + 1) * chunk_bytes) of every
// rank's output; `table` is a device array of the n outputs' bases.  halves
// 2: the first half-chunk goes clockwise (rank + k), the second
// counter-clockwise (rank - k).  word (16, 4, 2 or 1) divides own, every
// destination slot and chunk_bytes / halves.  counters is 2 uint32 words,
// zero, that only launches ordered on one stream touch (the kernel leaves
// them zero).  A rank's output is whole once every rank's push is done:
// the caller's next barrier.  Returns the occupancy query's error, else
// cudaGetLastError().
extern "C" int peer_gather_push(const void* own, const void* table,
                                void* counters, int n, int rank,
                                long long chunk_bytes, int halves, int word,
                                void* stream) {
  return gather_by_word(table, own, nullptr, counters, n, rank, chunk_bytes,
                        halves, word, 1, 0, stream);
}

// Rank `rank`'s push all-to-all: chunk s of its input `own` (n chunks of
// chunk_bytes) is stored into bytes [rank * chunk_bytes, (rank + 1) *
// chunk_bytes) of rank s's output, for every s; `table` is a device array
// of the n outputs' bases.  word (16, 4, 2 or 1) divides own, every
// destination slot and chunk_bytes; counters as peer_gather_push's.  A
// rank's output is whole once every rank's push is done: the caller's
// next barrier.
extern "C" int peer_all_to_all_push(const void* own, const void* table,
                                    void* counters, int n, int rank,
                                    long long chunk_bytes, int word,
                                    void* stream) {
  return gather_by_word(table, own, nullptr, counters, n, rank, chunk_bytes,
                        1, word, 1, 1, stream);
}

// Rank `rank`'s pull gather (a gather or an all-to-all into a tensor no
// peer can reach): `table` is a device array of n pointers, entry s at
// the part rank s gives this rank (its owned chunk, or its chunk `rank`),
// chunk_bytes each, pulled into out[s * chunk_bytes ...], the sources
// taken from rank + k; halves 2 pulls the first halves from rank - k and
// the second from rank + k.  word divides every pointer, out and
// chunk_bytes / halves; counters as peer_gather_push's.
extern "C" int peer_gather_pull(const void* table, void* out, void* counters,
                                int n, int rank, long long chunk_bytes,
                                int halves, int word, void* stream) {
  return gather_by_word(table, nullptr, out, counters, n, rank, chunk_bytes,
                        halves, word, 0, 0, stream);
}

// dst = src, nbytes; word (16, 4, 2 or 1) divides both pointers and nbytes;
// counters as peer_reduce_scatter's.
extern "C" int peer_copy(const void* src, void* dst, void* counters,
                         long long nbytes, int word, void* stream) {
  if (!is_word(word) || nbytes < 0 || nbytes % word) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16: return launch_copy<uint4>(src, dst, counters, nbytes, s);
    case 4: return launch_copy<uint32_t>(src, dst, counters, nbytes, s);
    case 2: return launch_copy<uint16_t>(src, dst, counters, nbytes, s);
    default: return launch_copy<uint8_t>(src, dst, counters, nbytes, s);
  }
}

// A rank's barrier: `table` is a device array of the n ranks' signal pads
// (n uint32 each, zero at first); `generation` is this rank's own uint32
// count, zero at first, touched by nothing else; `set` is 0 (all ranks), 1
// (ring neighbours) or 2 (pair partner, n even).  After the wait, nbytes
// (0: none) are copied from src to dst.
extern "C" int peer_barrier(const void* table, void* generation, int n,
                            int rank, int set, const void* src, void* dst,
                            long long nbytes, void* stream) {
  if (n < 1 || rank < 0 || rank >= n || set < kAll || set > kPair ||
      (set == kPair && n % 2) || nbytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  peer_barrier_kernel<<<1, kBarrierThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int* const*>(table),
      static_cast<unsigned int*>(generation), n, rank, set,
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), nbytes);
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
