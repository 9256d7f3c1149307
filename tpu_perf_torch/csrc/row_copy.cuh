// Persistent row copies with tiles taken in order, shared by the row-copy
// kernels (p2p_shift.cu, hbm_copy.cu), the all-gather (all_gather.cu) and
// the peer copy and reduce-scatter (peer_collectives.cu).
//
// Why tiles in order.  On the H100 a grid whose CTAs each stream a fixed
// share of the rows (grid-stride) trails PyTorch's copy, whose short-lived
// blocks start in address order.  Here a persistent grid (kCtasPerSm CTAs
// an SM, no more than there are tiles) draws the next tile from one
// device counter, so the tiles in flight stay within a few MB of one
// another as those blocks' do, and no tail wave runs with few copies in
// flight.  The same design brought pingpong.cu's legs to ~90% of its bound.
//
// Why four CTAs an SM.  Each CTA is 256 threads with 2 16-byte spans each
// in flight, so four CTAs keep 32 KB an SM in flight.  At the paths' 256 MiB
// rows that matched PyTorch's copy_; a full SM (eight CTAs, 64 KB) took 1%
// longer and two CTAs (16 KB) 13% longer
// (python -m tpu_perf_torch.tools.row_copy_designs).
//
// The counters.  Two uint32 per launch (next tile, CTAs done) in a buffer
// the host wrapper owns per card, zero between launches: every CTA draws
// until it draws past the last tile, then counts itself done, and the last
// CTA to finish stores 0 in both.  Nothing is passed from the host per
// launch, so a CUDA graph can replay the launch.  Launches that share a
// buffer must be ordered on one stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_copy {

constexpr int kThreads = 256;  // threads per block
constexpr int kUnroll = 2;     // 16-byte spans in flight a thread: 8 KB tiles
constexpr int kCtasPerSm = 4;  // the most CTAs an SM
constexpr long long kTileBytes = (long long)kThreads * kUnroll * 16;
constexpr int kMaxDevices = 64;

// words of W in a tile
template <typename W>
constexpr long long kTileWords = kTileBytes / (long long)sizeof(W);

// The next tile for this CTA; one thread calls it.
__device__ __forceinline__ unsigned int draw(unsigned int* counters) {
  return atomicAdd(counters, 1u);
}

// After this CTA's last draw: count it done, and the last CTA of the grid
// returns both counters to zero (every CTA has drawn its last by then).
// One thread calls it.
__device__ __forceinline__ void retire(unsigned int* counters) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counters + 1)
               : "memory");
  if (old == gridDim.x - 1u) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(counters)
                 : "memory");
    asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(counters + 1)
                 : "memory");
  }
}

// Call body(t) for each tile t < tiles this CTA draws, all threads
// together; thread 0 draws the next tile while the CTA copies this one.
template <typename Body>
__device__ __forceinline__ void for_each_tile(unsigned int* counters,
                                              unsigned int tiles, Body body) {
  __shared__ unsigned int drawn[2];  // this tile, the next one
  if (threadIdx.x == 0) drawn[0] = draw(counters);
  __syncthreads();
  for (int cur = 0;; cur ^= 1) {
    const unsigned int t = drawn[cur];
    if (t >= tiles) break;
    if (threadIdx.x == 0) drawn[cur ^ 1] = draw(counters);
    body(t);
    __syncthreads();
  }
  if (threadIdx.x == 0) retire(counters);
}

// Copy the tile of a row of `row` words that starts at word t0, through
// registers: each warp 32 * kUnroll consecutive spans, its lanes 32 apart,
// so every load and store instruction of the warp is coalesced.  A thread
// loads all its words of the tile before it stores any (kUnroll * 16 /
// sizeof(W) loads in flight).  kStreaming stores evict-first
// (st.global.cs), for output the kernel does not read back.
template <bool kStreaming = false, typename W>
__device__ __forceinline__ void copy_tile(const W* __restrict__ s,
                                          W* __restrict__ o, long long row,
                                          long long t0) {
  constexpr int kRounds = (int)(16 / sizeof(W));
  const long long lane0 =
      t0 + (long long)(threadIdx.x & ~31) * kUnroll + (threadIdx.x & 31);
  W v[kRounds][kUnroll];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = lane0 + (long long)r * kThreads * kUnroll + 32 * k;
      if (i < row) v[r][k] = s[i];
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = lane0 + (long long)r * kThreads * kUnroll + 32 * k;
      if (i >= row) continue;
      if constexpr (kStreaming) {
        __stcs(&o[i], v[r][k]);
      } else {
        o[i] = v[r][k];
      }
    }
  }
}

// CTAs of `kernel` (kThreads threads, no dynamic shared memory) the card
// holds at once, at most kCtasPerSm an SM, asked once per device and kept
// in `cache` (one array per kernel); 0 with *err set when a query fails.
inline int resident_ctas(const void* kernel, int* cache, cudaError_t* err) {
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  if (device < kMaxDevices && cache[device] > 0) return cache[device];
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, 0);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (*err != cudaSuccess) return 0;
  if (per_sm > kCtasPerSm) per_sm = kCtasPerSm;
  if (per_sm * sms < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (device < kMaxDevices) cache[device] = per_sm * sms;
  return per_sm * sms;
}

// The grid for `tiles` tiles: the resident CTAs, no more than the tiles.
// Refuses a tile count whose draws (tiles + grid) overflow the counter.
inline int grid_for(long long tiles, int resident, cudaError_t* err) {
  if (tiles + resident > 0xffffffffll) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  return tiles < resident ? (int)tiles : resident;
}

}  // namespace row_copy
