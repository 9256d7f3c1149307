// Serialized round trip between the two groups of the sim world, both legs
// in one launch, the return leg of each pair held back by a device count.
//
// Replaces: tpu_perf/ops/pallas_ring.py `_pingpong_kernel` (pl_pingpong),
// the blocking ping-pong of the reference (mpi_perf.c:66-83) done with
// remote DMA: group 0 (ranks d < n/2) sends its buffer into its partner's
// stage; the partner (d + n/2), once the payload has landed, sends it
// straight back into group 0's output.  Group 1 keeps its own payload by a
// local copy, so the op is the identity on both groups and chains.
//
// What it computes (half = n/2, pair p = ranks p and p + half):
//   forward leg:  stage[p + half] = x[p]
//   keep-own:     out[p + half]   = x[p + half]
//   return leg:   out[p]          = stage[p + half]
// Stage rows below half are not written, as on the TPU, where group 0's
// stage output is never a target.
//
// Ordering.  The TPU kernel's return leg starts only after `fwd.wait_recv()`
// on the partner's whole payload, and it waits on its own pair only.  Here
// one cooperative launch (every CTA resident, or the launch fails) gives
// each pair a fixed set of `per_pair` CTAs.  The pair's work is one list of
// tiles, handed out in order from the pair's tile counter: the forward
// leg's F tiles, then the keep-own rows' F tiles (they depend on nothing,
// so they cover the wait), then the return leg's F tiles.  A CTA that draws
// its first tile past the forward leg has stored every forward tile it
// drew, and adds one to the pair's arrival count (release, device scope).
// A CTA that draws a return tile (or runs out of tiles) first spins
// (acquire, device scope) until all per_pair CTAs have arrived, i.e. until
// the pair's whole payload is in the stage.  A pair never waits on another pair, and the return leg is
// never pipelined per tile (that would time an exchange, not a round trip).
//
// Why tiles handed out in order.  On the H100 a resident grid whose CTAs
// each stream a fixed share of the row (grid-stride) trails PyTorch's copy,
// whose short-lived blocks start in address order; drawing the next 8 KB
// tile from a counter keeps the tiles in flight within a few MB of one
// another, as those blocks do, and keeps pace with it.
//
// The counters.  Three uint32 per pair (next tile, arrivals, CTAs done) in
// a buffer the host wrapper owns per card, zero between launches: the last
// of the pair's CTAs to finish stores 0 in all three.  Nothing is passed
// from the host per launch, so a CUDA graph can replay the launch.  A spin
// that passes about a second of the device's global timer calls __trap(),
// which aborts the launch with an error the next synchronize reports: a
// lost arrival fails, never hangs.  In a multi-card world the arrival
// count is the signal pad the partner waits on.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  The function reads
// x once and writes out once (2 * n * row_bytes); the schedule moves
// 3 * n * row_bytes, since group 0's payload passes through the stage.
// The copy is typeless, in the widest word (16, 4, 2 or 1 bytes) that
// divides the three addresses and the row; a tile is 8 KB whatever the
// word, kUnroll words in flight per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kUnroll = 2;     // words each thread has in flight
constexpr int kCounters = 3;   // per pair: next tile, arrivals, CTAs done
constexpr unsigned long long kTimeoutNs = 1000000000ull;  // about a second
constexpr int kMaxDevices = 64;

// words in a tile (8 KB): 16 / sizeof(W) rounds of kThreads * kUnroll words
template <typename W>
constexpr long long kTileWords = (long long)kThreads * kUnroll * (16 / sizeof(W));

__device__ __forceinline__ void add_release(unsigned int* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned int add_acq_rel(unsigned int* p) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_zero(unsigned int* p) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p reaches target; trap after about a second.
__device__ __forceinline__ void wait_for(const unsigned int* p,
                                         unsigned int target) {
  const unsigned long long t0 = now_ns();
  while (load_acquire(p) < target) {
    if (now_ns() - t0 > kTimeoutNs) __trap();
    __nanosleep(32);
  }
  __threadfence();
}

// Copy the tile of a row of `row` words that starts at word t0: rounds of
// kThreads * kUnroll words, each warp a span of 32 * kUnroll consecutive
// words, its lanes kUnroll words 32 apart (every load and store
// instruction of the warp coalesced).  The stage is read through L2 only
// (another CTA wrote it in this launch).
template <bool kFromStage, typename W>
__device__ __forceinline__ void copy_tile(const W* s, W* o, long long row,
                                          long long t0) {
  const long long lane0 =
      t0 + (long long)(threadIdx.x & ~31) * kUnroll + (threadIdx.x & 31);
#pragma unroll
  for (int r = 0; r < (int)(16 / sizeof(W)); ++r) {
    const long long base = lane0 + (long long)r * kThreads * kUnroll;
    W v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + 32 * k;
      if (i < row) {
        if constexpr (kFromStage) {
          v[k] = __ldcg(s + i);
        } else {
          v[k] = s[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + 32 * k;
      if (i < row) o[i] = v[k];
    }
  }
}

// CTA b serves slot b / per_pair; slot s holds pairs s, s + slots, ... (one
// pair per slot unless there are more pairs than resident CTAs).  Stage is
// written and read in this launch, so neither it nor out carries
// __restrict__.
template <typename W>
__global__ void __launch_bounds__(kThreads)
pingpong_kernel(const W* __restrict__ x, W* out, W* stage,
                unsigned int* counters, int n, long long row, int slots,
                int per_pair) {
  __shared__ unsigned int drawn[2];  // this tile, the next one
  const int half = n / 2;
  const long long tile = kTileWords<W>;
  const unsigned int legs = (unsigned int)((row + tile - 1) / tile);
  for (int p = blockIdx.x / per_pair; p < half; p += slots) {
    unsigned int* next = counters + kCounters * p;
    unsigned int* arrived = next + 1;
    unsigned int* done = next + 2;
    const long long fwd = (long long)p * row;
    const long long back = (long long)(p + half) * row;
    if (threadIdx.x == 0) drawn[0] = atomicAdd(next, 1u);
    __syncthreads();
    bool has_arrived = false, has_waited = false;
    for (int cur = 0;; cur ^= 1) {
      const unsigned int me = drawn[cur];
      if (me >= legs && !has_arrived) {
        // the barrier that ended this CTA's last tile has its forward
        // tiles stored
        if (threadIdx.x == 0) {
          __threadfence();
          add_release(arrived);
        }
        has_arrived = true;
      }
      if (me >= 2 * legs && !has_waited) {
        // every CTA passes the wait, so every CTA counts as done after it
        if (threadIdx.x == 0) wait_for(arrived, (unsigned int)per_pair);
        __syncthreads();
        has_waited = true;
      }
      if (me >= 3 * legs) break;
      if (threadIdx.x == 0) drawn[cur ^ 1] = atomicAdd(next, 1u);
      if (me < legs) {  // forward leg
        copy_tile<false>(x + fwd, stage + back, row, me * tile);
      } else if (me < 2 * legs) {  // group 1 keeps its own payload
        copy_tile<false>(x + back, out + back, row, (me - legs) * tile);
      } else {  // return leg
        copy_tile<true>(stage + back, out + fwd, row, (me - 2 * legs) * tile);
      }
      __syncthreads();
    }
    // the last of the pair's CTAs to finish returns its counters to zero
    if (threadIdx.x == 0 && add_acq_rel(done) == (unsigned int)per_pair - 1u) {
      store_zero(next);
      store_zero(arrived);
      store_zero(done);
    }
    __syncthreads();  // drawn[] is reused by the next pair
  }
}

// CTAs of the kernel the card holds at once (occupancy x SMs), asked once
// per device; 0 with *err set when the query fails.
template <typename W>
int resident_ctas(cudaError_t* err) {
  static int cached[kMaxDevices] = {0};
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  if (device < kMaxDevices && cached[device] > 0) return cached[device];
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pingpong_kernel<W>, kThreads, 0);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (*err != cudaSuccess) return 0;
  if (per_sm * sms < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  if (device < kMaxDevices) cached[device] = per_sm * sms;
  return per_sm * sms;
}

template <typename W>
int launch(const void* x, void* out, void* stage, void* counters, int n,
           long long row_b, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const int resident = resident_ctas<W>(&err);
  if (err != cudaSuccess) return (int)err;
  long long row = row_b / (long long)sizeof(W);
  const int half = n / 2;
  int slots = half < resident ? half : resident;
  // as many CTAs a pair as its row has tiles, at most an equal share of the
  // resident CTAs
  long long per = (row + kTileWords<W> - 1) / kTileWords<W>;
  if (per > resident / slots) per = resident / slots;
  if (per < 1) per = 1;
  int per_pair = (int)per;
  const W* xs = static_cast<const W*>(x);
  W* os = static_cast<W*>(out);
  W* ss = static_cast<W*>(stage);
  unsigned int* cs = static_cast<unsigned int*>(counters);
  void* args[] = {&xs, &os, &ss, &cs, &n, &row, &slots, &per_pair};
  err = cudaLaunchCooperativeKernel((const void*)pingpong_kernel<W>,
                                    dim3((unsigned)(per_pair * slots)),
                                    dim3(kThreads), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// x, out and stage are distinct (n, row_bytes) buffers, n even; counters
// is 3 * n/2 uint32 words, all zero, that only launches ordered on one
// stream touch (the kernel leaves them zero).  Returns the launch's or the
// occupancy query's error, else cudaGetLastError().
extern "C" int pingpong_rows(const void* x, void* out, void* stage,
                             void* counters, int n, long long row_bytes,
                             void* stream) {
  if (n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(stage) |
                         (uintptr_t)row_bytes;
  if ((bits & 15) == 0) {
    return launch<uint4>(x, out, stage, counters, n, row_bytes, s);
  }
  if ((bits & 3) == 0) {
    return launch<uint32_t>(x, out, stage, counters, n, row_bytes, s);
  }
  if ((bits & 1) == 0) {
    return launch<uint16_t>(x, out, stage, counters, n, row_bytes, s);
  }
  return launch<uint8_t>(x, out, stage, counters, n, row_bytes, s);
}
