// The trace fence's gate: the first node of a trace pair's lo-leg graph
// waits until the host has submitted both legs' graphs.
//
// Replaces no TPU kernel.  It belongs to the timing layer
// (tpu_perf_torch/timing.py, TraceRunner): each leg of a trace pair is one
// CUDA graph whose events bracket the leg on the device's clock.  A replay
// is fed to the card by the host thread that launches it, so the card can
// run a leg's first kernels while the host is still submitting the rest;
// if that thread is preempted in between, the card waits inside the leg,
// between two of its kernels (on an H100 80GB HBM3, 11-17 lo legs of 20000
// stalled 0.03-1.2 ms in a fresh process, 71 with a busy process on every
// host core: `python -m tpu_perf_torch.tools.fence_windows --part daemon`).
// With the gate first, the host replays lo, replays hi, then raises its
// flag: every kernel of both legs is already on the card's queue when the
// first one starts.
//
// What it computes.  One thread: want = *seen + 1; it polls the host's
// flag (pinned host memory, read over the bus) until *flag >= want, then
// stores *seen = want.  The host raises its flag by one after each pair's
// two replays, so the gate opens once a pair.  After timeout_ns on the
// device's global timer it stops waiting, counts the miss in *missed and
// opens anyway: a host that never raises its flag cannot hold the card.
//
// Bound: none to speak of; the card waits for the host by design.  Once the
// flag is up the gate costs one read over the bus and one store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void trace_gate_kernel(const volatile unsigned* flag,
                                  unsigned* seen, unsigned* missed,
                                  unsigned long long timeout_ns) {
  const unsigned want = *seen + 1;
  const unsigned long long t0 = global_ns();
  while (*flag < want) {
    if (global_ns() - t0 > timeout_ns) {
      *missed += 1;
      break;
    }
    __nanosleep(128);
  }
  *seen = want;
  __threadfence();
}

}  // namespace

// (flag: pinned host memory, seen and missed: device memory, timeout in
// nanoseconds, stream)
extern "C" int trace_gate(const void* flag, void* seen, void* missed,
                          long long timeout_ns, void* stream) {
  trace_gate_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const volatile unsigned*)flag, (unsigned*)seen, (unsigned*)missed,
      (unsigned long long)timeout_ns);
  return (int)cudaGetLastError();
}
