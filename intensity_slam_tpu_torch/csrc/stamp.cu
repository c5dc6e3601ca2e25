// Device time stamps: the frame graph's regions on the card's own clock, for
// the span recorder of `utils/spans.py`.
//
// Replaces no kernel of the JAX package (XLA's profiler reads the TPU's
// clock itself; there is no Pallas source).  It was added because a
// replayed CUDA graph leaves no host-side mark of where its regions begin
// and end, and an event record node is not the tool: CUDA's rules for the
// body of a conditional node have admitted kernel, memset, memcpy, empty,
// child-graph and conditional nodes, and no event nodes, while the regions
// to time are mostly such bodies (on an H100 with the CUDA 12.8 runtime,
// capturing an external event record into an If body still fails with
// cudaErrorInvalidValue).  A kernel node is admitted everywhere.
//
// stamp_kernel: one thread.  It zeroes slots [clear_from, n) of the int64
// buffer `buf` (nothing where clear_from >= n), then writes the `%globaltimer`
// register (ns) into slot `slot`.  A slot left 0 reads as "the region did
// not run": the timer is never 0.  The host maps the stamps onto its own
// clock through a calibration (`isl_stamp_launch` between two host reads
// around a synchronize).
//
// Bound: a few stores of 8 bytes, so its time is the launch's and the node's
// evaluation, not its work; nothing to design beyond one thread.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(long long* buf, int slot, int clear_from, int n) {
  for (int i = clear_from; i < n; ++i) buf[i] = 0;
  buf[slot] = globaltimer();
}

}  // namespace

extern "C" {

// Launches stamp_kernel on `stream`.  Returns a cudaError_t.
int isl_stamp_launch(void* buf, int slot, int clear_from, int n, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), slot, clear_from, n);
  return cudaGetLastError();
}

const char* isl_stamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
