// Stage stamps of the port's step on the device's clock, for the tracer
// (fast_lio_tpu_torch/tracing.py).  Built at first use by
// fast_lio_tpu_torch/kernels/build.py when the tracer is enabled (not one of
// its LIBS, which every run builds), called through ctypes.  No kernel of the
// TPU package: it replaces no pallas_call, and computes nothing the step
// reads.
//
//   stamp_launch   one one-thread kernel on `stream`: it reads %globaltimer
//                  (ns) first, then writes it into ring[row][col], row =
//                  *index mod rows; where `last`, it advances *index by one.
//                  Launched inside a stream capture, it becomes a kernel
//                  node of the graph, so every replay writes a row of its
//                  own.  Its cost is a launch's (about an empty node's,
//                  1.2 us on the H100): nothing here waits on memory but
//                  the index's one load.
//   stamp_clock    one one-thread kernel that writes %globaltimer to *out:
//                  the tracer launches it between two host clock reads
//                  around a synchronize to map the device's clock onto the
//                  host's.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(unsigned long long* ring,
                             unsigned long long* index, int rows, int cols,
                             int col, int last) {
  const unsigned long long t = global_timer();
  const unsigned long long i = *index;
  ring[(i % rows) * cols + col] = t;
  if (last) *index = i + 1;
}

__global__ void clock_kernel(unsigned long long* out) { *out = global_timer(); }

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = ok).
int stamp_launch(void* ring, void* index, int rows, int cols, int col,
                 int last, void* stream) {
  if (rows <= 0 || col < 0 || col >= cols) return cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring),
      static_cast<unsigned long long*>(index), rows, cols, col, last);
  return cudaGetLastError();
}

int stamp_clock(void* out, void* stream) {
  clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

const char* stamp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
