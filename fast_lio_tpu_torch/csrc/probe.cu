// Measurement kernels, on no path of the step: the floor under every
// launch, and the latency of one dependent add.  Built at first use by
// fast_lio_tpu_torch/kernels/build.py (not one of its LIBS, which the
// path builds), called through ctypes by fast_lio_tpu_torch/tools/probe.py:
// the empty node stands beside the kernels' times (chip_smoke.py phase 2),
// the add's cycles set the chain term of kernels/bounds.segment_mean_bound.
//
//   probe_empty         one empty one-thread kernel: in a CUDA graph of 100
//                       such launches, the least a kernel node costs
//   probe_add_chain_*   one thread adds `steps` times into one register,
//                       each add waiting on the one before (IEEE
//                       round-to-nearest, as segment_sum.cu adds), timed
//                       with the SM's cycle counter: cycles per add

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void add_chain_kernel(const T* x, T* out, long long* cycles,
                                 int steps) {
  T v = x[0];
  const T d = x[1];
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) v = add_rn(v, d);
  const long long t1 = clock64();
  out[0] = v;  // keeps the chain
  cycles[0] = t1 - t0;
}

template <typename T>
int add_chain(const T* x, T* out, long long* cycles, int steps,
              void* stream) {
  if (steps <= 0) return cudaErrorInvalidValue;
  add_chain_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, cycles, steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = ok).
int probe_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// x: (2,) the chain's start and the addend; out: (1,) its end; cycles:
// (1,) int64, the cycles of the `steps` adds.
int probe_add_chain_f32(const float* x, float* out, long long* cycles,
                        int steps, void* stream) {
  return add_chain(x, out, cycles, steps, stream);
}

int probe_add_chain_f64(const double* x, double* out, long long* cycles,
                        int steps, void* stream) {
  return add_chain(x, out, cycles, steps, stream);
}

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
