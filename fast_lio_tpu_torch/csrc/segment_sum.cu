// Sorted segmented mean: the voxel downsample's segment sums, counts and
// division (fast_lio_tpu_torch/ops/voxel_grid.py) in one launch, summed in
// one fixed order, so that the step gives the same result on every run.
// Built by fast_lio_tpu_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface, called through ctypes by
// fast_lio_tpu_torch/kernels/segment_sum.py.
//
// Replaces no pallas_call: the JAX package sums with XLA's sorted
// jax.ops.segment_sum(..., indices_are_sorted=True)
// (fast_lio_tpu/ops/voxel_grid.py:108-117), which adds each segment's
// values in sorted order, in sequence, starting from zero.  The port's
// plain version (index_add_) does the same on the CPU, but on CUDA
// index_add_ adds with atomics, in an order that changes from run to run,
// and its last bits can move a convergence test of the filter by a pass.
//
// Inputs, for each of `streams` lanes (blockIdx.y; the lanes' arrays
// contiguous one after the other):
//   cols  (n, c)  the points' columns in sorted order (x, y, z[, intensity])
//   live  (n,)    the sorted live mask
//   seg   (n,)    each point's segment, monotone non-decreasing; dead
//                 points (and live ones past the last kept voxel) carry
//                 n_out, the overflow segment, which is dropped
// Outputs: means (n_out, c), the sum of each segment's cols * live over
// max(its count, 1), zero for an empty segment; mask (n_out,), count > 0.
//
// One thread per output segment s: two binary searches, stepped together,
// find [b, e), the points of s, and the thread sums them from b to e in
// sequence, ((0 + v_b) + v_b+1) + ..., with IEEE round-to-nearest adds,
// products and division and no contraction into FMAs, which is what the
// plain version computes bit for bit.  Every output is written once, empty
// segments included, so nothing is zeroed first.  Bound: the bytes (each
// input read once, each output written once); a segment holds a few to a
// few hundred points at filter_size_surf 0.5 m, and the loop's loads do
// not depend on its sums, so they can be in flight together.  Its time is
// latency, far above that bound: the searches' 15-16 steps of dependent
// loads, then the longest segment's walk (on an H100 at 700 W, 13 us at
// the avia pad and 26 us at the ouster64 pad, whose segments are longer).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// The points of segment s in the sorted seg[0, n): [*b, *e), where *b
// counts the ids below s and *e those below s + 1.  Both searches step down
// the powers of two together, so each step's two loads are in flight at
// once and every thread of a warp runs the same steps.
__device__ __forceinline__ void segment_range(const long long* seg, int n,
                                              long long s, int* b, int* e) {
  int lo = 0, hi = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
    if (lo + step <= n && seg[lo + step - 1] < s) lo += step;
    if (hi + step <= n && seg[hi + step - 1] <= s) hi += step;
  }
  *b = lo;
  *e = hi;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    segment_mean_kernel(const T* __restrict__ cols,
                        const bool* __restrict__ live,
                        const long long* __restrict__ seg, int n, int n_out,
                        T* __restrict__ means, bool* __restrict__ mask) {
  const size_t lane = blockIdx.y;
  cols += lane * n * C;
  live += lane * n;
  seg += lane * n;
  means += lane * n_out * C;
  mask += lane * n_out;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_out) return;
  int b, e;
  segment_range(seg, n, s, &b, &e);
  T sum[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sum[c] = T(0);
  T cnt = T(0);
#pragma unroll 4
  for (int j = b; j < e; ++j) {
    const T w = live[j] ? T(1) : T(0);
#pragma unroll
    for (int c = 0; c < C; ++c)
      sum[c] = add_rn(sum[c], mul_rn(cols[(size_t)j * C + c], w));
    cnt = add_rn(cnt, w);
  }
  const T den = cnt > T(1) ? cnt : T(1);  // clamp_min(count, 1)
#pragma unroll
  for (int c = 0; c < C; ++c) means[(size_t)s * C + c] = div_rn(sum[c], den);
  mask[s] = cnt > T(0);
}

template <typename T>
int launch(const T* cols, const bool* live, const long long* seg, int n,
           int c, int n_out, int streams, T* means, bool* mask,
           void* stream) {
  if (n < 0 || n_out <= 0 || streams <= 0 || streams > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((n_out + kThreads - 1) / kThreads, streams);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3)
    segment_mean_kernel<T, 3>
        <<<grid, kThreads, 0, s>>>(cols, live, seg, n, n_out, means, mask);
  else if (c == 4)
    segment_mean_kernel<T, 4>
        <<<grid, kThreads, 0, s>>>(cols, live, seg, n, n_out, means, mask);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The segmented mean of `streams` lanes on `stream`; returns a cudaError_t
// (0 = ok).  c is 3 or 4.
int segment_mean_f32(const float* cols, const bool* live,
                     const long long* seg, int n, int c, int n_out,
                     int streams, float* means, bool* mask, void* stream) {
  return launch(cols, live, seg, n, c, n_out, streams, means, mask, stream);
}

int segment_mean_f64(const double* cols, const bool* live,
                     const long long* seg, int n, int c, int n_out,
                     int streams, double* means, bool* mask, void* stream) {
  return launch(cols, live, seg, n, c, n_out, streams, means, mask, stream);
}

const char* segment_mean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
