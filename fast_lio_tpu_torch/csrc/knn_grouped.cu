// Region-grouped 5-nearest-neighbour search over the planar-row voxel-hash
// map, for Hopper (sm_90a).  Built by fast_lio_tpu_torch/kernels/build.py
// with nvcc into a shared library with a plain C interface, launched through
// ctypes by fast_lio_tpu_torch/kernels/knn_grouped.py.
//
// Replaces the TPU kernel tools/knn_grouped.py::_kernel (knn_search_grouped,
// pallas_call at tools/knn_grouped.py:217) and computes what it computes:
// the queries, sorted by a static-origin region key with 10 bits per axis
// and cut into groups of at most 8 with equal key (the wrapper does that
// with torch ops, as the JAX wrapper does it in XLA), search the R = 8
// (round-to-corner 2x2x2) or R = 27 (centered 3x3x3) cells of the group
// HEAD's region, hashed to buckets, duplicates skipped; each query keeps
// its own half-open AABB, and the 5 smallest (d2, bucket * B + slot) win,
// ties to the lowest index.  For a query whose key is not clamped the head's
// region is its own, so the result equals hash_map.knn_search and csrc/knn.cu
// bit for bit; a clamped key (a coordinate beyond 512 storage cells) keeps
// the TPU kernel's semantics: the head's rows, the query's own AABB.
//
// Design (first, simple, right): one thread block per group.  Warp 0
// computes the head's R buckets and marks duplicates (R shuffles); the
// block stages the distinct rows (R * 4B floats) in dynamic shared memory
// with coalesced 16-byte loads; then warp w scores query w of the group
// against the staged rows, with the per-lane top-5 and the five warp-wide
// argmin rounds of knn.cu, and writes the result straight to the query's
// original index (the un-sort is this scatter).  The TPU kernel loops over a
// traced group count and lets a group's writes run 8 rows past its start,
// rewritten by the next group in its sequential grid; GPU blocks run in no
// order, so here block g writes only its own members,
// starts[g+1] - starts[g] (<= 8) queries, and the grid is N blocks (an
// upper bound on the group count): block g reads n_groups from device
// memory and exits when g >= n_groups, so no host read of the count.
// Shared memory: 8 KB at R = 8, B = 64; 54 KB at R = 27, B = 128 (above
// the 48 KB default, so the launcher raises the kernel's dynamic limit).
//
// Bound on this card (H100 SXM, 3.35 TB/s): rows read once per group,
// n_groups * R * 4B * 4 bytes, plus queries (12 N + 4 N of order) and
// outputs (44 N).  The design reaches that traffic only where groups are
// full: a group of one query reads its R rows for that query alone, as
// knn.cu does, and then pays a block's staging and barrier on top.
// Bitwise agreement with the plain version: see knn_common.cuh.

#include "knn_common.cuh"

namespace {

using namespace knn_common;

constexpr int G = 8;  // queries per group = warps per block

template <int R>
__global__ void __launch_bounds__(32 * G)
knn_grouped_kernel(const float* __restrict__ packed,
                   const float* __restrict__ queries,
                   const int* __restrict__ order,
                   const int* __restrict__ starts,
                   const int* __restrict__ n_groups_ptr, int n, int B,
                   uint32_t bucket_mask, float cell, float span,
                   float* __restrict__ nbrs, float* __restrict__ sq,
                   uint8_t* __restrict__ found) {
  extern __shared__ float4 rows4[];  // R rows of 4B floats
  __shared__ uint32_t row_bucket[R];
  __shared__ int row_live[R];  // 0 for a duplicate bucket

  const int g = blockIdx.x;
  const int n_groups = *n_groups_ptr;
  if (g >= n_groups) return;  // uniform across the block
  const int s = starts[g];
  const int e = (g + 1 < n_groups) ? starts[g + 1] : n;
  const int members = min(G, e - s);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float shift = (R == 8) ? 0.5f : 1.0f;

  // the head's R buckets, duplicates marked (lanes 0..R-1 of warp 0)
  if (warp == 0) {
    const int h = order[s];
    const int bx = region_base(queries[3 * h + 0], cell, shift);
    const int by = region_base(queries[3 * h + 1], cell, shift);
    const int bz = region_base(queries[3 * h + 2], cell, shift);
    uint32_t bucket = 0xffffffffu;
    if (lane < R) {
      uint32_t ox, oy, oz;
      region_offset<R>(lane, ox, oy, oz);
      bucket = cell_hash((uint32_t)bx + ox, (uint32_t)by + oy,
                         (uint32_t)bz + oz) & bucket_mask;
    }
    bool dup = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t bj = __shfl_sync(FULL, bucket, j);
      dup = dup || (j < lane && bj == bucket);
    }
    if (lane < R) {
      row_bucket[lane] = bucket;
      row_live[lane] = dup ? 0 : 1;
    }
  }
  __syncthreads();

  // stage the distinct rows: row r is B float4s
  for (int i = threadIdx.x; i < R * B; i += blockDim.x) {
    const int r = i / B;
    if (row_live[r]) {
      const float4* src = reinterpret_cast<const float4*>(
          packed + (size_t)row_bucket[r] * 4 * B);
      rows4[i] = src[i - r * B];
    }
  }
  __syncthreads();
  if (warp >= members) return;

  const int qi = order[s + warp];
  const float qx = queries[3 * qi + 0];
  const float qy = queries[3 * qi + 1];
  const float qz = queries[3 * qi + 2];
  // the query's own half-open AABB [lo, lo + span)
  const float lox = __fmul_rn(__int2float_rn(region_base(qx, cell, shift)), cell);
  const float loy = __fmul_rn(__int2float_rn(region_base(qy, cell, shift)), cell);
  const float loz = __fmul_rn(__int2float_rn(region_base(qz, cell, shift)), cell);
  const float hix = __fadd_rn(lox, span);
  const float hiy = __fadd_rn(loy, span);
  const float hiz = __fadd_rn(loz, span);

  const float* rows = reinterpret_cast<const float*>(rows4);
  TopK top;
  top.init();
  for (int r = 0; r < R; ++r) {
    if (!row_live[r]) continue;  // uniform across the warp
    score_row(rows + (size_t)r * 4 * B, row_bucket[r], B, lane, qx, qy, qz,
              lox, loy, loz, hix, hiy, hiz, top);
  }
  write_top5(top, lane, (size_t)qi, nbrs, sq, found);
}

template <int R>
int launch(const float* packed, const float* queries, const int* order,
           const int* starts, const int* n_groups, int n, int B,
           uint32_t bucket_mask, float cell, float span, float* nbrs,
           float* sq, uint8_t* found, cudaStream_t stream) {
  const size_t smem = (size_t)R * 4 * B * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_grouped_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  knn_grouped_kernel<R><<<n, 32 * G, smem, stream>>>(
      packed, queries, order, starts, n_groups, n, B, bucket_mask, cell,
      span, nbrs, sq, found);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the grouped search on `stream` and returns the CUDA error of the
// launch (0 = ok).  packed (H, 4B) f32 (16-byte aligned), queries (n, 3)
// f32, order (n) int32 (queries sorted by region key), starts (n) int32
// (group starts in sorted order, the first n_groups used), n_groups (1)
// int32 on the device; outputs nbrs (n, 5, 3) f32, sq (n, 5) f32, found
// (n, 5) uint8, in the queries' original order; all contiguous on the
// current device.
int knn_grouped_f32(const float* packed, const float* queries,
                    const int* order, const int* starts, const int* n_groups,
                    int n, int bucket_slots, unsigned int bucket_mask,
                    float cell, float span, int wide, float* nbrs, float* sq,
                    unsigned char* found, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    return launch<27>(packed, queries, order, starts, n_groups, n,
                      bucket_slots, bucket_mask, cell, span, nbrs, sq, found,
                      s);
  }
  return launch<8>(packed, queries, order, starts, n_groups, n, bucket_slots,
                   bucket_mask, cell, span, nbrs, sq, found, s);
}

const char* knn_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
