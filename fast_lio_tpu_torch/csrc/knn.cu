// 5-nearest-neighbour search over the planar-row voxel-hash map, for Hopper
// (sm_90a).  Built by fast_lio_tpu_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface, launched through ctypes by
// fast_lio_tpu_torch/kernels/knn.py.
//
// Replaces the TPU kernel tools/knn_pallas.py::_kernel (knn_search_pallas,
// pallas_call at tools/knn_pallas.py:193) and computes exactly the plain
// version, fast_lio_tpu_torch.map.hash_map.knn_search (= the JAX package's
// hash_map.knn_search): per query, the R = 8 (round-to-corner 2x2x2) or
// R = 27 (centered 3x3x3, "wide") cells of its search region, hashed to
// buckets; duplicate buckets skipped; each live slot's squared distance
// dx^2 + dy^2 + dz^2 + w; candidates outside the region's half-open AABB
// dropped; the 5 smallest (d2, candidate index) returned, ties to the lowest
// index.  The plain version orders candidates by sorted bucket id, then
// slot; the global key bucket * B + slot has the same order, so the kernel
// needs no sort — only the dedup.
//
// Design (first, simple, right): one warp per query.  Lanes 0..R-1 compute
// one region cell and its bucket each; a lane is a duplicate if an earlier
// lane holds the same bucket (R shuffles).  For each distinct bucket row the
// lanes read neighbouring slots of each channel (coalesced 128-byte
// segments), w first, and x/y/z only for live slots.  Each lane keeps a
// sorted top-5 of (d2, idx) in registers; five warp-wide argmin rounds on
// (d2, idx) pick the winners.  No shared-memory staging, wgmma or TMA.
//
// Bound on this card (H100 SXM, 3.35 TB/s): the rows it must read,
// N * R * 4B * 4 bytes, plus queries (12 N) and outputs (44 N).  At the avia
// preset's N = 8192, R = 8, B = 64 that is 67 MB, about 20 us; at the
// ouster64 preset's partial-wide K_w = 2048, R = 27, B = 128 it is 113 MB,
// about 34 us.  This design is latency-bound on dependent row reads: a warp
// walks its R rows one after the other, and each row is one round trip.
//
// Bitwise agreement with the plain version: see knn_common.cuh, which holds
// the hash, the top-5 and the row scoring this kernel shares with
// knn_grouped.cu.

#include "knn_common.cuh"

namespace {

using namespace knn_common;

template <int R>
__global__ void __launch_bounds__(256)
knn_kernel(const float* __restrict__ packed, const float* __restrict__ queries,
           int n, int B, uint32_t bucket_mask, float cell, float span,
           float* __restrict__ nbrs, float* __restrict__ sq,
           uint8_t* __restrict__ found) {
  const int q = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n) return;  // q is uniform across the warp

  const float qx = queries[3 * q + 0];
  const float qy = queries[3 * q + 1];
  const float qz = queries[3 * q + 2];

  // region base: floor(q / cell - 0.5) narrow, floor(q / cell - 1) wide
  const float shift = (R == 8) ? 0.5f : 1.0f;
  const int bx = region_base(qx, cell, shift);
  const int by = region_base(qy, cell, shift);
  const int bz = region_base(qz, cell, shift);
  // half-open AABB [lo, lo + span), f32 as region_bounds computes it
  const float lox = __fmul_rn(__int2float_rn(bx), cell);
  const float loy = __fmul_rn(__int2float_rn(by), cell);
  const float loz = __fmul_rn(__int2float_rn(bz), cell);
  const float hix = __fadd_rn(lox, span);
  const float hiy = __fadd_rn(loy, span);
  const float hiz = __fadd_rn(loz, span);

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
  uint32_t todo = __ballot_sync(FULL, lane < R && !dup);

  TopK top;
  top.init();
  while (todo) {
    const int r = __ffs(todo) - 1;
    todo &= todo - 1;
    const uint32_t b = __shfl_sync(FULL, bucket, r);
    score_row(packed + (size_t)b * 4 * B, b, B, lane, qx, qy, qz, lox, loy,
              loz, hix, hiy, hiz, top);
  }
  write_top5(top, lane, (size_t)q, nbrs, sq, found);
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() (0 = ok).
// packed (H, 4B) f32, queries (n, 3) f32, outputs nbrs (n, 5, 3) f32,
// sq (n, 5) f32, found (n, 5) uint8; all contiguous on the current device.
int knn_search_f32(const float* packed, const float* queries, int n,
                   int bucket_slots, unsigned int bucket_mask, float cell,
                   float span, int wide, float* nbrs, float* sq,
                   unsigned char* found, void* stream) {
  if (n <= 0) return 0;
  const int warps_per_block = 8;
  const dim3 block(32 * warps_per_block);
  const dim3 grid((n + warps_per_block - 1) / warps_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    knn_kernel<27><<<grid, block, 0, s>>>(packed, queries, n, bucket_slots,
                                          bucket_mask, cell, span, nbrs, sq,
                                          found);
  } else {
    knn_kernel<8><<<grid, block, 0, s>>>(packed, queries, n, bucket_slots,
                                         bucket_mask, cell, span, nbrs, sq,
                                         found);
  }
  return (int)cudaGetLastError();
}

const char* knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
