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
// Bitwise agreement with the plain version needs IEEE arithmetic in the
// plain version's order: never --use_fast_math; d2 is built from
// __fmul_rn/__fadd_rn (no FMA contraction) left to right as in
// hash_map.knn_search; q / cell is __fdiv_rn; the hash runs in uint32_t (a
// negative cell times a prime in int would be undefined behaviour).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr float W_VALID_MAX = 1.0e17f;
constexpr int NO_IDX = 0x7fffffff;

__device__ __forceinline__ uint32_t cell_hash(uint32_t cx, uint32_t cy,
                                              uint32_t cz) {
  uint32_t h = (cx * 73856093u) ^ (cy * 19349663u) ^ (cz * 83492791u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

struct TopK {
  float d[K];
  int id[K];
  float x[K], y[K], z[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = INFINITY;
      id[j] = NO_IDX;
      x[j] = y[j] = z[j] = 0.0f;
    }
  }

  // sorted insert; every compare reads entries not yet moved this call
  __device__ __forceinline__ void push(float nd, int ni, float nx, float ny,
                                       float nz) {
    if (!lex_less(nd, ni, d[K - 1], id[K - 1])) return;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool before_prev = lex_less(nd, ni, d[j - 1], id[j - 1]);
      const bool before_this = lex_less(nd, ni, d[j], id[j]);
      if (before_prev) {
        d[j] = d[j - 1]; id[j] = id[j - 1];
        x[j] = x[j - 1]; y[j] = y[j - 1]; z[j] = z[j - 1];
      } else if (before_this) {
        d[j] = nd; id[j] = ni; x[j] = nx; y[j] = ny; z[j] = nz;
      }
    }
    if (lex_less(nd, ni, d[0], id[0])) {
      d[0] = nd; id[0] = ni; x[0] = nx; y[0] = ny; z[0] = nz;
    }
  }

  __device__ __forceinline__ void pop_front() {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      d[j] = d[j + 1]; id[j] = id[j + 1];
      x[j] = x[j + 1]; y[j] = y[j + 1]; z[j] = z[j + 1];
    }
    d[K - 1] = INFINITY;
    id[K - 1] = NO_IDX;
  }
};

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
  const int bx = (int)floorf(__fsub_rn(__fdiv_rn(qx, cell), shift));
  const int by = (int)floorf(__fsub_rn(__fdiv_rn(qy, cell), shift));
  const int bz = (int)floorf(__fsub_rn(__fdiv_rn(qz, cell), shift));
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
    if (R == 8) {
      ox = (lane >> 2) & 1; oy = (lane >> 1) & 1; oz = lane & 1;
    } else {
      ox = lane / 9; oy = (lane / 3) % 3; oz = lane % 3;
    }
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
    const float* row = packed + (size_t)b * 4 * B;
    for (int s = lane; s < B; s += 32) {
      const float w = row[3 * B + s];
      if (!(w < W_VALID_MAX)) continue;  // free slot: d2 >= 1e18, never found
      const float x = row[s];
      const float y = row[B + s];
      const float z = row[2 * B + s];
      const float dx = __fsub_rn(x, qx);
      const float dy = __fsub_rn(y, qy);
      const float dz = __fsub_rn(z, qz);
      float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
      d2 = __fadd_rn(d2, w);
      const bool oob = x < lox || x >= hix || y < loy || y >= hiy ||
                       z < loz || z >= hiz;
      if (oob || !(d2 < W_VALID_MAX)) continue;
      top.push(d2, (int)(b * (uint32_t)B) + s, x, y, z);
    }
  }

  // five warp-wide argmin rounds on (d2, idx)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float bd = top.d[0];
    int bi = top.id[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, bd, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (lex_less(od, oi, bd, bi)) { bd = od; bi = oi; }
    }
    const bool hit = bi != NO_IDX;
    const bool mine = hit && top.id[0] == bi;
    const unsigned owner_mask = __ballot_sync(FULL, mine);
    float wx = 0.0f, wy = 0.0f, wz = 0.0f;
    if (owner_mask) {
      const int owner = __ffs(owner_mask) - 1;
      wx = __shfl_sync(FULL, top.x[0], owner);
      wy = __shfl_sync(FULL, top.y[0], owner);
      wz = __shfl_sync(FULL, top.z[0], owner);
    }
    if (mine) top.pop_front();
    if (lane == 0) {
      const size_t o = (size_t)q * K + k;
      sq[o] = hit ? bd : INFINITY;
      found[o] = hit ? 1 : 0;
      nbrs[3 * o + 0] = wx;
      nbrs[3 * o + 1] = wy;
      nbrs[3 * o + 2] = wz;
    }
  }
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
