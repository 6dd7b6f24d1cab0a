// Device code shared by the two kNN kernels (knn.cu, knn_grouped.cu): the
// cell hash, the (d2, index) order and the per-lane sorted top-5.
//
// Bitwise agreement with the plain PyTorch versions needs IEEE arithmetic
// in their order: never --use_fast_math; d2 is built from __fmul_rn and
// __fadd_rn (no FMA contraction) left to right as in hash_map.knn_search;
// q / cell is __fdiv_rn; the hash runs in uint32_t (a negative cell times a
// prime in int would be undefined behaviour).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace knn_common {

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

// Region base cell of one coordinate: floor(q / cell - shift), with shift
// 0.5 for the round-to-corner 2x2x2 region and 1 for the centered 3x3x3.
__device__ __forceinline__ int region_base(float q, float cell, float shift) {
  return (int)floorf(__fsub_rn(__fdiv_rn(q, cell), shift));
}

// Offset of region cell r (0 <= r < R) from the base, in the plain
// version's order (x slowest, z fastest).
template <int R>
__device__ __forceinline__ void region_offset(int r, uint32_t& ox,
                                              uint32_t& oy, uint32_t& oz) {
  if (R == 8) {
    ox = (r >> 2) & 1; oy = (r >> 1) & 1; oz = r & 1;
  } else {
    ox = r / 9; oy = (r / 3) % 3; oz = r % 3;
  }
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

// Scores one bucket row (planar [x(B) | y(B) | z(B) | w(B)], in device or
// shared memory) against one query: the lanes of the warp take
// neighbouring slots, skip free slots before reading x, y, z, drop
// candidates outside the region's half-open AABB [lo, hi), and push the
// rest into the lane's top-5 with the global index bucket * B + slot.
__device__ __forceinline__ void score_row(
    const float* row, uint32_t bucket, int B, int lane, float qx, float qy,
    float qz, float lox, float loy, float loz, float hix, float hiy,
    float hiz, TopK& top) {
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
    top.push(d2, (int)(bucket * (uint32_t)B) + s, x, y, z);
  }
}

// Five warp-wide argmin rounds on (d2, idx); lane 0 writes the query's row
// o of the outputs (sq +inf and found 0 where fewer than 5 were found).
__device__ __forceinline__ void write_top5(TopK& top, int lane, size_t o,
                                           float* nbrs, float* sq,
                                           uint8_t* found) {
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
      const size_t j = o * K + k;
      sq[j] = hit ? bd : INFINITY;
      found[j] = hit ? 1 : 0;
      nbrs[3 * j + 0] = wx;
      nbrs[3 * j + 1] = wy;
      nbrs[3 * j + 2] = wz;
    }
  }
}

}  // namespace knn_common
