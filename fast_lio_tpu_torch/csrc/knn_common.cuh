// Device code shared by the two kNN kernels (knn.cu, knn_grouped.cu): the
// cell hash, the (d2, index) order as one key, the per-lane sorted top-5,
// the row scoring, and the Hopper bulk-copy (TMA) and mbarrier primitives
// that stage bucket rows in shared memory.  The scoring and the top-5 take
// the scalar type T (float, or double for compute_dtype float64); the
// grouped kernel is float only.
//
// Bitwise agreement with the plain PyTorch versions needs IEEE arithmetic
// in their order: never --use_fast_math; d2 is built from the _rn
// intrinsics (__fmul_rn / __dmul_rn, __fadd_rn / __dadd_rn: no FMA
// contraction) left to right as in hash_map.knn_search; q / cell is
// __fdiv_rn / __ddiv_rn; the region's AABB is f32 in both types, as
// hash_map.region_bounds computes it; the hash runs in uint32_t (a negative
// cell times a prime in int would be undefined behaviour).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace knn_common {

constexpr int K = 5;
constexpr unsigned FULL = 0xffffffffu;
// a squared distance at or above this is no point (a free slot's w is 1e18)
template <class T>
constexpr T W_VALID_MAX = T(1.0e17);

// IEEE round-to-nearest arithmetic, one overload per scalar type
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

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

// Region base cell of one coordinate: floor(q / cell - shift), with shift
// 0.5 for the round-to-corner 2x2x2 region and 1 for the centered 3x3x3,
// in the queries' type.
__device__ __forceinline__ int region_base(float q, float cell, float shift) {
  return (int)floorf(__fsub_rn(__fdiv_rn(q, cell), shift));
}
__device__ __forceinline__ int region_base(double q, double cell,
                                           double shift) {
  return (int)floor(__dsub_rn(__ddiv_rn(q, cell), shift));
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

// Bucket of region cell r of the region at base (bx, by, bz).
template <int R>
__device__ __forceinline__ uint32_t region_bucket(int bx, int by, int bz,
                                                  int r,
                                                  uint32_t bucket_mask) {
  uint32_t ox, oy, oz;
  region_offset<R>(r, ox, oy, oz);
  return cell_hash((uint32_t)bx + ox, (uint32_t)by + oy,
                   (uint32_t)bz + oz) & bucket_mask;
}

// True on lanes sub = 0..R-1 of a group of lanes (the L lanes from `base`)
// whose bucket no lower lane of the group holds.  All 32 lanes call.
template <int R>
__device__ __forceinline__ bool first_of_bucket(uint32_t bucket, int sub,
                                                int base) {
  bool dup = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t bj = __shfl_sync(FULL, bucket, base + j);
    dup = dup || (j < sub && bj == bucket);
  }
  return sub < R && !dup;
}

// A query and its region's half-open AABB [lo, lo + span), the AABB f32 in
// both types as region_bounds computes it (base * f32(cell), + f32(span));
// a double coordinate compares with it as torch promotes the f32 bound.
template <class T>
struct QueryT {
  T x, y, z;
  float lox, loy, loz, hix, hiy, hiz;

  __device__ __forceinline__ QueryT(T qx, T qy, T qz, T cell, T shift,
                                    float span)
      : x(qx), y(qy), z(qz) {
    const float cf = (float)cell;
    lox = __fmul_rn(__int2float_rn(region_base(qx, cell, shift)), cf);
    loy = __fmul_rn(__int2float_rn(region_base(qy, cell, shift)), cf);
    loz = __fmul_rn(__int2float_rn(region_base(qz, cell, shift)), cf);
    hix = __fadd_rn(lox, span);
    hiy = __fadd_rn(loy, span);
    hiz = __fadd_rn(loz, span);
  }
};
using Query = QueryT<float>;

// A candidate as a key whose order is the (d2, index) order.  A pushed d2
// is finite and >= +0 (a sum of squares plus w = 0), where the bits of a
// float or a double order as the number does.  Float: one 64-bit key, the
// bits of d2 above the index, so one compare replaces two.  Double: the 64
// bits of d2 and the index, compared as a pair.  none() is above every key.
template <class T>
struct Cand;

template <>
struct Cand<float> {
  using Key = uint64_t;
  static __device__ __forceinline__ Key make(float d2, int idx) {
    return ((uint64_t)__float_as_uint(d2) << 32) | (uint32_t)idx;
  }
  static __device__ __forceinline__ Key none() { return ~0ull; }
  static __device__ __forceinline__ bool less(Key a, Key b) { return a < b; }
  static __device__ __forceinline__ bool same(Key a, Key b) { return a == b; }
  static __device__ __forceinline__ Key shfl_xor(unsigned mask, Key k,
                                                 int off) {
    return __shfl_xor_sync(mask, k, off);
  }
  static __device__ __forceinline__ float d2(Key k) {
    return __uint_as_float((uint32_t)(k >> 32));
  }
  static __device__ __forceinline__ int idx(Key k) {
    return (int)(uint32_t)k;
  }
};

template <>
struct Cand<double> {
  struct Key {
    uint64_t d2;
    uint32_t idx;
  };
  static __device__ __forceinline__ Key make(double d2, int idx) {
    return Key{(uint64_t)__double_as_longlong(d2), (uint32_t)idx};
  }
  static __device__ __forceinline__ Key none() { return Key{~0ull, ~0u}; }
  static __device__ __forceinline__ bool less(Key a, Key b) {
    return a.d2 < b.d2 || (a.d2 == b.d2 && a.idx < b.idx);
  }
  static __device__ __forceinline__ bool same(Key a, Key b) {
    return a.d2 == b.d2 && a.idx == b.idx;
  }
  static __device__ __forceinline__ Key shfl_xor(unsigned mask, Key k,
                                                 int off) {
    return Key{__shfl_xor_sync(mask, k.d2, off),
               __shfl_xor_sync(mask, k.idx, off)};
  }
  static __device__ __forceinline__ double d2(Key k) {
    return __longlong_as_double((long long)k.d2);
  }
  static __device__ __forceinline__ int idx(Key k) { return (int)k.idx; }
};

// The lane's sorted best five candidate keys; the winners' coordinates
// are read once at the end (write_top5), so they take no registers here.
template <class T>
struct TopKT {
  using C = Cand<T>;
  typename C::Key key[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) key[j] = C::none();
  }

  // sorted insert by compare-exchange down the list (no branch inside)
  __device__ __forceinline__ void push(T d2, int idx) {
    typename C::Key c = C::make(d2, idx);
    if (!C::less(c, key[K - 1])) return;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool lt = C::less(c, key[j]);
      const typename C::Key lo = lt ? c : key[j];
      c = lt ? key[j] : c;
      key[j] = lo;
    }
  }

  __device__ __forceinline__ void pop_front() {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) key[j] = key[j + 1];
    key[K - 1] = C::none();
  }
};
using TopK = TopKT<float>;

// Scores slot s of one bucket row (planar [x(B) | y(B) | z(B) | w(B)], in
// device or shared memory) against one query: a free slot is skipped, a
// candidate outside the region's half-open AABB dropped, and the rest pushed
// into the lane's top-5 with the global index bucket * B + s.
template <class T>
__device__ __forceinline__ void score_slot(const T* row, int s,
                                           uint32_t bucket, int B,
                                           const QueryT<T>& q, TopKT<T>& top) {
  const T w = row[3 * B + s];
  if (!(w < W_VALID_MAX<T>)) return;  // free slot: d2 >= 1e18, never found
  const T x = row[s];
  const T y = row[B + s];
  const T z = row[2 * B + s];
  const T dx = sub_rn(x, q.x);
  const T dy = sub_rn(y, q.y);
  const T dz = sub_rn(z, q.z);
  T d2 = add_rn(mul_rn(dx, dx), mul_rn(dy, dy));
  d2 = add_rn(d2, mul_rn(dz, dz));
  d2 = add_rn(d2, w);
  const bool oob = x < q.lox || x >= q.hix || y < q.loy || y >= q.hiy ||
                   z < q.loz || z >= q.hiz;
  if (oob || !(d2 < W_VALID_MAX<T>)) return;
  top.push(d2, (int)(bucket * (uint32_t)B) + s);
}

// Scores a whole row, the lanes of the warp on neighbouring slots.
template <class T>
__device__ __forceinline__ void score_row(const T* row, uint32_t bucket,
                                          int B, int lane, const QueryT<T>& q,
                                          TopKT<T>& top) {
  for (int s = lane; s < B; s += 32) score_slot(row, s, bucket, B, q, top);
}

// Five argmin rounds on the candidate keys over the L lanes (16 or 32, a
// half warp or a warp, named by `mask`) that searched query o: lane sub = k
// of them ends up holding winner k and writes row o, entry k of the outputs
// (sq +inf and found 0 where fewer than 5 were found), with the winner's
// coordinates from coords(idx, x, y, z).  Candidate indices are unique
// across the lanes, so exactly one lane owns each winner and pops it.
template <int L, class T, class Coords>
__device__ __forceinline__ void write_top5(TopKT<T>& top, int sub,
                                           unsigned mask, size_t o,
                                           const Coords& coords, T* nbrs,
                                           T* sq, uint8_t* found) {
  using C = Cand<T>;
  typename C::Key mine = C::none();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    typename C::Key best = top.key[0];
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const typename C::Key other = C::shfl_xor(mask, best, off);
      best = C::less(other, best) ? other : best;
    }
    if (!C::same(best, C::none()) && C::same(top.key[0], best))
      top.pop_front();
    if (sub == k) mine = best;
  }
  if (sub < K) {
    const size_t j = o * K + sub;
    const bool hit = !C::same(mine, C::none());
    T x = T(0), y = T(0), z = T(0);
    if (hit) coords(C::idx(mine), x, y, z);
    sq[j] = hit ? C::d2(mine) : T(INFINITY);
    found[j] = hit ? 1 : 0;
    nbrs[3 * j + 0] = x;
    nbrs[3 * j + 1] = y;
    nbrs[3 * j + 2] = z;
  }
}

// ---------------------------------------------------------------------------
// Hopper: 1-D bulk copies (TMA) from global to shared memory, completing on
// an mbarrier in shared memory (PTX ISA 8.0, sm_90).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes initialised mbarriers visible to the async proxy (the bulk copies)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// orders this thread's earlier shared-memory accesses before its later
// bulk copies into the same buffers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one arrival that also announces `bytes` to be delivered by bulk copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// bytes (a multiple of 16) from src to dst, both 16-byte aligned; completes
// `bytes` of the barrier's expected transaction count
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory a block may take on this device, less its static part.
template <class Kernel>
__host__ int max_dynamic_smem(Kernel kernel, int* bytes) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)attr.sharedSizeBytes;
  return 0;
}

}  // namespace knn_common
