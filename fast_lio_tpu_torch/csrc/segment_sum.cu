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
//   seg   (n,)    each point's segment, monotone non-decreasing, in
//                 [0, n_out]; dead points (and live ones past the last kept
//                 voxel) carry n_out, the overflow segment, which is dropped
// Outputs: means (n_out, c), the sum of each segment's cols * live over
// max(its count, 1), zero for an empty segment; mask (n_out,), count > 0.
// Every segment is summed from +0.0 in sorted order, in sequence,
// ((0 + v_b w_b) + v_b+1 w_b+1) + ..., with IEEE round-to-nearest adds,
// products and division and no contraction into FMAs: the plain version's
// bits.  Every output is written once, empty segments included, so nothing
// is zeroed first.
//
// Design.  The ids are dense on the main path: segments 0..k-1 hold the
// kept points and k..n_out-1 are empty (k = 2577 of 8192 at avia's pad,
// 3860 at ouster64's, in the microbenchmark's runs); a segment holds up to
// 87 points at avia's pad and 212 at ouster64's (p99 16 and 84).  The sums
// are cheap (the longest chain, 212 dependent adds, is about 0.5 us); the
// time goes to latency and, in a launch over lanes, to each SM's share of
// the work.  So:
//  - A block owns a range of points, not of outputs: 96 points (Narrow),
//    so that avia's 12,800 kept points fill 134 blocks and ouster64's
//    44,032 fill 459, over the 132 SMs; over several lanes (Wide), 128
//    points a block and at least 16 blocks an SM (registers capped at 64),
//    since the lanes give blocks enough.
//  - It stages 192 points from its first (its own and a halo) into shared
//    memory in one round of coalesced 16-byte cp.async copies, the ragged
//    ends a byte a thread: f32 rows of 3 columns are 12 bytes and the live
//    flags 1 byte, so a range rarely starts or ends on 16 bytes, and the
//    shared copy keeps the source's offset mod 16.
//  - Heads are found in one pass over the staged ids, with no search:
//    point j heads segment seg[j] when seg[j] < n_out and seg[j - 1]
//    differs (j - 1's id comes from the lane before, by shuffle).  A ballot
//    per 32 points ranks them: the r-th head's segment is [head r,
//    head r + 1) of the tile.  The same pass turns each point into the
//    values its chains add, its columns times its live flag and the flag,
//    C + 1 a point in shared memory (vals).
//  - A segment's C + 1 chains (its columns and its count) go to C + 1
//    neighbouring lanes, 6 or 8 segments a warp; each lane adds its column
//    of vals in sorted order, the loads a batch ahead of the adds, and the
//    count lane hands the count to the others by shuffle for the division.
//    Neighbouring segments' rows are written by neighbouring lanes.
//  - A segment that runs past the staged tile (at most one a block: the
//    one holding the tile's last point) is walked tile by tile: the block
//    stages the next 192 points and the segment's lanes carry their sums
//    in registers, which keeps the order.
//  - Empty segments are written by the block that owns the ids around
//    them: block b owns the ids in (seg[lo - 1], seg[hi - 1]] (clamped to
//    n_out - 1; the last block up to n_out - 1), and every non-empty one
//    has its head among the block's points.  The runs of empty ids between
//    its heads' ids (the empty tail k..n_out-1 falls to the block holding
//    the first overflow point, or to the last block) go to a list in
//    shared memory; the block zeroes them 16 bytes a store, each warp as
//    soon as its walk is done.  No grid-wide sync, flag or memset node:
//    with no kept point at all (all dead, or n = 0), block 0 owns every
//    id.  Blocks whose points are all past that one exit after staging.
// Bound: the bytes (each input read once, each output written once) or the
// longest segment's chain of dependent adds, whichever is longer.  The
// kernel is latency: one launch, one staging round, two barriers, the
// walk, and at avia's pad the tail's 5,619 empty rows, which one block
// writes.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 2: a CUDA graph of 100 calls, per call): 4.79 us at avia's pad (f32;
// f64 6.21), 4.96 at ouster64's (f64 6.01), 6.44-9.22 over 4 lanes; the
// kernel it replaced (a thread an output segment, two binary searches, a
// serial walk through L2) took 13.32 / 25.75.  The staging and the shapes
// were chosen by timing builds side by side on that card while the kernel
// was designed: cp.async staging beat loads through registers at both
// pads; 96 points a block (192 threads) took the least at ouster64's pad,
// where the old kernel lost to index_add_, while 64 and 128 were faster
// at avia's pad but slower at ouster64's.  The tail is
// written by a block, not by a memset node, which would add a node to
// every step's graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A launch's shape: the points a block owns, the points a round stages
// (its own and a halo), its threads, and the blocks an SM must hold at
// once (which caps the registers)
template <int Own, int Tile, int Threads, int MinBlocks>
struct Shape {
  static constexpr int kOwn = Own, kTile = Tile, kThreads = Threads;
  static constexpr int kMinBlocks = MinBlocks;
  static constexpr int kGroups = Tile / 32;           // ballots over a tile
  static constexpr int kPerThread = Tile / Threads;   // staged points a thread
  static_assert(Tile % Threads == 0 && Threads % 32 == 0,
                "a tile is whole warps' points");
  static_assert(Own <= Tile, "a block stages its own points in one round");
};
// one lane (the single step): 96 points a block, so that avia's 12,800
// kept points fill 134 blocks over the 132 SMs; several lanes (the batched
// step's launch): 128 points a block and at least 16 blocks an SM, since
// the lanes give blocks enough
struct Narrow : Shape<96, 192, 192, 1> {};
struct Wide : Shape<128, 192, 64, 16> {};

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

// bytes of shared memory that hold nbytes copied at any offset mod 16, a
// multiple of 16
__host__ __device__ constexpr int room(int nbytes) {
  return (nbytes + 31) / 16 * 16;
}

// Copy the nbytes at src (device memory) into shared memory inside buf
// (16-byte aligned, room(nbytes) long) at src's offset mod 16, so the
// aligned middle goes in 16-byte copies; returns where src's first byte
// landed.  The block's threads share the copies; staged() waits for them.
__device__ __forceinline__ unsigned char* stage(unsigned char* buf,
                                                const unsigned char* src,
                                                int nbytes) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = buf + mis;
  const int head = min(nbytes, (16 - mis) & 15);
  const int chunks = (nbytes - head) >> 4;
  const int tail = nbytes - head - (chunks << 4);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    unsigned char* d = dst + head + (i << 4);
    const unsigned char* s = src + head + (i << 4);
    const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(d));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd),
                 "l"(s));
  }
  for (int i = threadIdx.x; i < head + tail; i += blockDim.x) {
    const int k = i < head ? i : i + (chunks << 4);
    dst[k] = src[k];
  }
  return dst;
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Zero the nbytes at dst (device memory), 16 bytes a store in the aligned
// middle, the block's threads side by side.
__device__ __forceinline__ void zero_bytes(unsigned char* dst, size_t nbytes) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = static_cast<int>(min(nbytes, size_t((16 - mis) & 15)));
  const size_t chunks = (nbytes - head) >> 4;
  const int tail = static_cast<int>(nbytes - head - (chunks << 4));
  uint4* mid = reinterpret_cast<uint4*>(dst + head);
#pragma unroll 4
  for (size_t i = threadIdx.x; i < chunks; i += blockDim.x)
    mid[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < head + tail; i += blockDim.x)
    dst[i < head ? i : head + (chunks << 4) + (i - head)] = 0;
}

// One lane's chain over the tile's points [b, e): its column of vals (the
// tile's values as the chains add them, C + 1 a point) added to s one by
// one in sorted order, K loads issued before their adds.
template <typename T, int C>
__device__ __forceinline__ T walk(const T* vals, int b, int e, int c, T s) {
  constexpr int K = 8;
  const T* v = vals + c;
  int p = b;
  for (; p + K <= e; p += K) {
    T x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = v[(p + k) * (C + 1)];
#pragma unroll
    for (int k = 0; k < K; ++k) s = add_rn(s, x[k]);
  }
  for (; p < e; ++p) s = add_rn(s, v[p * (C + 1)]);
  return s;
}

template <typename T, int C, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
    segment_mean_kernel(const T* __restrict__ cols,
                        const bool* __restrict__ live,
                        const long long* __restrict__ seg, int n, int n_out,
                        T* __restrict__ means, bool* __restrict__ mask) {
  constexpr int kOwn = S::kOwn, kTile = S::kTile, kThreads = S::kThreads;
  constexpr int kGroups = S::kGroups, kPerThread = S::kPerThread;
  // a segment's chains go to C + 1 neighbouring lanes (its columns and
  // its count), kPerWarp segments a warp at once
  constexpr int kLanes = C + 1;
  constexpr int kPerWarp = 32 / kLanes;
  constexpr int kWalkers = kThreads / 32 * kPerWarp;
  // vals (kTile, C + 1): each staged point's columns times its live flag,
  // then the flag, as the chains add them; its columns are staged at
  // kColsAt and read before vals is written over them
  constexpr int kColsAt = (kTile * sizeof(T) + 15) / 16 * 16;
  __shared__ __align__(16) unsigned char
      vals_buf[kColsAt + room(kTile * C * sizeof(T))];
  __shared__ __align__(16) unsigned char live_buf[room(kTile)];
  __shared__ __align__(16) unsigned char ids_buf[room((kTile + 1) * 8)];
  __shared__ int head_pos[kTile + 1];  // the r-th head's point in the tile
  __shared__ int group_heads[kGroups], group_owned[kGroups];
  __shared__ int2 gaps[kOwn + 1];  // empty ids [x, y] the block writes
  __shared__ int n_gaps;
  T* vals = reinterpret_cast<T*>(vals_buf);

  const size_t lane_off = blockIdx.y;
  cols += lane_off * n * C;
  live += lane_off * n;
  seg += lane_off * n;
  means += lane_off * n_out * C;
  mask += lane_off * n_out;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = lane % kLanes;  // the chain this lane adds
  const bool walker = lane / kLanes < kPerWarp;
  const int wid = (tid >> 5) * kPerWarp + lane / kLanes;
  const int count_lane = walker ? lane - c + C : lane;
  const int lo = blockIdx.x * kOwn;
  const int hi = min(lo + kOwn, n);  // lo = n = 0 when there is no point
  auto id_of = [n_out](long long s) {
    return static_cast<int>(s < n_out ? s : n_out);
  };
  // a walker lane's chain into segment id of the block's output
  auto put = [&](int id, T s) {
    const T cnt = __shfl_sync(0xffffffffu, s, count_lane);
    if (id < 0) return;
    if (c < C) {
      means[(size_t)id * C + c] = div_rn(s, cnt > T(1) ? cnt : T(1));
    } else {
      mask[id] = cnt > T(0);
    }
  };
  if (tid == 0) n_gaps = 0;

  int base = lo;
  int prev = -1;  // the id before the tile's first point
  int owned = 0;  // kept heads among the block's own points
  int carried_id = -1;
  T carried = T(0);  // the chains of the segment that runs on past a tile
  int round = 0;
  for (;; ++round) {
    // stage the tile: columns, live flags, ids (from the point before)
    const int valid = min(kTile, n - base);
    const int first = base > 0 ? base - 1 : 0;
    using bytes = const unsigned char*;
    const T* tc = reinterpret_cast<const T*>(
        stage(vals_buf + kColsAt,
              reinterpret_cast<bytes>(cols + (size_t)base * C),
              valid * C * static_cast<int>(sizeof(T))));
    const unsigned char* tl =
        stage(live_buf, reinterpret_cast<bytes>(live + base), valid);
    const long long* ts =
        reinterpret_cast<const long long*>(
            stage(ids_buf, reinterpret_cast<bytes>(seg + first),
                  (base + valid - first) * 8)) + (base - first);
    staged();
    if (round == 0 && base > 0) prev = id_of(ts[-1]);

    // heads: the ballot of each 32 points, then each head's rank; each
    // thread's points' values for vals, read before vals is written
    bool is_head[kPerThread];
    unsigned ballot[kPerThread];
    T x[kPerThread][C], w[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int p = i * kThreads + tid;
      const int id = p < valid ? id_of(ts[p]) : n_out;
      // the point before's id: the lane before's, or the tile's
      int before = __shfl_up_sync(0xffffffffu, id, 1);
      if (lane == 0) before = p > 0 ? id_of(ts[p - 1]) : prev;
      const bool h = p < valid && id != before;
      const bool own = round == 0 && h && base + p < hi && id < n_out;
      if (p < valid) {
        w[i] = tl[p] ? T(1) : T(0);
#pragma unroll
        for (int k = 0; k < C; ++k) x[i][k] = tc[p * C + k];
      }
      is_head[i] = h;
      ballot[i] = __ballot_sync(0xffffffffu, h);
      const unsigned bo = __ballot_sync(0xffffffffu, own);
      if (lane == 0) {
        group_heads[p >> 5] = __popc(ballot[i]);
        group_owned[p >> 5] = __popc(bo);
      }
    }
    __syncthreads();
    int heads = 0, count[kGroups];
    if (round == 0) owned = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      count[g] = group_heads[g];
      heads += count[g];
      if (round == 0) owned += group_owned[g];
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int p = i * kThreads + tid;
      if (p < valid) {
#pragma unroll
        for (int k = 0; k < C; ++k)
          vals[p * kLanes + k] = mul_rn(x[i][k], w[i]);
        vals[p * kLanes + C] = w[i];
      }
      if (is_head[i]) {
        int rank = __popc(ballot[i] & ((1u << lane) - 1u));
#pragma unroll
        for (int g = 0; g < kGroups; ++g) rank += g < (p >> 5) ? count[g] : 0;
        head_pos[rank] = p;
      }
    }
    if (tid == 0) head_pos[heads] = valid;
    __syncthreads();

    // the last owned segment runs on past the tile
    const bool carry = owned > 0 && heads == (round == 0 ? owned : 0) &&
                       base + valid < n;
    if (round == 0) {
      // the ids the block owns, [prev + 1, last]: its empty ones go to
      // the gap list before the walk, so that a warp whose walk is done
      // goes on to write them
      const int last = hi == n ? n_out - 1 : min(id_of(ts[hi - 1 - lo]),
                                                 n_out - 1);
      if (last - prev > owned) {
        for (int r = tid; r < owned; r += kThreads) {
          const int id = id_of(ts[head_pos[r]]);
          const int next = r + 1 < owned ? id_of(ts[head_pos[r + 1]])
                                         : last + 1;
          if (id + 1 < next) gaps[atomicAdd(&n_gaps, 1)] =
              make_int2(id + 1, next - 1);
        }
        if (tid == 0) {
          const int front = owned > 0 ? id_of(ts[head_pos[0]]) : last + 1;
          if (prev + 1 < front) gaps[atomicAdd(&n_gaps, 1)] =
              make_int2(prev + 1, front - 1);
        }
        __syncthreads();
      }
      for (int r0 = 0; r0 < owned; r0 += kWalkers) {
        const int r = r0 + wid;
        const bool on = walker && r < owned;
        const int b = on ? head_pos[r] : 0, e = on ? head_pos[r + 1] : 0;
        const T s = walk<T, C>(vals, b, e, c, T(0));
        const int id = on ? id_of(ts[b]) : -1;
        const bool keep = carry && r == owned - 1;  // its sums go on
        if (keep) {
          carried = s;
          carried_id = id;
        }
        put(keep ? -1 : id, s);
      }
      for (int g = 0; g < n_gaps; ++g) {
        const int2 gap = gaps[g];
        const size_t ids = gap.y - gap.x + 1;
        zero_bytes(
            reinterpret_cast<unsigned char*>(means + (size_t)gap.x * C),
            ids * C * sizeof(T));
        zero_bytes(reinterpret_cast<unsigned char*>(mask + gap.x), ids);
      }
      if (carry) prev = id_of(ts[head_pos[owned - 1]]);
    } else if (carried_id >= 0) {
      carried = walk<T, C>(vals, 0, head_pos[0], c, carried);
    }
    if (!carry) break;
    __syncthreads();  // the tile is read: restage over it
    base += valid;
  }
  put(carried_id, carried);
}

template <typename T, class S>
int launch_shape(const T* cols, const bool* live, const long long* seg, int n,
                 int c, int n_out, int streams, T* means, bool* mask,
                 cudaStream_t s) {
  const dim3 grid(n > 0 ? (n + S::kOwn - 1) / S::kOwn : 1, streams);
  if (c == 3)
    segment_mean_kernel<T, 3, S><<<grid, S::kThreads, 0, s>>>(
        cols, live, seg, n, n_out, means, mask);
  else if (c == 4)
    segment_mean_kernel<T, 4, S><<<grid, S::kThreads, 0, s>>>(
        cols, live, seg, n, n_out, means, mask);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
int launch(const T* cols, const bool* live, const long long* seg, int n,
           int c, int n_out, int streams, T* means, bool* mask,
           void* stream) {
  if (n < 0 || n_out <= 0 || streams <= 0 || streams > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return streams > 1 ? launch_shape<T, Wide>(cols, live, seg, n, c, n_out,
                                             streams, means, mask, s)
                     : launch_shape<T, Narrow>(cols, live, seg, n, c, n_out,
                                               streams, means, mask, s);
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
