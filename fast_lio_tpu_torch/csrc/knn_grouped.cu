// Region-grouped 5-nearest-neighbour search over the planar-row voxel-hash
// map, for Hopper (sm_90a): a prep kernel that groups the queries and a
// persistent search kernel.  Built by fast_lio_tpu_torch/kernels/build.py
// with nvcc into a shared library with a plain C interface, launched through
// ctypes by fast_lio_tpu_torch/kernels/knn_grouped.py.
//
// Replaces the TPU kernel tools/knn_grouped.py::_kernel (knn_search_grouped,
// pallas_call at tools/knn_grouped.py:217, with the XLA prep of its wrapper,
// :176-199) and computes what it computes: the queries, sorted by a
// static-origin region key with 10 bits per axis and cut into groups of at
// most 8 with equal key, search the R = 8 (round-to-corner 2x2x2) or R = 27
// (centered 3x3x3) cells of the group HEAD's region, hashed to buckets,
// duplicates skipped; each query keeps its own half-open AABB, and the 5
// smallest (d2, bucket * B + slot) win, ties to the lowest index.  For a
// query whose key is not clamped the head's region is its own, so the result
// equals hash_map.knn_search and csrc/knn.cu bit for bit; a clamped key (a
// coordinate beyond 512 storage cells) keeps the TPU kernel's semantics: the
// head's rows, the query's own AABB.
//
// knn_grouped_prep_kernel (one block; its outputs equal group_queries'
// bit for bit): each thread takes PREP_ITEMS queries, computes their region
// keys (hm.region_base + region_key arithmetic), renumbers each key axis
// within the block's range (a mixed-radix key of the same order, which a
// scan's extent fits in fewer than 30 bits), and the block sorts the
// (key, index) pairs stably in shared memory over those bits only
// (cub::BlockRadixSort, the LSD radix sort of one block), flags the group
// heads (a key change, or every
// 8th query of a run: a block max-scan finds each run's start) and numbers
// them by a block sum-scan; it writes order, the first n_groups entries of
// starts, and the group count, to device memory: what the search reads.
// One block sorts at most PREP_MAX_QUERIES = 8192 queries (the main path's
// largest search); the wrapper refuses larger sets.
//
// knn_grouped_search_kernel (persistent): a few blocks per SM, as many as
// fit (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each walking groups
// g = blockIdx.x, g + gridDim.x, ... < n_groups, read on the device (no
// host read).  Nine warps: warp 8 produces, warps 0-7 score one group
// member each.  The producer reads a group's start, members and queries,
// hashes the head's R cells, dedups their buckets, and stages each distinct
// row with one 1-D bulk copy (TMA, cp.async.bulk, 16B bytes, completing on
// the stage's mbarrier) into a ring of `stages` buffers of R rows, staying
// stages - 1 groups ahead of the scorers, so group g + gridDim.x loads
// while group g is scored.  A barrier at the end of each group frees its
// stage.  Each scoring warp keeps a per-lane top-5 of (d2, idx), picks the
// winners by five warp argmin rounds, reads their coordinates from the
// staged rows, and writes at its query's original index (the un-sort is
// this scatter).  The ring takes 8 KB a stage at R = 8, B = 64 and 54 KB at
// R = 27, B = 128 (stages chosen by the wrapper from a shared-memory
// budget, so that two blocks share an SM).
//
// Bound on this card (H100 SXM, 3.35 TB/s): each distinct row once, plus
// queries and outputs (kernels/bounds.py); the kernel reads n_groups * R
// rows, once per group.  Bitwise agreement: see knn_common.cuh.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "knn_common.cuh"

namespace {

using namespace knn_common;

constexpr int G = 8;             // queries per group = scoring warps
constexpr int SEARCH_WARPS = G + 1;
constexpr int MAX_STAGES = 4;
constexpr int KEY_BITS = 10;     // per-axis region-key bits
constexpr int KEY_HALF = 1 << (KEY_BITS - 1);
constexpr int PREP_ITEMS = 8;    // queries per prep thread
constexpr uint32_t PAD_KEY = 0xffffffffu;  // above every 30-bit key

// ---------------------------------------------------------------------------
// prep
// ---------------------------------------------------------------------------

// One axis of the region key: the base cell offset by 2^9, clamped to 10
// bits (region_key: clamp(base + 512, 0, 1023)).
__device__ __forceinline__ uint32_t key_axis(float q, float cell,
                                             float shift) {
  const int b = region_base(q, cell, shift);
  return (uint32_t)(min(max(b, -KEY_HALF), KEY_HALF - 1) + KEY_HALF);
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
knn_grouped_prep_kernel(const float* __restrict__ queries, int n, float cell,
                        float shift, int* __restrict__ order,
                        int* __restrict__ starts,
                        int* __restrict__ n_groups) {
  constexpr int CAP = THREADS * PREP_ITEMS;
  using Sort = cub::BlockRadixSort<uint32_t, THREADS, PREP_ITEMS, int>;
  using Scan = cub::BlockScan<int, THREADS>;
  union Shared {
    typename Sort::TempStorage sort;
    uint32_t keys[CAP];
  };
  __shared__ Shared sm;
  __shared__ typename Scan::TempStorage scan;

  __shared__ uint32_t lo[3], hi[3];  // the block's range of each key axis
  if (threadIdx.x < 3) {
    lo[threadIdx.x] = (1u << KEY_BITS) - 1;
    hi[threadIdx.x] = 0;
  }
  __syncthreads();

  const int p0 = threadIdx.x * PREP_ITEMS;  // blocked arrangement
  uint32_t key[PREP_ITEMS];
  int idx[PREP_ITEMS];
  uint32_t mn[3] = {(1u << KEY_BITS) - 1, (1u << KEY_BITS) - 1,
                    (1u << KEY_BITS) - 1};
  uint32_t mx[3] = {0, 0, 0};
#pragma unroll
  for (int i = 0; i < PREP_ITEMS; ++i) {
    const int p = p0 + i;
    idx[i] = p;
    key[i] = PAD_KEY;  // pads sort after every query
    if (p < n) {
      const float* q = queries + 3 * (size_t)p;
      uint32_t f[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        f[c] = key_axis(q[c], cell, shift);
        mn[c] = min(mn[c], f[c]);
        mx[c] = max(mx[c], f[c]);
      }
      key[i] = (f[0] << (2 * KEY_BITS)) | (f[1] << KEY_BITS) | f[2];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t wmn = __reduce_min_sync(FULL, mn[c]);
    const uint32_t wmx = __reduce_max_sync(FULL, mx[c]);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&lo[c], wmn);
      atomicMax(&hi[c], wmx);
    }
  }
  __syncthreads();
  // The same order from fewer radix passes: the key's three 10-bit fields
  // renumbered within the block's range, mixed radix, x slowest (the
  // order, and which keys are equal, are the fused key's).
  const uint32_t ny = hi[1] - lo[1] + 1, nz = hi[2] - lo[2] + 1;
  const uint32_t span = (hi[0] - lo[0] + 1) * ny * nz;  // <= 2^30
  const int bits = max(1, 32 - __clz((int)(span - 1)));
#pragma unroll
  for (int i = 0; i < PREP_ITEMS; ++i) {
    if (p0 + i < n) {
      const uint32_t fx = key[i] >> (2 * KEY_BITS);
      const uint32_t fy = (key[i] >> KEY_BITS) & ((1u << KEY_BITS) - 1);
      const uint32_t fz = key[i] & ((1u << KEY_BITS) - 1);
      key[i] = ((fx - lo[0]) * ny + (fy - lo[1])) * nz + (fz - lo[2]);
    }
  }
  // stable: equal keys keep index order; pads (all ones) sort last
  Sort(sm.sort).Sort(key, idx, 0, bits);
  __syncthreads();               // the sort's storage becomes the keys
#pragma unroll
  for (int i = 0; i < PREP_ITEMS; ++i) sm.keys[p0 + i] = key[i];
  __syncthreads();

  // heads of runs of equal key, and each position's run start
  int run_start[PREP_ITEMS];
  unsigned head = 0;
#pragma unroll
  for (int i = 0; i < PREP_ITEMS; ++i) {
    const int p = p0 + i;
    const bool h = p < n && (p == 0 || sm.keys[p - 1] != key[i]);
    head |= (unsigned)h << i;
    run_start[i] = h ? p : 0;
  }
  Scan(scan).InclusiveScan(run_start, run_start, MaxOp());
  __syncthreads();  // the scan's storage is used again

  // group heads: a run's head, and every G-th query of a run
  int gnew[PREP_ITEMS];
#pragma unroll
  for (int i = 0; i < PREP_ITEMS; ++i) {
    const int p = p0 + i;
    gnew[i] = p < n && (((head >> i) & 1u) || (p - run_start[i]) % G == 0);
  }
  int g[PREP_ITEMS];
  int total;
  Scan(scan).ExclusiveSum(gnew, g, total);
#pragma unroll
  for (int i = 0; i < PREP_ITEMS; ++i) {
    const int p = p0 + i;
    if (p < n) {
      order[p] = idx[i];
      if (gnew[i]) starts[g[i]] = p;  // group g[i]'s head
    }
  }
  if (threadIdx.x == 0) *n_groups = total;
}

// ---------------------------------------------------------------------------
// search
// ---------------------------------------------------------------------------

template <int R>
struct Stage {
  int members;
  int n_rows;
  int qi[G];
  float q[G][3];
  uint32_t bucket[R];  // the group's distinct rows, in staged order
};

// Winner coordinates from the group's staged rows.
template <int R>
struct StagedCoords {
  const float* rows;
  const Stage<R>* st;
  int B;
  __device__ __forceinline__ void operator()(int idx, float& x, float& y,
                                             float& z) const {
    const uint32_t b = (uint32_t)idx / (uint32_t)B;
    const int s = idx - (int)(b * (uint32_t)B);
    int r = 0;  // the winner's row is one of the staged rows
    while (r + 1 < st->n_rows && st->bucket[r] != b) ++r;
    const float* row = rows + (size_t)r * 4 * B;
    x = row[s];
    y = row[B + s];
    z = row[2 * B + s];
  }
};

// The producer warp: group g's members, queries and the head's distinct
// rows into one stage (rows, md, bar), the rows by bulk copies.
template <int R>
__device__ __forceinline__ void produce(
    int g, const float* packed, const float* queries, const int* order,
    const int* starts, int n_groups, int n, int B, uint32_t bucket_mask,
    float cell, float shift, float* rows, Stage<R>* md, uint64_t* bar,
    int lane) {
  const int row_floats = 4 * B;
  const uint32_t row_bytes = 16u * (uint32_t)B;
  const int st = starts[g];
  const int e = (g + 1 < n_groups) ? starts[g + 1] : n;
  const int members = min(G, e - st);
  int qi = 0;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (lane < members) {
    qi = order[st + lane];
    qx = queries[3 * (size_t)qi + 0];
    qy = queries[3 * (size_t)qi + 1];
    qz = queries[3 * (size_t)qi + 2];
  }
  // the head's region
  const int bx = region_base(__shfl_sync(FULL, qx, 0), cell, shift);
  const int by = region_base(__shfl_sync(FULL, qy, 0), cell, shift);
  const int bz = region_base(__shfl_sync(FULL, qz, 0), cell, shift);
  const uint32_t bucket =
      (lane < R) ? region_bucket<R>(bx, by, bz, lane, bucket_mask) : 0u;
  const bool live = first_of_bucket<R>(bucket, lane, 0);
  const unsigned live_mask = __ballot_sync(FULL, live);
  const int pos = __popc(live_mask & ((1u << lane) - 1u));
  if (lane < G) {
    md->qi[lane] = qi;
    md->q[lane][0] = qx;
    md->q[lane][1] = qy;
    md->q[lane][2] = qz;
  }
  if (live) md->bucket[pos] = bucket;
  if (lane == 0) {
    md->members = members;
    md->n_rows = __popc(live_mask);
    mbar_arrive_expect_tx(bar, (uint32_t)__popc(live_mask) * row_bytes);
  }
  __syncwarp();
  if (live) {
    fence_proxy_async();
    bulk_copy_to_shared(rows + (size_t)pos * row_floats,
                        packed + (size_t)bucket * row_floats, row_bytes, bar);
  }
}

template <int R>
__global__ void __launch_bounds__(32 * SEARCH_WARPS)
knn_grouped_search_kernel(const float* __restrict__ packed,
                          const float* __restrict__ queries,
                          const int* __restrict__ order,
                          const int* __restrict__ starts,
                          const int* __restrict__ n_groups_ptr, int n, int B,
                          uint32_t bucket_mask, float cell, float span,
                          int stages, float* __restrict__ nbrs,
                          float* __restrict__ sq,
                          uint8_t* __restrict__ found) {
  extern __shared__ __align__(128) float ring[];  // stages * R rows
  __shared__ Stage<R> meta[MAX_STAGES];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_groups = *n_groups_ptr;
  const float shift = (R == 8) ? 0.5f : 1.0f;
  const int row_floats = 4 * B;
  const size_t stage_floats = (size_t)R * row_floats;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == G) {
    for (int j = 0; j + 1 < stages; ++j) {
      const int g = blockIdx.x + j * gridDim.x;
      if (g < n_groups)
        produce<R>(g, packed, queries, order, starts, n_groups, n, B,
                   bucket_mask, cell, shift, ring + j * stage_floats,
                   &meta[j], &full[j], lane);
    }
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    const int g = blockIdx.x + it * gridDim.x;
    if (g >= n_groups) break;  // uniform across the block
    const int s = it % stages;
    if (warp == G) {
      // the stage of iteration it - 1, freed by the barrier that ended it
      const int ahead = g + (stages - 1) * gridDim.x;
      const int sa = (it + stages - 1) % stages;
      if (ahead < n_groups)
        produce<R>(ahead, packed, queries, order, starts, n_groups, n, B,
                   bucket_mask, cell, shift, ring + sa * stage_floats,
                   &meta[sa], &full[sa], lane);
    } else {
      mbar_wait(&full[s], (uint32_t)(it / stages) & 1u);
      const Stage<R>& md = meta[s];
      const float* rows = ring + s * stage_floats;
      if (warp < md.members) {  // uniform across the warp
        const Query q(md.q[warp][0], md.q[warp][1], md.q[warp][2], cell,
                      shift, span);
        TopK top;
        top.init();
        for (int r = 0; r < md.n_rows; ++r)
          score_row(rows + (size_t)r * row_floats, md.bucket[r], B, lane, q,
                    top);
        write_top5<32>(top, lane, FULL, (size_t)md.qi[warp],
                       StagedCoords<R>{rows, &md, B}, nbrs, sq, found);
      }
    }
    __syncthreads();
  }
}

template <int R>
int configure_search(int B, int stages, int* blocks) {
  int bytes = 0, per_sm = 0, device = 0, sms = 0;
  int err = max_dynamic_smem(knn_grouped_search_kernel<R>, &bytes);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      knn_grouped_search_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, knn_grouped_search_kernel<R>, 32 * SEARCH_WARPS,
        (size_t)stages * R * 16 * B);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = per_sm * sms;
  return (int)e;
}

}  // namespace

extern "C" {

// Sets the search kernel's dynamic shared-memory limit on the current device
// and writes the persistent grid for (wide, B, stages): as many blocks as
// fit on all SMs at once.  Call once per (device, wide, B, stages).
int knn_grouped_configure(int wide, int bucket_slots, int stages,
                          int* blocks) {
  if (stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  return wide ? configure_search<27>(bucket_slots, stages, blocks)
              : configure_search<8>(bucket_slots, stages, blocks);
}

// Groups the queries on `stream` and returns the launch's CUDA error.
// queries (n, 3) f32, n <= 8192; outputs order (n), starts (n: the first
// n_groups written, the rest left as they were) and n_groups (1), int32, as
// group_queries gives them.
int knn_grouped_prep(const float* queries, int n, float cell, int wide,
                     int* order, int* starts, int* n_groups, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float shift = wide ? 1.0f : 0.5f;
  if (n <= 256 * PREP_ITEMS) {
    knn_grouped_prep_kernel<256><<<1, 256, 0, s>>>(
        queries, n, cell, shift, order, starts, n_groups);
  } else if (n <= 1024 * PREP_ITEMS) {
    knn_grouped_prep_kernel<1024><<<1, 1024, 0, s>>>(
        queries, n, cell, shift, order, starts, n_groups);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches the grouped search on `stream` and returns the CUDA error of the
// launch (0 = ok).  packed (H, 4B) f32 (16-byte aligned), queries (n, 3)
// f32, order (n) int32 (queries sorted by region key), starts (n) int32
// (group starts in sorted order, the first n_groups used), n_groups (1)
// int32 on the device; outputs nbrs (n, 5, 3) f32, sq (n, 5) f32, found
// (n, 5) uint8, in the queries' original order; all contiguous on the
// current device.  grid blocks (from knn_grouped_configure, at most n),
// stages (2-4) buffers of R rows of 4B floats each.
int knn_grouped_f32(const float* packed, const float* queries,
                    const int* order, const int* starts, const int* n_groups,
                    int n, int bucket_slots, unsigned int bucket_mask,
                    float cell, float span, int wide, int stages, int grid,
                    float* nbrs, float* sq, unsigned char* found,
                    void* stream) {
  if (n <= 0) return 0;
  if (stages < 2 || stages > MAX_STAGES || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = wide ? 27 : 8;
  const size_t smem = (size_t)stages * R * 16 * bucket_slots;
  if (wide) {
    knn_grouped_search_kernel<27><<<grid, 32 * SEARCH_WARPS, smem, s>>>(
        packed, queries, order, starts, n_groups, n, bucket_slots,
        bucket_mask, cell, span, stages, nbrs, sq, found);
  } else {
    knn_grouped_search_kernel<8><<<grid, 32 * SEARCH_WARPS, smem, s>>>(
        packed, queries, order, starts, n_groups, n, bucket_slots,
        bucket_mask, cell, span, stages, nbrs, sq, found);
  }
  return (int)cudaGetLastError();
}

const char* knn_grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
