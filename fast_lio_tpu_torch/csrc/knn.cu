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
// slot; the global key bucket * B + slot has the same order, so neither the
// order of the rows nor of the chunks below changes the result.
//
// The kernel is a template on the scalar type T: float (compute_dtype
// float32) and double (float64, what the JAX main path's XLA search computes
// in that dtype; the TPU kernel only ever searched in f32).  In double a row
// is 4B doubles (32 bytes a slot), so kernels/knn.py's ring_rows(B) halves
// the rows a stage holds where two stages would pass 128 KiB; the candidate
// key is the pair (d2 bits, index) (knn_common.cuh).  Everything else is
// the same code.
//
// Design: one block of 8 warps per tile of consecutive queries, L lanes per
// query: a half warp (L = 16, a tile of 16) at R = 8, a warp (L = 32, a
// tile of 8) at R = 27, where a query's 27 cells need a lane each.  On the
// main path consecutive queries are neighbours (the voxel downsample emits
// its centroids in voxel order), so a tile's region cells fall in a few
// distinct buckets.  The block
//   1. hashes the tile's cells and dedups their buckets in a shared-memory
//      hash table (atomicCAS, linear probing), then numbers the distinct
//      rows (the tile's union) by a block scan;
//   2. stages the union's rows into a two-stage ring in shared memory with
//      1-D bulk copies (TMA: one cp.async.bulk per row, 4B scalars, its w and
//      x/y/z together, completing on an mbarrier), in chunks of at most
//      ring_rows rows; chunk k + 1 is in flight while chunk k is scored;
//   3. lists each staged row's live slots once (a ballot per 32 slots), and
//      each lane group scores its query against the live slots of the
//      staged rows of its own region only (lane r of the group holds the
//      union index of region cell r's row; a ballot picks those in the
//      chunk), keeping a per-lane top-5 of (d2, idx) in registers; five
//      argmin rounds over the group pick the winners, whose coordinates
//      lanes 0-4 of the group read from the ring (a union of at most two
//      chunks is still staged) or else from the map.
// A block's work is a chain of dependent steps (queries, hash, rows,
// scoring, argmin), so its time is that chain's latency times the number of
// waves of blocks: half-warp groups at R = 8 put the avia preset's 8192
// queries in one wave.  Shuffled queries (about one query per region) give
// a union of up to a tile's R rows per query, staged chunk by chunk: the
// same bytes the first one-warp-per-query design read, now in flight a
// chunk at a time.
//
// Bound on this card (H100 SXM, 3.35 TB/s): each distinct row once, plus
// queries (12 N) and outputs (85 N), twice the scalars' bytes in double --
// under a microsecond on the sim map (kernels/bounds.py).
//
// Stream axis: one launch searches S independent maps (the lanes of the
// batched step, batch.BatchPipeline), each with its own queries.  blockIdx.y
// is the stream: its map starts map_stride scalars after the previous one
// (the stacked maps' (H + 1) * 4B rows, dump row included; the kernel
// addresses only the first H), and its queries and outputs n * 3, n * 15,
// n * 5 and n * 5 after.  Each block works as above on its own stream's
// tile; with S = 1 the launch is the single search's, bit for bit.
//
// The candidates variant (knn_tile_cand_kernel, R = 8 only): the same
// search, which also writes the candidate block that the plain version
// returns with return_candidates (hash_map.search_rows), for the
// rescore re-search (Config.rescore_research) to re-rank: cand_pts
// (n, R * B, 3), every slot's raw x, y, z, and cand_ok (n, R * B) uint8,
// whether the slot is live (w == 0) inside the region's AABB in a row that
// is not a duplicate.  Row r of a query's block is the r-th of its R
// buckets in sorted order; a bucket held by several region cells keeps its
// first sorted position, and the positions after it are the sentinel
// bucket H - 1's row with every slot dead.  Each lane of a group holds its
// region cell's sorted position (a stable rank, by shuffles within the
// group); the group writes each of its query's rows as its chunk is
// staged, from the ring, and the sentinel rows from the map after the last
// chunk.  The block is copied, not computed: bit for bit the plain
// version's, dead slots included.  Its bytes, n * R * B * (3 sizeof(T) +
// 1), dominate the launch: this variant is write-bound.
//
// Bitwise agreement with the plain version: see knn_common.cuh, which holds
// the hash, the top-5 and the row scoring this kernel shares with
// knn_grouped.cu.

#include "knn_common.cuh"

namespace {

using namespace knn_common;

constexpr int WARPS = 8;
constexpr int TABLE = 512;             // hash slots, >= 2 * (tile cells)
constexpr int TABLE_LOG2 = 9;
constexpr int RING_ROWS_MAX = 32;      // rows per stage: one copy per lane
constexpr uint32_t EMPTY = 0xffffffffu;  // never a bucket (mask < 2^31)
constexpr uint16_t NO_ROW = 0xffff;

// lanes per query, and queries per tile, by region size
template <int R>
struct Tile {
  static constexpr int L = (R <= 16) ? 16 : 32;
  static constexpr int Q = WARPS * (32 / L);
  static_assert(2 * Q * R <= TABLE, "the hash table is too small");
};

__device__ __forceinline__ uint32_t table_home(uint32_t bucket) {
  return (bucket * 0x9E3779B1u) >> (32 - TABLE_LOG2);
}

// Exclusive prefix sum over the block's 32 * WARPS threads; `tmp` holds
// WARPS ints.  Every thread calls it; *total is the block's sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* tmp,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += (w < warp) ? tmp[w] : 0;
    all += tmp[w];
  }
  *total = all;
  return before + inc - v;
}

// Winner coordinates: from the ring where the whole union is still staged
// (at most two chunks: union row u sits at ring row u), else from the map
// rows in device memory.
template <class T>
struct TileCoords {
  const T* packed;
  const T* ring;
  const uint32_t* table;
  const uint16_t* row_of_slot;
  int B;
  bool staged;
  __device__ __forceinline__ void operator()(int idx, T& x, T& y,
                                             T& z) const {
    const uint32_t b = (uint32_t)idx / (uint32_t)B;
    const int s = idx - (int)(b * (uint32_t)B);
    const T* row;
    if (staged) {
      uint32_t h = table_home(b);
      while (table[h] != b) h = (h + 1) & (TABLE - 1);
      row = ring + (size_t)row_of_slot[h] * 4 * B;
    } else {
      row = packed + (size_t)b * 4 * B;
    }
    x = row[s];
    y = row[B + s];
    z = row[2 * B + s];
  }
};

// Warp 0: the union's rows of chunk k into stage k & 1 of the ring, one
// bulk copy per row (lane), all completing on the stage's barrier.
template <class T>
__device__ __forceinline__ void stage_chunk(
    int k, const T* packed, const uint32_t* union_bucket, int n_union,
    int B, int ring_rows, T* ring, uint64_t* full, int lane) {
  const int st = k & 1;
  const int r0 = k * ring_rows;
  const int cnt = min(ring_rows, n_union - r0);
  const int row_elems = 4 * B;
  const uint32_t row_bytes = 4u * (uint32_t)sizeof(T) * (uint32_t)B;
  if (lane == 0) mbar_arrive_expect_tx(&full[st], (uint32_t)cnt * row_bytes);
  __syncwarp();
  if (lane < cnt) {
    fence_proxy_async();
    bulk_copy_to_shared(ring + (size_t)(st * ring_rows + lane) * row_elems,
                        packed + (size_t)union_bucket[r0 + lane] * row_elems,
                        row_bytes, &full[st]);
  }
}

// Sorted position of the bucket of lane sub among the R buckets of the
// group of lanes from `base`: the buckets below it, and the equal ones on
// lower lanes (a stable rank).  All 32 lanes call.
template <int R>
__device__ __forceinline__ int sorted_rank(uint32_t bucket, int sub,
                                           int base) {
  int rank = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t bj = __shfl_sync(FULL, bucket, base + j);
    rank += (bj < bucket || (bj == bucket && j < sub)) ? 1 : 0;
  }
  return rank;
}

// One row of a query's candidate block, by the L lanes of its group (lane
// sub): the row's x, y, z interleaved as (B, 3) into pts, and each slot's
// flag into ok: live (w == 0) inside the region's AABB, or none for a
// duplicate's sentinel row (`dead`).
template <class T, int L>
__device__ __forceinline__ void write_cand_row(const T* row, int B,
                                               const QueryT<T>& q, bool dead,
                                               T* pts, uint8_t* ok, int sub) {
  for (int i = sub; i < 3 * B; i += L) {
    const int s = i / 3;
    pts[i] = row[(i - 3 * s) * B + s];
  }
  for (int s = sub; s < B; s += L) {
    const T x = row[s], y = row[B + s], z = row[2 * B + s];
    const bool oob = x < q.lox || x >= q.hix || y < q.loy || y >= q.hiy ||
                     z < q.loz || z >= q.hiz;
    ok[s] = (!dead && !oob && row[3 * B + s] == T(0)) ? 1 : 0;
  }
}

// The search of one tile of queries (a block); with CAND it also writes
// the candidate block (see the header).
template <class T, int R, bool CAND>
__device__ __forceinline__ void tile_search(
    const T* __restrict__ packed, long long map_stride,
    const T* __restrict__ queries, int n, int B, uint32_t bucket_mask,
    T cell, float span, int ring_rows, T* __restrict__ nbrs,
    T* __restrict__ sq, uint8_t* __restrict__ found,
    T* __restrict__ cand_pts, uint8_t* __restrict__ cand_ok) {
  constexpr int L = Tile<R>::L, TQ = Tile<R>::Q;
  // this block's stream: its map, queries and outputs
  const size_t stream = blockIdx.y;
  packed += stream * (size_t)map_stride;
  queries += stream * 3 * (size_t)n;
  nbrs += stream * K * 3 * (size_t)n;
  sq += stream * K * (size_t)n;
  found += stream * K * (size_t)n;
  if (CAND) {
    cand_pts += stream * (size_t)n * R * B * 3;
    cand_ok += stream * (size_t)n * R * B;
  }
  // 2 * ring_rows rows, then the live slots of the chunk being scored
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ int qbase[TQ][3];
  __shared__ uint32_t table[TABLE];
  __shared__ uint16_t row_of_slot[TABLE];
  __shared__ uint16_t slot_of_cell[TQ * R];
  __shared__ uint32_t union_bucket[TQ * R];
  __shared__ int scan_tmp[WARPS];
  __shared__ int live_count[RING_ROWS_MAX];
  __shared__ __align__(8) uint64_t full[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & (L - 1);           // lane within the query's group
  const int base = lane - sub;              // the group's first lane
  const unsigned group = (L == 32) ? FULL : (0xffffu << base);
  const int tq = warp * (32 / L) + base / L;  // the group's query in the tile
  const int qi = blockIdx.x * TQ + tq;
  const int nq = min(TQ, n - (int)blockIdx.x * TQ);
  const bool active = tq < nq;
  const T shift = (R == 8) ? T(0.5) : T(1.0);
  const int row_elems = 4 * B;
  uint16_t* live_slot = reinterpret_cast<uint16_t*>(
      ring + (size_t)2 * ring_rows * row_elems);  // ring_rows lists of B

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbar_init();
  }
  for (int i = tid; i < TABLE; i += blockDim.x) table[i] = EMPTY;
  T qc = T(0);  // lane sub = c < 3 of the group holds coordinate c
  if (active && sub < 3) {
    qc = queries[3 * (size_t)qi + sub];
    qbase[tq][sub] = region_base(qc, cell, shift);
  }
  const QueryT<T> q(__shfl_sync(FULL, qc, base),
                    __shfl_sync(FULL, qc, base + 1),
                    __shfl_sync(FULL, qc, base + 2), cell, shift, span);
  __syncthreads();

  // 1. the tile's distinct buckets
  for (int t = tid; t < nq * R; t += blockDim.x) {
    const int qq = t / R;
    const uint32_t b = region_bucket<R>(qbase[qq][0], qbase[qq][1],
                                        qbase[qq][2], t - qq * R,
                                        bucket_mask);
    uint32_t h = table_home(b);
    while (true) {
      const uint32_t prev = atomicCAS(&table[h], EMPTY, b);
      if (prev == EMPTY || prev == b) break;
      h = (h + 1) & (TABLE - 1);
    }
    slot_of_cell[t] = (uint16_t)h;
  }
  __syncthreads();
  constexpr int PER_THREAD = TABLE / (32 * WARPS);
  int here = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    here += table[tid * PER_THREAD + i] != EMPTY;
  int n_union;
  int next = block_exclusive_sum(here, scan_tmp, &n_union);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int h = tid * PER_THREAD + i;
    if (table[h] != EMPTY) {
      row_of_slot[h] = (uint16_t)next;
      union_bucket[next] = table[h];
      ++next;
    }
  }
  __syncthreads();

  // the query's distinct rows: lane sub = r < R of its group holds the
  // union index of region cell r, or NO_ROW for a bucket a lower cell holds
  const bool has_cell = active && sub < R;
  const uint32_t h = has_cell ? slot_of_cell[tq * R + sub] : 0;
  const uint32_t b = has_cell ? table[h] : EMPTY;
  const bool first = first_of_bucket<R>(b, sub, base);
  const uint32_t my_row = (has_cell && first) ? row_of_slot[h] : NO_ROW;
  // the region cell's row in the query's candidate block
  const int my_rank = CAND ? sorted_rank<R>(b, sub, base) : 0;
  const size_t block_row = (size_t)qi * R;

  // 2-3. stage the union chunk by chunk and score
  TopKT<T> top;
  top.init();
  const int n_chunks = (n_union + ring_rows - 1) / ring_rows;
  if (warp == 0)
    stage_chunk(0, packed, union_bucket, n_union, B, ring_rows, ring, full,
                lane);
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k & 1;
    // stage st ^ 1 held chunk k - 1, which every warp finished before the
    // barrier that ended the last iteration
    if (warp == 0 && k + 1 < n_chunks)
      stage_chunk(k + 1, packed, union_bucket, n_union, B, ring_rows, ring,
                  full, lane);
    mbar_wait(&full[st], (uint32_t)(k >> 1) & 1u);
    const uint32_t r0 = (uint32_t)(k * ring_rows);
    const int cnt = min(ring_rows, n_union - (int)r0);
    const T* stage = ring + (size_t)st * ring_rows * row_elems;
    // the chunk's live slots, listed once for every query of the tile (a
    // warp per row), so that the lanes score live slots only
    for (int j = warp; j < cnt; j += WARPS) {
      const T* w = stage + (size_t)j * row_elems + 3 * B;
      int count = 0;
      for (int s0 = 0; s0 < B; s0 += 32) {
        const int s = s0 + lane;
        const bool live = s < B && w[s] < W_VALID_MAX<T>;
        const unsigned m = __ballot_sync(FULL, live);
        if (live)
          live_slot[j * B + count + __popc(m & ((1u << lane) - 1u))] =
              (uint16_t)s;
        count += __popc(m);
      }
      if (lane == 0) live_count[j] = count;
    }
    __syncthreads();
    // the group's rows in this chunk (none for a group past the last query)
    uint32_t todo =
        __ballot_sync(FULL, my_row - r0 < (uint32_t)ring_rows) & group;
    while (todo) {
      const int r = __ffs(todo) - 1;
      todo &= todo - 1;
      const uint32_t u = __shfl_sync(group, my_row, r);
      const int j = (int)(u - r0);
      const T* row = stage + (size_t)j * row_elems;
      for (int i = sub; i < live_count[j]; i += L)
        score_slot(row, live_slot[j * B + i], union_bucket[u], B, q, top);
      if (CAND) {
        const size_t at = (block_row + __shfl_sync(group, my_rank, r)) * B;
        write_cand_row<T, L>(row, B, q, false, cand_pts + 3 * at,
                             cand_ok + at, sub);
      }
    }
    __syncthreads();
  }
  if (CAND) {
    // a duplicate's position: the sentinel bucket's row, every slot dead
    uint32_t dups = __ballot_sync(FULL, has_cell && !first) & group;
    const T* sentinel = packed + (size_t)bucket_mask * row_elems;
    while (dups) {
      const int r = __ffs(dups) - 1;
      dups &= dups - 1;
      const size_t at = (block_row + __shfl_sync(group, my_rank, r)) * B;
      write_cand_row<T, L>(sentinel, B, q, true, cand_pts + 3 * at,
                           cand_ok + at, sub);
    }
  }

  if (active)
    write_top5<L>(top, sub, group, (size_t)qi,
                  TileCoords<T>{packed, ring, table, row_of_slot, B,
                                n_chunks <= 2},
                  nbrs, sq, found);
}

template <class T, int R>
__global__ void __launch_bounds__(32 * WARPS)
knn_tile_kernel(const T* __restrict__ packed, long long map_stride,
                const T* __restrict__ queries, int n, int B,
                uint32_t bucket_mask, T cell, float span, int ring_rows,
                T* __restrict__ nbrs, T* __restrict__ sq,
                uint8_t* __restrict__ found) {
  tile_search<T, R, false>(packed, map_stride, queries, n, B, bucket_mask,
                           cell, span, ring_rows, nbrs, sq, found, nullptr,
                           nullptr);
}

// The search that also writes the candidate block, at R = 8 (the rescore
// re-ranks the 2x2x2 block only).
template <class T, int R>
__global__ void __launch_bounds__(32 * WARPS)
knn_tile_cand_kernel(const T* __restrict__ packed, long long map_stride,
                     const T* __restrict__ queries, int n, int B,
                     uint32_t bucket_mask, T cell, float span, int ring_rows,
                     T* __restrict__ nbrs, T* __restrict__ sq,
                     uint8_t* __restrict__ found, T* __restrict__ cand_pts,
                     uint8_t* __restrict__ cand_ok) {
  static_assert(R == 8, "the candidate block is the 2x2x2 region's");
  tile_search<T, R, true>(packed, map_stride, queries, n, B, bucket_mask,
                          cell, span, ring_rows, nbrs, sq, found, cand_pts,
                          cand_ok);
}

template <class Kernel>
int configure(Kernel kernel) {
  int bytes = 0;
  int err = max_dynamic_smem(kernel, &bytes);
  if (err) return err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The search at R = 8 or, with `wide`, R = 27, over `streams` maps and
// query sets (grid.y); the block takes 2 * ring_rows * 4B * sizeof(T)
// bytes of dynamic shared memory for the ring, and ring_rows * B * 2 for
// the live lists.
// With cand_pts and cand_ok (R = 8 only: `wide` must be 0) the
// candidates variant, which also writes the block.
template <class T>
int launch(const T* packed, long long map_stride, int streams,
           const T* queries, int n, int bucket_slots,
           unsigned int bucket_mask, T cell, float span, int wide,
           int ring_rows, T* nbrs, T* sq, unsigned char* found,
           T* cand_pts, unsigned char* cand_ok, void* stream) {
  if (n <= 0 || streams <= 0) return 0;
  const bool cand = cand_pts != nullptr;
  if (ring_rows < 1 || ring_rows > RING_ROWS_MAX || streams > 65535 ||
      map_stride < 0 || (cand && (wide || cand_ok == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * WARPS);
  const size_t smem =
      (size_t)2 * ring_rows * 4 * sizeof(T) * bucket_slots  // the ring
      + (size_t)ring_rows * bucket_slots * 2;               // live lists
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cand) {
    const dim3 grid((n + Tile<8>::Q - 1) / Tile<8>::Q, streams);
    knn_tile_cand_kernel<T, 8><<<grid, block, smem, s>>>(
        packed, map_stride, queries, n, bucket_slots, bucket_mask, cell,
        span, ring_rows, nbrs, sq, found, cand_pts, cand_ok);
  } else if (wide) {
    const dim3 grid((n + Tile<27>::Q - 1) / Tile<27>::Q, streams);
    knn_tile_kernel<T, 27><<<grid, block, smem, s>>>(
        packed, map_stride, queries, n, bucket_slots, bucket_mask, cell,
        span, ring_rows, nbrs, sq, found);
  } else {
    const dim3 grid((n + Tile<8>::Q - 1) / Tile<8>::Q, streams);
    knn_tile_kernel<T, 8><<<grid, block, smem, s>>>(
        packed, map_stride, queries, n, bucket_slots, bucket_mask, cell,
        span, ring_rows, nbrs, sq, found);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Raises the kernels' dynamic shared-memory limit to what a block may take
// on the current device; call once per device before the first launch.
int knn_configure() {
  int err = configure(knn_tile_kernel<float, 8>);
  if (!err) err = configure(knn_tile_kernel<float, 27>);
  if (!err) err = configure(knn_tile_kernel<double, 8>);
  if (!err) err = configure(knn_tile_kernel<double, 27>);
  if (!err) err = configure(knn_tile_cand_kernel<float, 8>);
  return err ? err : configure(knn_tile_cand_kernel<double, 8>);
}

// Launches the search on `stream` and returns cudaGetLastError() (0 = ok).
// `streams` (1..65535) maps, each packed (H, 4B) rows (16-byte aligned),
// the next map_stride scalars on (a multiple of 4, or 0: every stream
// searches one map); queries (streams, n, 3), outputs nbrs
// (streams, n, 5, 3), sq (streams, n, 5), all f32 (knn_search_f32) or all
// f64 (knn_search_f64), and found (streams, n, 5) uint8; all contiguous on
// the current device.  ring_rows
// (1..32) rows of 4B scalars per stage of the shared-memory ring.  The
// region's AABB is f32 in both: cell and span as f32 (f64: cell rounded to
// f32 for it, exact for the region's base cell).
int knn_search_f32(const float* packed, long long map_stride, int streams,
                   const float* queries, int n, int bucket_slots,
                   unsigned int bucket_mask, float cell, float span, int wide,
                   int ring_rows, float* nbrs, float* sq,
                   unsigned char* found, void* stream) {
  return launch<float>(packed, map_stride, streams, queries, n, bucket_slots,
                       bucket_mask, cell, span, wide, ring_rows, nbrs, sq,
                       found, nullptr, nullptr, stream);
}

int knn_search_f64(const double* packed, long long map_stride, int streams,
                   const double* queries, int n, int bucket_slots,
                   unsigned int bucket_mask, double cell, float span,
                   int wide, int ring_rows, double* nbrs, double* sq,
                   unsigned char* found, void* stream) {
  return launch<double>(packed, map_stride, streams, queries, n,
                        bucket_slots, bucket_mask, cell, span, wide,
                        ring_rows, nbrs, sq, found, nullptr, nullptr, stream);
}

// The candidates variant at R = 8: the search's outputs as above, and the
// block, cand_pts (streams, n, 8B, 3) of the search's type and cand_ok
// (streams, n, 8B) uint8, contiguous.
int knn_search_candidates_f32(const float* packed, long long map_stride,
                              int streams, const float* queries, int n,
                              int bucket_slots, unsigned int bucket_mask,
                              float cell, float span, int ring_rows,
                              float* nbrs, float* sq, unsigned char* found,
                              float* cand_pts, unsigned char* cand_ok,
                              void* stream) {
  return launch<float>(packed, map_stride, streams, queries, n, bucket_slots,
                       bucket_mask, cell, span, 0, ring_rows, nbrs, sq,
                       found, cand_pts, cand_ok, stream);
}

int knn_search_candidates_f64(const double* packed, long long map_stride,
                              int streams, const double* queries, int n,
                              int bucket_slots, unsigned int bucket_mask,
                              double cell, float span, int ring_rows,
                              double* nbrs, double* sq, unsigned char* found,
                              double* cand_pts, unsigned char* cand_ok,
                              void* stream) {
  return launch<double>(packed, map_stride, streams, queries, n,
                        bucket_slots, bucket_mask, cell, span, 0, ring_rows,
                        nbrs, sq, found, cand_pts, cand_ok, stream);
}

const char* knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
