"""The least time an H100 could take for one kNN search, and for one
segmented mean of the voxel downsample: the bounds set beside each kernel's
time by ``chip_smoke.py``, ``tools/microbench_knn.py`` and
``tools/microbench_segment_sum.py``.

Counted as a roofline counts it, for this search's data: the bytes the
search must move (each distinct bucket row it reads, once; the queries once;
the outputs once) over the card's memory rate, and the operations it must do
(for each query, about 15 operations per live slot of its distinct region
rows, one per free slot) over the card's rate for the search's type; the
larger of the two bounds it.  In float64 the rows, queries, neighbours and
distances take twice the bytes and the operations run at the FP64 rate.
Both kNN kernels compute the same function, so they share the bound.
The segmented mean's bound has a third term, the chain of dependent adds
its order imposes (``segment_mean_bound``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..map import hash_map as hm

# NVIDIA's H100 SXM data sheet: HBM3 rate, and f32 and f64 outside the
# tensor cores
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12
FLOPS = {torch.float32: H100_F32_FLOPS, torch.float64: H100_F64_FLOPS}
# per live candidate: 3 subtractions, 3 products, 3 sums (w included) and 6
# compares against the region's AABB
OPS_PER_LIVE_SLOT = 15
QUERY_BYTES = 12  # (x, y, z) f32, as the grouped prep reads them


def query_bytes(itemsize: int) -> int:
    """Bytes a search reads and writes per query: the query (x, y, z) and
    K neighbours (x, y, z) and squared distances, in scalars of
    ``itemsize`` bytes, and K found flags."""
    return (3 + hm.NUM_MATCH_POINTS * 4) * itemsize + hm.NUM_MATCH_POINTS


class Bound(NamedTuple):
    ms: float
    by: str  # "bytes" or "operations"
    distinct_rows: int  # bucket rows read, each once
    nbytes: int
    ops: int
    chain_us: float = 0.0  # the longest chain of dependent operations


def knn_bound(m: hm.Map, cfg: hm.MapConfig, queries: torch.Tensor,
              wide: bool = False) -> Bound:
    """The bound of ``knn_search(m, cfg, queries, wide=wide)`` on this data,
    in the map's dtype (torch ops on the map's device; a few host reads)."""
    B = cfg.bucket_slots
    N = queries.shape[0]
    _base, cells, _R = hm.region_cells(queries, cfg, wide)
    buckets = torch.sort(hm._bucket_of(cells, cfg.h_log2), dim=-1).values
    distinct = torch.ones_like(buckets, dtype=torch.bool)
    distinct[:, 1:] = buckets[:, 1:] != buckets[:, :-1]
    live_per_bucket = hm.valid_mask(m).sum(dim=1)
    live = int((live_per_bucket[buckets] * distinct).sum())
    slots = int(distinct.sum()) * B
    rows = int(torch.unique(buckets).numel())
    itemsize = m.packed.element_size()
    nbytes = rows * 4 * B * itemsize + N * query_bytes(itemsize)
    ops = OPS_PER_LIVE_SLOT * live + (slots - live)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / FLOPS[m.packed.dtype] * 1e3
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations",
                 rows, nbytes, ops)


def candidate_block_bytes(n: int, cfg: hm.MapConfig, itemsize: int) -> int:
    """Bytes of the candidate block of n queries at R = 8 that the
    candidates variant writes: each slot's x, y, z and its flag."""
    return n * 8 * cfg.bucket_slots * (3 * itemsize + 1)


def knn_candidates_bound(m: hm.Map, cfg: hm.MapConfig,
                         queries: torch.Tensor) -> Bound:
    """The bound of ``knn_search_candidates(m, cfg, queries)``: the
    search's (``knn_bound`` at R = 8) with the candidate block's bytes
    written once added (``candidate_block_bytes``); the block is copied,
    no operation."""
    b = knn_bound(m, cfg, queries)
    nbytes = b.nbytes + candidate_block_bytes(
        queries.shape[0], cfg, m.packed.element_size())
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = b.ops / FLOPS[m.packed.dtype] * 1e3
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations",
                 b.distinct_rows, nbytes, b.ops)


def knn_candidates_bound_streams(maps, cfg: hm.MapConfig, queries) -> Bound:
    """``knn_candidates_bound`` of one launch over the streams: their
    bytes and operations added."""
    return _added([knn_candidates_bound(m, cfg, q)
                   for m, q in zip(maps, queries)], maps[0].packed.dtype)


def _added(parts, dtype) -> Bound:
    nbytes = sum(b.nbytes for b in parts)
    ops = sum(b.ops for b in parts)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / FLOPS[dtype] * 1e3
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations",
                 sum(b.distinct_rows for b in parts), nbytes, ops)


def knn_bound_streams(maps, cfg: hm.MapConfig, queries, wide: bool = False
                      ) -> Bound:
    """The bound of one batched search (``knn_search_cuda_batched``): each
    stream's queries against its own map, so the streams' bytes (each
    stream's distinct rows once) and operations add up."""
    return _added([knn_bound(m, cfg, q, wide) for m, q in zip(maps, queries)],
                  maps[0].packed.dtype)


# the grouped search's prep, per query: the queries in and order (int32)
# out; a division and a subtraction per coordinate for its key
PREP_BYTES_PER_QUERY = QUERY_BYTES + 4
PREP_OPS_PER_QUERY = 6


def prep_bound(n: int, n_groups: int) -> Bound:
    """The bound of grouping n queries into n_groups groups
    (``knn_grouped.group_queries_cuda``): what the search reads of it (order,
    the n_groups starts and their count, int32) and the queries it reads, or
    its f32 key arithmetic (no map row), the larger."""
    nbytes = n * PREP_BYTES_PER_QUERY + 4 * n_groups + 4
    ops = n * PREP_OPS_PER_QUERY
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations", 0, nbytes,
                 ops)


# one dependent add's latency in SM cycles, and the SM clock it runs at:
# tools/probe.py (python3 -m fast_lio_tpu_torch.tools.probe) measured 4.57
# (f32) and 8.32 (f64) cycles an add on an H100 80GB HBM3 at 700 W, its
# loop's cost included, and the bound takes the whole cycles below; 1980
# MHz is the H100 SXM's maximum boost clock (NVIDIA's data sheet), which
# nvidia-smi read under load
ADD_CYCLES = {torch.float32: 4, torch.float64: 8}
H100_SM_CLOCK_HZ = 1.98e9


def longest_segment(seg_id: torch.Tensor, n_out: int) -> int:
    """The most points any kept segment (id below n_out) holds, over the
    lanes of (N,) or (S, N) sorted ids."""
    ids = seg_id if seg_id.dim() == 2 else seg_id[None]
    longest = 0
    for lane in ids:
        _, counts = torch.unique_consecutive(lane[lane < n_out],
                                             return_counts=True)
        if counts.numel():
            longest = max(longest, int(counts.max()))
    return longest


def segment_mean_bound(seg_id: torch.Tensor, c: int, n_out: int,
                       dtype: torch.dtype) -> Bound:
    """The bound of one ``segment_sum.segment_mean`` of points of c columns
    into n_out segments, for these segment ids (N,), or (S, N) over S
    lanes: the largest of three times.  The bytes: what the function needs
    of its inputs, each read once (the columns and live flags of the points
    in segments below n_out; of the sorted ids, one per boundary: each
    non-empty segment's start and the end of the last), and its outputs
    written once (the means, the mask).  The operations: per point it sums
    a product a column and a count, per segment a division a column.  The
    chain (``chain_us``): a segment's sums are each a chain of dependent
    adds in sorted order, one a point, so the longest kept segment takes
    its length times one add's latency (``ADD_CYCLES`` at
    ``H100_SM_CLOCK_HZ``), whatever runs beside it; the lanes run side by
    side.  ``by`` is "bytes", or "operations" where the operations or
    their chain take longer.  The dead points and the live ones past the
    last kept segment sit in segment n_out, at the tail: nothing of them is
    needed."""
    ids = seg_id if seg_id.dim() == 2 else seg_id[None]
    streams = ids.shape[0]
    kept = ids < n_out
    points = int(kept.sum())
    heads = kept.clone()
    heads[:, 1:] &= ids[:, 1:] != ids[:, :-1]
    boundaries = int(heads.sum()) + streams
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (points * (c * itemsize + 1) + boundaries * 8
              + streams * n_out * (c * itemsize + 1))
    ops = points * (2 * c + 1) + streams * n_out * c
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / FLOPS[dtype] * 1e3
    chain_us = (longest_segment(ids, n_out) * ADD_CYCLES[dtype]
                / H100_SM_CLOCK_HZ * 1e6)
    t_ops = max(t_ops, 1e-3 * chain_us)
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations", 0, nbytes,
                 ops, chain_us)
