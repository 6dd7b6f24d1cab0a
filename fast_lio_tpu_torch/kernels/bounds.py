"""The least time an H100 could take for one kNN search: the bound set
beside each kNN kernel's time by ``chip_smoke.py`` and
``tools/microbench_knn.py``.

Counted as a roofline counts it, for this search's data: the bytes the
search must move (each distinct bucket row it reads, once; the queries once;
the outputs once) over the card's memory rate, and the operations it must do
(for each query, about 15 operations per live slot of its distinct region
rows, one per free slot) over the card's rate for the search's type; the
larger of the two bounds it.  In float64 the rows, queries, neighbours and
distances take twice the bytes and the operations run at the FP64 rate.
Both kNN kernels compute the same function, so they share the bound.
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


def knn_bound_streams(maps, cfg: hm.MapConfig, queries, wide: bool = False
                      ) -> Bound:
    """The bound of one batched search (``knn_search_cuda_batched``): each
    stream's queries against its own map, so the streams' bytes (each
    stream's distinct rows once) and operations add up."""
    parts = [knn_bound(m, cfg, q, wide) for m, q in zip(maps, queries)]
    nbytes = sum(b.nbytes for b in parts)
    ops = sum(b.ops for b in parts)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / FLOPS[maps[0].packed.dtype] * 1e3
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations",
                 sum(b.distinct_rows for b in parts), nbytes, ops)


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
