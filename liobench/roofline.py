"""The yardstick of the kernels' roofline shares: the card's published
peaks and the least work a call needs, counted from the cell's inputs.

The work follows the arithmetic of ``fast_lio_tpu_torch/kernels/bounds.py``
(``knn_bound``, ``segment_mean_bound``), copied here so that a later change
of the program cannot move the yardstick: bytes that must move (each
distinct input read once, each output written once) over the memory rate,
operations over the arithmetic rate, and for the segmented mean the chain of
dependent adds its sorted order imposes; the largest of them bounds the
call.  Nothing a kernel reports is used.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# NVIDIA's H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
FLOPS = {torch.float32: F32_FLOPS, torch.float64: F64_FLOPS}
# the maximum boost clock of the H100 SXM, and one dependent add's latency
# in cycles (float32 4, float64 8: the card's measured 4.57 and 8.32 cycles
# a loop step, its loop included, taken down to whole cycles)
SM_CLOCK_HZ = 1.98e9
ADD_CYCLES = {torch.float32: 4, torch.float64: 8}

NUM_MATCH = 5
OPS_PER_LIVE_SLOT = 15  # 3 differences, 3 products, 3 sums, 6 box compares


class Work(NamedTuple):
    nbytes: int
    ops: int
    chain_s: float = 0.0

    def __add__(self, other):
        return Work(self.nbytes + other.nbytes, self.ops + other.ops,
                    max(self.chain_s, other.chain_s))

    def seconds(self, dtype=torch.float32) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S, self.ops / FLOPS[dtype],
                   self.chain_s)

    def by(self, dtype=torch.float32) -> str:
        t_b = self.nbytes / HBM_BYTES_PER_S
        return "bytes" if t_b >= max(self.ops / FLOPS[dtype],
                                     self.chain_s) else "operations"


# ---- the map's buckets (the hash map's layout: bucket = hash(cell)) ----

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    lo = (h * (c & 0xFFFF)) & _M32
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def bucket_of(cells: torch.Tensor, h_log2: int) -> torch.Tensor:
    """The bucket of integer cells (..., 3): a 32-bit spatial hash
    (prime products xor'd, murmur3's finaliser), its low h_log2 bits."""
    c = cells.to(torch.int64)
    h = ((c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & ((1 << h_log2) - 1)


def knn_work(packed: torch.Tensor, queries: torch.Tensor, cell: float,
             h_log2: int, wide: bool) -> Work:
    """One search of ``queries`` (N, 3) over the map rows ``packed`` (H,
    4B): each distinct bucket row of the queries' regions read once, the
    queries read and their k neighbours, distances and flags written once;
    per query, OPS_PER_LIVE_SLOT operations per live slot of its distinct
    rows and one per free slot."""
    B = packed.shape[-1] // 4
    itemsize = packed.element_size()
    span = 3 if wide else 2
    base = torch.floor(queries / cell - (1.0 if wide else 0.5)).long()
    r = torch.arange(span, device=queries.device)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    buckets = torch.sort(bucket_of(base[:, None] + off, h_log2), -1).values
    distinct = torch.ones_like(buckets, dtype=torch.bool)
    distinct[:, 1:] = buckets[:, 1:] != buckets[:, :-1]
    live = (packed[:, 3 * B:] == 0.0).sum(1)
    n_live = int((live[buckets] * distinct).sum())
    slots = int(distinct.sum()) * B
    rows = int(torch.unique(buckets).numel())
    N = queries.shape[0]
    per_query = (3 + NUM_MATCH * 4) * itemsize + NUM_MATCH
    return Work(rows * 4 * B * itemsize + N * per_query,
                OPS_PER_LIVE_SLOT * n_live + (slots - n_live))


def segment_mean_work(pts: torch.Tensor, leaf: float, n_out: int,
                      cols: int = 4, dtype=torch.float32) -> Work:
    """One segmented mean of a scan's points into its voxels (side
    ``leaf``), the first ``n_out`` voxels in sorted order kept: each kept
    point's ``cols`` columns and flag read, each segment's boundary, each
    of the n_out means and flags written; 2 cols + 1 operations a kept point
    and cols a segment; and the longest kept segment's chain of dependent
    adds."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if pts.shape[0] == 0:
        return Work(n_out * (cols * itemsize + 1), n_out * cols)
    keys = torch.floor(pts.double() / leaf).long()
    keys = keys - keys.min(0).values
    key = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
    _, counts = torch.unique_consecutive(torch.sort(key).values,
                                         return_counts=True)
    counts = counts[:n_out]
    points = int(counts.sum())
    nbytes = (points * (cols * itemsize + 1) + (counts.numel() + 1) * 8
              + n_out * (cols * itemsize + 1))
    ops = points * (2 * cols + 1) + n_out * cols
    chain = int(counts.max()) * ADD_CYCLES[dtype] / SM_CLOCK_HZ
    return Work(nbytes, ops, chain)
