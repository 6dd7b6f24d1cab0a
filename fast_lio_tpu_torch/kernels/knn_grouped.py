"""The region-grouped kNN search: the hand-written CUDA kernel
(``csrc/knn_grouped.cu``), its wrapper, and its plain PyTorch version.

Replaces the TPU kernel ``tools/knn_grouped.py::_kernel`` (its wrapper
``knn_search_grouped``, ``pallas_call`` at ``tools/knn_grouped.py:217``).
It computes what the per-query search computes (``kernels/knn.py``), with
the work cut differently: the queries are sorted by a static-origin region
key (10 bits per axis, each axis clamped), each run of equal keys is cut
into groups of at most ``G`` = 8, and a group searches the bucket rows of
its HEAD's region (loaded once for the group), each query with its own
half-open AABB.  Where a key is not clamped (every coordinate within 512
storage cells of the origin) the head's region is the query's own, and the
result equals ``hash_map.knn_search`` bit for bit; beyond that the TPU
kernel's semantics are kept (the head's rows).

The prep — region key, stable sort, group starts, group count — runs as
torch ops in ``group_queries`` (the JAX wrapper does it in XLA, outside the
``pallas_call``); the kernel does the row staging, distances and top-5, and
writes each result at its query's original index (the un-sort).  The group
count stays on the device: the kernel's grid is N blocks and block g exits
when g >= n_groups, so a search makes no host read.

Bound on an H100 SXM (3.35 TB/s): each group's rows read once,
n_groups * R * 4B * 4 bytes, plus queries and outputs.  The JAX package
found that real query sets give about 1.3 queries per region on the TPU
(``tools/knn_grouped.py:3-11``), where groups share little.

Routing: a CPU tensor goes to ``knn_search_grouped_plain``; a CUDA tensor
always goes to the kernel (built at first use), and anything the kernel does
not take raises.  ``launches`` counts kernel launches per R.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..map import hash_map as hm
from . import build
from .knn import check_inputs, empty_outputs

G = 8  # queries per group (one warp each, one block per group)
KEY_BITS = 10  # per-axis region-key bits; 2^9 cells each side of the origin
MAX_SHARED_BYTES = 232448  # an H100 block's shared memory (227 KB)

launches = {8: 0, 27: 0}


class Groups(NamedTuple):
    """Queries cut into groups of equal region key.

    order: (N,) int64, the queries sorted by key (stable);
    starts: (N,) int32, sorted position of each group's head (first
        ``n_groups`` entries used);
    n_groups: (1,) int32 on the queries' device;
    gid: (N,) int64, the group of each sorted position."""

    order: torch.Tensor
    starts: torch.Tensor
    n_groups: torch.Tensor
    gid: torch.Tensor


def region_key(base: torch.Tensor) -> torch.Tensor:
    """Fused int32 key of region base cells (N, 3) with a static origin:
    each axis offset by 2^9 and clamped to 10 bits (``_region_key``,
    ``tools/knn_grouped.py:153-158``)."""
    half = 1 << (KEY_BITS - 1)
    rel = torch.clamp(base + half, 0, (1 << KEY_BITS) - 1)
    return (rel[:, 0] << (2 * KEY_BITS)) | (rel[:, 1] << KEY_BITS) | rel[:, 2]


def group_queries(queries: torch.Tensor, cfg: hm.MapConfig,
                  wide: bool = False) -> Groups:
    """Sort by region key and cut groups: a new group at every key change
    and every G-th query of a run (``tools/knn_grouped.py:179-194``).
    Torch ops on the queries' device; no host read."""
    N, dev = queries.shape[0], queries.device
    key = region_key(hm.region_base(queries, cfg, wide))
    order = torch.sort(key, stable=True).indices
    ksort = key[order]
    idx = torch.arange(N, device=dev)
    head = torch.ones(N, dtype=torch.bool, device=dev)
    head[1:] = ksort[1:] != ksort[:-1]
    seg_start = torch.cummax(torch.where(head, idx, 0), dim=0).values
    gnew = head | ((idx - seg_start) % G == 0)
    gid = torch.cumsum(gnew, dim=0) - 1
    # only a head writes its group's start; the others go to the dropped
    # slot N
    starts = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    starts.scatter_(0, torch.where(gnew, gid, N), idx.to(torch.int32))
    n_groups = (gid[-1:] + 1).to(torch.int32)
    return Groups(order, starts[:N], n_groups, gid)


def knn_search_grouped_plain(m: hm.Map, cfg: hm.MapConfig,
                             queries: torch.Tensor,
                             k: int = hm.NUM_MATCH_POINTS,
                             wide: bool = False):
    """The plain version of the grouped kernel: every sorted query is scored
    over its group head's (deduplicated, sorted) bucket rows with its own
    AABB (``hash_map.search_rows``), then the results are un-sorted by the
    inverse permutation."""
    N = queries.shape[0]
    if N == 0:
        return hm.knn_search(m, cfg, queries, k=k, wide=wide)
    grp = group_queries(queries, cfg, wide)
    base, cells, _R = hm.region_cells(queries, cfg, wide)
    buckets, dup = hm.dedup_buckets(hm._bucket_of(cells, cfg.h_log2),
                                    cfg.num_buckets - 1)
    head = grp.order[grp.starts[grp.gid].long()]  # each query's group head
    nbrs, sq, found = hm.search_rows(m, cfg, queries[grp.order],
                                     base[grp.order], buckets[head],
                                     dup[head], k, wide)
    inv = torch.empty_like(grp.order)
    inv[grp.order] = torch.arange(N, device=queries.device)
    return nbrs[inv], sq[inv], found[inv]


@functools.cache
def _lib():
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("knn_grouped")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.knn_grouped_f32.argtypes = [p, p, p, p, p, i, i, ctypes.c_uint, f, f,
                                    i, p, p, p, p]
    lib.knn_grouped_f32.restype = i
    lib.knn_grouped_error_string.argtypes = [i]
    lib.knn_grouped_error_string.restype = ctypes.c_char_p
    return lib


def knn_search(m: hm.Map, cfg: hm.MapConfig, queries: torch.Tensor,
               k: int = hm.NUM_MATCH_POINTS, wide: bool = False):
    """(nbrs (N, k, 3), sq (N, k) with +inf where missing, found (N, k)).

    CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if queries.device.type == "cpu" and m.packed.device.type == "cpu":
        return knn_search_grouped_plain(m, cfg, queries, k=k, wide=wide)
    return knn_search_cuda(m.packed, cfg, queries, k=k, wide=wide)


def knn_search_cuda(packed: torch.Tensor, cfg: hm.MapConfig,
                    queries: torch.Tensor, k: int = hm.NUM_MATCH_POINTS,
                    wide: bool = False, groups: Groups = None):
    """Group the queries (or take ``groups`` from ``group_queries``) and
    launch the kernel on ``torch.cuda.current_stream()``; no sync."""
    check_inputs(packed, cfg, queries, k)
    H, B = cfg.num_buckets, cfg.bucket_slots
    R = 27 if wide else 8
    if R * 4 * B * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"R={R} rows of B={B} slots need {R * 16 * B} bytes of shared "
            f"memory, more than a block has ({MAX_SHARED_BYTES})")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (float4 row loads)")
    nbrs, sq, found = empty_outputs(queries, k)
    N = queries.shape[0]
    if N == 0:
        return nbrs, sq, found
    grp = group_queries(queries, cfg, wide) if groups is None else groups
    order = grp.order.to(torch.int32)

    span = (3 if wide else 2) * cfg.cell_size
    lib = _lib()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_grouped_f32(
            packed.data_ptr(), queries.data_ptr(), order.data_ptr(),
            grp.starts.data_ptr(), grp.n_groups.data_ptr(), N, B, H - 1,
            float(cfg.cell_size), float(span), int(wide),
            nbrs.data_ptr(), sq.data_ptr(), found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("knn_grouped kernel launch failed: "
                           f"{lib.knn_grouped_error_string(err).decode()}")
    launches[R] += 1
    return nbrs, sq, found
