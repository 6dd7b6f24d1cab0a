"""The region-grouped kNN search: the hand-written CUDA kernels
(``csrc/knn_grouped.cu``), their wrapper, and the plain PyTorch version.

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

Two launches a search, no host read: ``knn_grouped_prep_kernel`` computes
the prep of ``group_queries`` (region key, stable sort, group starts, group
count) in one block on the device, bit for bit, for up to
``PREP_MAX_QUERIES`` queries (every search of the main path: the pipeline
refuses the grouped backend with a larger ``n_ds_max``, and the wrapper
refuses larger sets).  Then the persistent ``knn_grouped_search_kernel``
(a few blocks per SM, each walking groups up to the count it reads on the
device) stages each group's head rows by bulk copies into a ring of
``search_stages(R, B)`` buffers and scores the group's queries, writing
each result at its query's original index (the un-sort).

Bound: ``kernels/bounds.py``, each distinct row once.  The JAX package found
that real query sets give about 1.3 queries per region on the TPU
(``tools/knn_grouped.py:3-11``); the port's main path groups far better
(``PERF.md``).

Routing: a CPU tensor goes to ``knn_search_grouped_plain``; a CUDA tensor
always goes to the kernels (built at first use), and anything they do not
take raises, float64 included: the kernels are float32 only (the JAX
package has no grouped backend to follow in float64, and ``Pipeline``
refuses ``knn_backend="grouped"`` with ``compute_dtype="float64"``).
``launches`` counts search launches per R, ``prep_launches`` prep launches
per R.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..map import hash_map as hm
from . import build
from .knn import check_inputs, empty_outputs

G = 8  # queries per group (one scoring warp each)
KEY_BITS = 10  # per-axis region-key bits; 2^9 cells each side of the origin
MAX_SHARED_BYTES = 232448  # an H100 block's shared memory (227 KB)
STATIC_SHARED_BYTES = 2048  # the search kernel's own (stage records, barriers)
STAGE_BUDGET = 112 * 1024  # the ring of one block: two blocks share an SM
MIN_STAGES, MAX_STAGES = 2, 4
PREP_MAX_QUERIES = 8192  # what one block sorts: 1024 threads x 8 queries

launches = {8: 0, 27: 0}
prep_launches = {8: 0, 27: 0}


class Groups(NamedTuple):
    """Queries cut into groups of equal region key.

    order: (N,) int64 (int32 from the prep kernel), the queries sorted by
        key (stable);
    starts: (N,) int32, sorted position of each group's head (first
        ``n_groups`` entries used; the rest are 0 from ``group_queries`` and
        unwritten by the prep kernel);
    n_groups: (1,) int32 on the queries' device;
    gid: (N,) int64, the group of each sorted position (``group_queries``
        only: the search does not read it, so the prep kernel does not write
        it, and it is None there)."""

    order: torch.Tensor
    starts: torch.Tensor
    n_groups: torch.Tensor
    gid: Optional[torch.Tensor]


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


def search_stages(R: int, B: int) -> int:
    """Buffers of R rows in the search kernel's ring: as many as
    ``STAGE_BUDGET`` holds, at least 2 (a group loads while another is
    scored) and at most 4; raises where 2 do not fit in a block."""
    stage = R * 16 * B
    stages = max(MIN_STAGES, min(MAX_STAGES, STAGE_BUDGET // stage))
    if stages * stage > MAX_SHARED_BYTES - STATIC_SHARED_BYTES:
        raise ValueError(
            f"{stages} stages of R={R} rows of B={B} slots need "
            f"{stages * stage} bytes of shared memory, more than a block "
            f"has ({MAX_SHARED_BYTES - STATIC_SHARED_BYTES})")
    return stages


@functools.cache
def _lib():
    """The kernels' library, built at first use, with its C signatures."""
    lib = build.load("knn_grouped")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.knn_grouped_f32.argtypes = [p, p, p, p, p, i, i, ctypes.c_uint, f, f,
                                    i, i, i, p, p, p, p]
    lib.knn_grouped_f32.restype = i
    lib.knn_grouped_prep.argtypes = [p, i, f, i, p, p, p, p]
    lib.knn_grouped_prep.restype = i
    lib.knn_grouped_configure.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.knn_grouped_configure.restype = i
    lib.knn_grouped_error_string.argtypes = [i]
    lib.knn_grouped_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().knn_grouped_error_string(err).decode()
        raise RuntimeError(f"knn_grouped {what} failed: {msg}")


@functools.cache
def _persistent_grid(device_index: int, wide: bool, B: int,
                     stages: int) -> int:
    """Blocks of the persistent search that fit on the device at once (the
    kernel's shared-memory limit is raised on the way)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().knn_grouped_configure(int(wide), B, stages,
                                           ctypes.byref(blocks))
    _raise_on(err, "setup")
    if blocks.value < 1:
        raise RuntimeError("knn_grouped: no block of the search fits an SM")
    return blocks.value


def group_queries_cuda(queries: torch.Tensor, cfg: hm.MapConfig,
                       wide: bool = False) -> Groups:
    """``group_queries`` by the prep kernel (one launch on the current
    stream, no host read), for 1..``PREP_MAX_QUERIES`` CUDA queries: order,
    the first n_groups entries of starts, and n_groups, all int32 (no
    ``gid``)."""
    N, dev = queries.shape[0], queries.device
    check_prep_size(N)
    if not (queries.is_cuda and queries.dtype == torch.float32
            and queries.is_contiguous()):
        raise ValueError("the prep kernel takes contiguous float32 CUDA "
                         f"queries (got {queries.dtype} on {dev})")
    i32 = dict(dtype=torch.int32, device=dev)
    order, starts = torch.empty(N, **i32), torch.empty(N, **i32)
    n_groups = torch.empty(1, **i32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().knn_grouped_prep(
            queries.data_ptr(), N, float(cfg.cell_size), int(wide),
            order.data_ptr(), starts.data_ptr(), n_groups.data_ptr(), stream)
    _raise_on(err, "prep launch")
    prep_launches[27 if wide else 8] += 1
    return Groups(order, starts, n_groups, None)


def check_prep_size(n: int) -> None:
    """Raises unless the prep kernel's one block sorts ``n`` queries."""
    if not 0 < n <= PREP_MAX_QUERIES:
        raise ValueError(f"the grouped search's prep kernel groups "
                         f"1..{PREP_MAX_QUERIES} queries in one block (got "
                         f"{n}); the per-query search takes any number")


def knn_search(m: hm.Map, cfg: hm.MapConfig, queries: torch.Tensor,
               k: int = hm.NUM_MATCH_POINTS, wide: bool = False):
    """(nbrs (N, k, 3), sq (N, k) with +inf where missing, found (N, k)).

    CPU tensors: the plain version.  CUDA tensors: the kernel."""
    if queries.device.type == "cpu" and m.packed.device.type == "cpu":
        return knn_search_grouped_plain(m, cfg, queries, k=k, wide=wide)
    return knn_search_cuda(m.packed, cfg, queries, k=k, wide=wide)


def knn_search_cuda(packed: torch.Tensor, cfg: hm.MapConfig,
                    queries: torch.Tensor, k: int = hm.NUM_MATCH_POINTS,
                    wide: bool = False):
    """Group the queries (``group_queries_cuda``) and launch the search on
    ``torch.cuda.current_stream()``; no sync, no host read.  Raises above
    ``PREP_MAX_QUERIES`` queries."""
    N = queries.shape[0]
    if N:
        check_prep_size(N)
    check_inputs(packed, cfg, queries, k, dtypes=(torch.float32,))
    H, B = cfg.num_buckets, cfg.bucket_slots
    R = 27 if wide else 8
    stages = search_stages(R, B)
    nbrs, sq, found = empty_outputs(queries, k)
    if N == 0:
        return nbrs, sq, found
    grid = min(N, _persistent_grid(queries.device.index, wide, B, stages))
    grp = group_queries_cuda(queries, cfg, wide)

    span = (3 if wide else 2) * cfg.cell_size
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().knn_grouped_f32(
            packed.data_ptr(), queries.data_ptr(), grp.order.data_ptr(),
            grp.starts.data_ptr(), grp.n_groups.data_ptr(), N, B, H - 1,
            float(cfg.cell_size), float(span), int(wide), stages, grid,
            nbrs.data_ptr(), sq.data_ptr(), found.data_ptr(), stream)
    _raise_on(err, "search launch")
    launches[R] += 1
    return nbrs, sq, found
