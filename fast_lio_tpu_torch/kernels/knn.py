"""Wrapper of the hand-written CUDA kNN kernel (``csrc/knn.cu``).

Replaces the TPU kernel ``tools/knn_pallas.py::_kernel`` (its wrapper
``knn_search_pallas``, ``pallas_call`` at ``tools/knn_pallas.py:193``).  The
kernel computes exactly ``map.hash_map.knn_search`` — its plain version —
for the 2x2x2 region (R = 8) and the wide 3x3x3 region (R = 27).

The kernel takes a tile of ``TILE[R]`` consecutive queries per block, stages
the tile's distinct bucket rows (its union) into a two-stage ring in shared
memory by bulk copies, ``ring_rows(B)`` rows a stage, and scores each query
against the staged rows of its own region; see the source's header.
``tile_union_stats`` counts, in plain torch, the rows a tile stages.  Bound:
``kernels/bounds.py``, each distinct row once, under a microsecond on the
sim map.

The kernel is built for float32 and float64 (``Config.compute_dtype``; the
JAX main path searches in XLA in either).  In float64 a row takes twice the
bytes, so ``ring_rows(B, 8)`` stages at most half as many rows where two
stages of 16 would pass ``RING_BYTES``.

The kernel has a stream axis (``blockIdx.y``): one launch searches S maps,
each with its own queries (``knn_search_cuda_batched``), which is how the
batched step (``batch.BatchPipeline``, ``torch.func.vmap`` over the
single-stream step) searches its lanes.  ``knn_search`` is the custom op
``fast_lio_tpu_torch::knn_search``, so that vmap sees it whole: its vmap
rule makes that one launch on CUDA, or runs the plain version per stream
on the CPU.

The rescore re-search (``Config.rescore_research``) takes the search's
candidate block too: ``knn_search_candidates``, the custom op
``fast_lio_tpu_torch::knn_search_candidates``, returns what
``hash_map.knn_search(..., return_candidates=True)`` returns (at R = 8),
through the kernel's candidates variant (``knn_tile_cand_kernel``) on CUDA,
the plain version on the CPU, and over a stream axis under vmap.

Routing: a CPU tensor goes to the plain version; a CUDA tensor always goes
to the kernel (which is built at first use), and anything the kernel does
not take raises, another dtype included.  ``launches`` counts the float32
kernel's single launches per R, ``launches_f64`` the float64 kernel's;
``batched_launches`` and ``batched_launches_f64`` count the launches over
a stream axis, one per launch whatever its count of streams.  The
candidates variant's launches are counted apart, in ``cand_launches``,
``cand_launches_f64``, ``cand_batched_launches`` and
``cand_batched_launches_f64`` (keyed by R, 8).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..map import hash_map as hm
from . import build

# queries per block (tile), by R: a half warp per query at R = 8, a warp
# per query at R = 27 (a lane per region cell)
TILE = {8: 16, 27: 8}
RING_ROWS = 16  # rows per stage of the shared-memory row ring
RING_BYTES = 128 * 1024  # the most the ring's two stages may take
DTYPES = (torch.float32, torch.float64)  # the kernel's instantiations

launches = {8: 0, 27: 0}  # float32
launches_f64 = {8: 0, 27: 0}
# the launches over a stream axis (knn_search_cuda_batched, the batched
# step's search), apart from the single searches above
batched_launches = {8: 0, 27: 0}
batched_launches_f64 = {8: 0, 27: 0}
# the candidates variant's (knn_search_candidates_cuda and _batched)
cand_launches = {8: 0}
cand_launches_f64 = {8: 0}
cand_batched_launches = {8: 0}
cand_batched_launches_f64 = {8: 0}


def ring_rows(B: int, itemsize: int = 4) -> int:
    """Rows of 4B scalars of ``itemsize`` bytes per stage of the kernel's
    two-stage ring: 16, or fewer where two stages of 16 would pass
    ``RING_BYTES``."""
    row_bytes = 4 * itemsize * B
    rows = min(RING_ROWS, RING_BYTES // (2 * row_bytes))
    if rows < 1:
        raise ValueError(f"a bucket row of B={B} slots ({row_bytes} bytes) "
                         f"does not fit the kernel's ring ({RING_BYTES} B)")
    return rows


def tile_union_stats(queries: torch.Tensor, cfg: hm.MapConfig,
                     wide: bool = False) -> dict:
    """How many distinct bucket rows each tile of ``TILE[R]`` consecutive
    queries stages (plain torch, any device): the tiles, the mean and the
    largest union, and the mean count of ring chunks it takes."""
    tile = TILE[27 if wide else 8]
    N = queries.shape[0]
    if N == 0:
        return {"tiles": 0, "mean_rows": 0.0, "max_rows": 0,
                "mean_chunks": 0.0}
    _base, cells, _R = hm.region_cells(queries, cfg, wide)
    buckets = hm._bucket_of(cells, cfg.h_log2)
    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N  # repeats of the last query add no row
    if pad:
        buckets = torch.cat([buckets, buckets[-1:].expand(pad, -1)])
    per_tile = torch.sort(buckets.reshape(n_tiles, -1), dim=1).values
    rows = 1 + (per_tile[:, 1:] != per_tile[:, :-1]).sum(dim=1)
    chunks = -(-rows // ring_rows(cfg.bucket_slots, queries.element_size()))
    return {"tiles": n_tiles, "mean_rows": float(rows.double().mean()),
            "max_rows": int(rows.max()),
            "mean_chunks": float(chunks.double().mean())}


@functools.cache
def _lib():
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("knn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, cell in ((lib.knn_search_f32, f), (lib.knn_search_f64,
                                               ctypes.c_double)):
        fn.argtypes = [p, ctypes.c_longlong, i, p, i, i, ctypes.c_uint, cell,
                       f, i, i, p, p, p, p]
        fn.restype = i
    for fn, cell in ((lib.knn_search_candidates_f32, f),
                     (lib.knn_search_candidates_f64, ctypes.c_double)):
        fn.argtypes = [p, ctypes.c_longlong, i, p, i, i, ctypes.c_uint, cell,
                       f, i, p, p, p, p, p, p]
        fn.restype = i
    lib.knn_configure.argtypes = []
    lib.knn_configure.restype = i
    lib.knn_error_string.argtypes = [i]
    lib.knn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _configure(device_index: int) -> None:
    """Raise the kernels' shared-memory limit once per device."""
    lib = _lib()
    with torch.cuda.device(device_index):
        err = lib.knn_configure()
    if err != 0:
        raise RuntimeError(
            f"knn kernel setup failed: {lib.knn_error_string(err).decode()}")


def knn_search(m: hm.Map, cfg: hm.MapConfig, queries: torch.Tensor,
               k: int = hm.NUM_MATCH_POINTS, wide: bool = False):
    """(nbrs (N, k, 3), sq (N, k) with +inf where missing, found (N, k)).

    The custom op ``fast_lio_tpu_torch::knn_search``: on CPU tensors the
    plain version, ``hash_map.knn_search``; on CUDA tensors the kernel.
    Under ``torch.func.vmap`` (the batched step) its vmap rule searches
    every stream's own map in one launch of the kernel
    (``knn_search_cuda_batched``), or on the CPU runs the plain version per
    stream."""
    return torch.ops.fast_lio_tpu_torch.knn_search(
        m.packed, queries, cfg.h_log2, cfg.bucket_slots, cfg.cell_size,
        cfg.voxel_size, k, wide)


def _on_cpu(packed: torch.Tensor, queries: torch.Tensor) -> bool:
    return queries.device.type == "cpu" and packed.device.type == "cpu"


@torch.library.custom_op("fast_lio_tpu_torch::knn_search", mutates_args=())
def _knn_op(packed: torch.Tensor, queries: torch.Tensor, h_log2: int,
            bucket_slots: int, cell_size: float, voxel_size: float, k: int,
            wide: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    cfg = hm.MapConfig(h_log2, bucket_slots, cell_size, voxel_size)
    if _on_cpu(packed, queries):
        return hm.knn_search(hm.Map(packed, None), cfg, queries, k=k,
                             wide=wide)
    return knn_search_cuda(packed, cfg, queries, k=k, wide=wide)


@_knn_op.register_fake
def _knn_fake(packed, queries, h_log2, bucket_slots, cell_size, voxel_size,
              k, wide):
    return empty_outputs(queries, k)


def _knn_vmap(info, in_dims, packed, queries, h_log2, bucket_slots,
              cell_size, voxel_size, k, wide):
    """The batched search: every stream's queries against its own map (a
    map or queries shared by the streams are broadcast).  CUDA: one launch
    of the kernel over the stream axis; CPU: the plain version per
    stream."""
    S = info.batch_size

    def lead(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(S, *t.shape)

    packed, queries = lead(packed, in_dims[0]), lead(queries, in_dims[1])
    cfg = hm.MapConfig(h_log2, bucket_slots, cell_size, voxel_size)
    if _on_cpu(packed, queries):
        per = [hm.knn_search(hm.Map(packed[s], None), cfg, queries[s], k=k,
                             wide=wide) for s in range(S)]
        out = tuple(torch.stack(o) for o in zip(*per))
    else:
        out = knn_search_cuda_batched(packed, cfg, queries.contiguous(), k=k,
                                      wide=wide)
    return out, (0, 0, 0)


torch.library.register_vmap("fast_lio_tpu_torch::knn_search", _knn_vmap)


def knn_search_candidates(m: hm.Map, cfg: hm.MapConfig,
                          queries: torch.Tensor,
                          k: int = hm.NUM_MATCH_POINTS):
    """(nbrs, sq, found, cand_pts (N, 8B, 3), cand_ok (N, 8B)): what
    ``hash_map.knn_search(m, cfg, queries, k, return_candidates=True)``
    returns, at R = 8.

    The custom op ``fast_lio_tpu_torch::knn_search_candidates``: on CPU
    tensors that plain version; on CUDA tensors the kernel's candidates
    variant.  Under ``torch.func.vmap`` its vmap rule searches every
    stream's own map in one launch (``knn_search_candidates_cuda_batched``),
    or on the CPU runs the plain version per stream."""
    return torch.ops.fast_lio_tpu_torch.knn_search_candidates(
        m.packed, queries, cfg.h_log2, cfg.bucket_slots, cfg.cell_size,
        cfg.voxel_size, k)


@torch.library.custom_op("fast_lio_tpu_torch::knn_search_candidates",
                         mutates_args=())
def _cand_op(packed: torch.Tensor, queries: torch.Tensor, h_log2: int,
             bucket_slots: int, cell_size: float, voxel_size: float, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor]:
    cfg = hm.MapConfig(h_log2, bucket_slots, cell_size, voxel_size)
    if _on_cpu(packed, queries):
        return hm.knn_search(hm.Map(packed, None), cfg, queries, k=k,
                             return_candidates=True)
    return knn_search_candidates_cuda(packed, cfg, queries, k=k)


@_cand_op.register_fake
def _cand_fake(packed, queries, h_log2, bucket_slots, cell_size, voxel_size,
               k):
    return empty_candidate_outputs(queries, k, 8 * bucket_slots)


def _cand_vmap(info, in_dims, packed, queries, h_log2, bucket_slots,
               cell_size, voxel_size, k):
    """The batched candidate search, as ``_knn_vmap``: CUDA, one launch of
    the candidates variant over the stream axis; CPU, the plain version per
    stream."""
    S = info.batch_size

    def lead(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(S, *t.shape)

    packed, queries = lead(packed, in_dims[0]), lead(queries, in_dims[1])
    cfg = hm.MapConfig(h_log2, bucket_slots, cell_size, voxel_size)
    if _on_cpu(packed, queries):
        per = [hm.knn_search(hm.Map(packed[s], None), cfg, queries[s], k=k,
                             return_candidates=True) for s in range(S)]
        out = tuple(torch.stack(o) for o in zip(*per))
    else:
        out = knn_search_candidates_cuda_batched(packed, cfg,
                                                 queries.contiguous(), k=k)
    return out, (0,) * 5


torch.library.register_vmap("fast_lio_tpu_torch::knn_search_candidates",
                            _cand_vmap)


def check_inputs(packed: torch.Tensor, cfg: hm.MapConfig,
                 queries: torch.Tensor, k: int, dtypes=DTYPES) -> None:
    """Raise ValueError on anything the kNN kernels do not take: packed and
    queries of one of ``dtypes``, the same for both."""
    H, B = cfg.num_buckets, cfg.bucket_slots
    if k != hm.NUM_MATCH_POINTS:
        raise ValueError(f"the kNN kernel is specialized to k=5 (got k={k})")
    for name, t in (("packed", packed), ("queries", queries)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name} must be {names} (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dtype != queries.dtype:
        raise ValueError(
            f"packed is {packed.dtype} but queries are {queries.dtype}")
    if packed.device != queries.device:
        raise ValueError(
            f"packed on {packed.device} but queries on {queries.device}")
    if tuple(packed.shape) != (H, 4 * B):
        raise ValueError(
            f"packed shape {tuple(packed.shape)} != (H, 4B) = {(H, 4 * B)}")
    if queries.dim() != 2 or queries.shape[1] != 3:
        raise ValueError(f"queries must be (N, 3) (got {tuple(queries.shape)})")
    if H * B >= 2**31:
        raise ValueError("map capacity H * B must stay below 2^31 slots")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (bulk row copies)")


def empty_outputs(queries: torch.Tensor, k: int):
    """Uninitialised (nbrs (..., N, k, 3), sq (..., N, k), found
    (..., N, k)) for queries (..., N, 3), on their device and, but for
    found, of their dtype, for a kernel to fill."""
    lead, dev, dt = queries.shape[:-1], queries.device, queries.dtype
    return (torch.empty(lead + (k, 3), dtype=dt, device=dev),
            torch.empty(lead + (k,), dtype=dt, device=dev),
            torch.empty(lead + (k,), dtype=torch.bool, device=dev))


def empty_candidate_outputs(queries: torch.Tensor, k: int, C: int):
    """``empty_outputs`` and the candidate block, (cand_pts (..., N, C, 3)
    of the queries' dtype, cand_ok (..., N, C) bool), uninitialised."""
    lead, dev, dt = queries.shape[:-1], queries.device, queries.dtype
    return (*empty_outputs(queries, k),
            torch.empty(lead + (C, 3), dtype=dt, device=dev),
            torch.empty(lead + (C,), dtype=torch.bool, device=dev))


def knn_search_cuda(packed: torch.Tensor, cfg: hm.MapConfig,
                    queries: torch.Tensor, k: int = hm.NUM_MATCH_POINTS,
                    wide: bool = False):
    """Launch the kernel on ``torch.cuda.current_stream()``; no sync."""
    check_inputs(packed, cfg, queries, k)
    out = empty_outputs(queries, k)
    if _launch(packed, 0, 1, queries, cfg, wide, out):
        (launches_f64 if queries.dtype == torch.float64 else launches)[
            27 if wide else 8] += 1
    return out


def knn_search_cuda_batched(packed: torch.Tensor, cfg: hm.MapConfig,
                            queries: torch.Tensor,
                            k: int = hm.NUM_MATCH_POINTS, wide: bool = False):
    """One launch over a stream axis: ``packed`` (S, H, 4B), each map's rows
    contiguous and the maps any multiple of 4 scalars apart (the stacked
    maps' ``rows[:, :H]``, or one map expanded), ``queries`` (S, N, 3)
    contiguous.  Returns (nbrs (S, N, k, 3), sq (S, N, k), found (S, N, k)),
    stream s's rows what ``knn_search_cuda(packed[s], cfg, queries[s])``
    returns.  On ``torch.cuda.current_stream()``; no sync."""
    _check_streams(packed, cfg, queries, k)
    out = empty_outputs(queries, k)
    if _launch(packed, packed.stride(0), queries.shape[0], queries, cfg,
               wide, out):
        (batched_launches_f64 if queries.dtype == torch.float64
         else batched_launches)[27 if wide else 8] += 1
    return out


def knn_search_candidates_cuda(packed: torch.Tensor, cfg: hm.MapConfig,
                               queries: torch.Tensor,
                               k: int = hm.NUM_MATCH_POINTS):
    """Launch the candidates variant on ``torch.cuda.current_stream()``; no
    sync.  Returns (nbrs, sq, found, cand_pts, cand_ok)."""
    check_inputs(packed, cfg, queries, k)
    out = empty_candidate_outputs(queries, k, 8 * cfg.bucket_slots)
    if _launch(packed, 0, 1, queries, cfg, False, out):
        (cand_launches_f64 if queries.dtype == torch.float64
         else cand_launches)[8] += 1
    return out


def knn_search_candidates_cuda_batched(packed: torch.Tensor,
                                       cfg: hm.MapConfig,
                                       queries: torch.Tensor,
                                       k: int = hm.NUM_MATCH_POINTS):
    """The candidates variant over a stream axis, as
    ``knn_search_cuda_batched``: stream s's five outputs what
    ``knn_search_candidates_cuda(packed[s], cfg, queries[s])`` returns."""
    _check_streams(packed, cfg, queries, k)
    out = empty_candidate_outputs(queries, k, 8 * cfg.bucket_slots)
    if _launch(packed, packed.stride(0), queries.shape[0], queries, cfg,
               False, out):
        (cand_batched_launches_f64 if queries.dtype == torch.float64
         else cand_batched_launches)[8] += 1
    return out


def _check_streams(packed, cfg, queries, k) -> None:
    """Raise ValueError on a batched launch's inputs the kernel does not
    take (``knn_search_cuda_batched``)."""
    if packed.dim() != 3 or queries.dim() != 3 or (
            packed.shape[0] != queries.shape[0]):
        raise ValueError(
            f"packed {tuple(packed.shape)} and queries "
            f"{tuple(queries.shape)} need one leading stream axis of a size")
    if packed.stride(0) % 4:
        raise ValueError("the maps must start 16-byte aligned (a stream "
                         "stride that is a multiple of 4 scalars)")
    check_inputs(packed[0], cfg, queries[0], k)
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")


def _launch(packed, map_stride: int, streams: int, queries, cfg, wide,
            out) -> bool:
    """The kernel over ``streams`` maps ``map_stride`` scalars apart, into
    ``out`` = (nbrs, sq, found), or with (nbrs, sq, found, cand_pts,
    cand_ok) its candidates variant.  Returns whether it launched (not for
    no query)."""
    H, B = cfg.num_buckets, cfg.bucket_slots
    N = queries.shape[-2]
    if N == 0 or streams == 0:
        return False
    f64 = queries.dtype == torch.float64
    rows = ring_rows(B, queries.element_size())
    span = (3 if wide else 2) * cfg.cell_size
    lib = _lib()
    _configure(queries.device.index)
    nbrs, sq, found = out[:3]
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (packed.data_ptr(), map_stride, streams, queries.data_ptr(),
                N, B, H - 1, float(cfg.cell_size), float(span))
        tail = (nbrs.data_ptr(), sq.data_ptr(), found.data_ptr())
        if len(out) == 5:
            search = (lib.knn_search_candidates_f64 if f64
                      else lib.knn_search_candidates_f32)
            err = search(*head, rows, *tail, out[3].data_ptr(),
                         out[4].data_ptr(), stream)
        else:
            search = lib.knn_search_f64 if f64 else lib.knn_search_f32
            err = search(*head, int(wide), rows, *tail, stream)
    if err != 0:
        raise RuntimeError(
            f"knn kernel launch failed: {lib.knn_error_string(err).decode()}")
    return True
