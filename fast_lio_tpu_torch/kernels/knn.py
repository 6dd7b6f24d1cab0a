"""Wrapper of the hand-written CUDA kNN kernel (``csrc/knn.cu``).

Replaces the TPU kernel ``tools/knn_pallas.py::_kernel`` (its wrapper
``knn_search_pallas``, ``pallas_call`` at ``tools/knn_pallas.py:193``).  The
kernel computes exactly ``map.hash_map.knn_search`` — its plain version —
for the 2x2x2 region (R = 8) and the wide 3x3x3 region (R = 27).

Bound on an H100 SXM (3.35 TB/s): the bucket rows it must read,
N * R * 4B * 4 bytes, plus queries (12 N) and outputs (44 N): 67 MB / ~20 us
at the avia preset's N = 8192, R = 8, B = 64; 113 MB / ~34 us at the
ouster64 preset's partial-wide K_w = 2048, R = 27, B = 128.  This first
design (one warp per query, rows read one after another) is latency-bound on
those dependent row reads; see the source's header.

Routing: a CPU tensor goes to the plain version; a CUDA tensor always goes
to the kernel (which is built at first use), and anything the kernel does
not take raises.  ``launches`` counts kernel launches per R.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..map import hash_map as hm
from . import build

launches = {8: 0, 27: 0}


@functools.cache
def _lib():
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("knn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.knn_search_f32.argtypes = [p, p, i, i, ctypes.c_uint, f, f, i,
                                   p, p, p, p]
    lib.knn_search_f32.restype = i
    lib.knn_error_string.argtypes = [i]
    lib.knn_error_string.restype = ctypes.c_char_p
    return lib


def knn_search(m: hm.Map, cfg: hm.MapConfig, queries: torch.Tensor,
               k: int = hm.NUM_MATCH_POINTS, wide: bool = False):
    """(nbrs (N, k, 3), sq (N, k) with +inf where missing, found (N, k)).

    CPU tensors: the plain version, ``hash_map.knn_search``.  CUDA tensors:
    the kernel."""
    if queries.device.type == "cpu" and m.packed.device.type == "cpu":
        return hm.knn_search(m, cfg, queries, k=k, wide=wide)
    return knn_search_cuda(m.packed, cfg, queries, k=k, wide=wide)


def check_inputs(packed: torch.Tensor, cfg: hm.MapConfig,
                 queries: torch.Tensor, k: int) -> None:
    """Raise ValueError on anything the kNN kernels do not take."""
    H, B = cfg.num_buckets, cfg.bucket_slots
    if k != hm.NUM_MATCH_POINTS:
        raise ValueError(f"the kNN kernel is specialized to k=5 (got k={k})")
    for name, t in (("packed", packed), ("queries", queries)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


def empty_outputs(queries: torch.Tensor, k: int):
    """Uninitialised (nbrs (N, k, 3), sq (N, k), found (N, k)) on the
    queries' device, for a kernel to fill."""
    N, dev = queries.shape[0], queries.device
    return (torch.empty((N, k, 3), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.bool, device=dev))


def knn_search_cuda(packed: torch.Tensor, cfg: hm.MapConfig,
                    queries: torch.Tensor, k: int = hm.NUM_MATCH_POINTS,
                    wide: bool = False):
    """Launch the kernel on ``torch.cuda.current_stream()``; no sync."""
    check_inputs(packed, cfg, queries, k)
    H, B = cfg.num_buckets, cfg.bucket_slots
    nbrs, sq, found = empty_outputs(queries, k)
    N = queries.shape[0]
    if N == 0:
        return nbrs, sq, found

    R = 27 if wide else 8
    span = (3 if wide else 2) * cfg.cell_size
    lib = _lib()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_search_f32(
            packed.data_ptr(), queries.data_ptr(), N, B, H - 1,
            float(cfg.cell_size), float(span), int(wide),
            nbrs.data_ptr(), sq.data_ptr(), found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"knn kernel launch failed: {lib.knn_error_string(err).decode()}")
    launches[R] += 1
    return nbrs, sq, found
