"""Incremental voxel-hash map — the replacement for ikd-Tree.

Port of ``fast_lio_tpu/map/hash_map.py``.  The map is a fixed-capacity
bucketed spatial hash in one device tensor:

* storage: ``packed (H, 4B)`` — H hash buckets of B slots in planar row
  layout ``[x(B) | y(B) | z(B) | w(B)]``.  The w channel encodes validity as
  a distance penalty (0.0 = live, 1e18 = free slot), so a candidate's masked
  squared distance is ``dx^2+dy^2+dz^2+w``.  A point lives in the bucket of
  its storage cell (side ``cell_size``).
* kNN = the 2x2x2 cell region nearest the query (round-to-corner) or the
  centered 3x3x3 region (wide), masked top-k, hash collisions filtered by the
  region's bounding box.  ``knn_search`` here is the plain PyTorch version of
  the CUDA kernel in ``csrc/knn.cu``; the pipeline calls the kernel's wrapper,
  ``kernels.knn.knn_search``, which runs this function on CPU tensors.
* insert = masked scatter with the reference's spatial hysteresis
  (``map_incremental``, laserMapping.cpp:427-474) and ikd-Tree's
  keep-nearest-to-voxel-center downsample semantics.
* delete = the sliding local-map cube as one masked w-channel pass.

Unlike the JAX package (pure functions over donated buffers), ``insert`` and
``prune_outside`` update ``Map.packed`` in place: the map is the one large
tensor of the system (32-64 MB at the presets), and a copy per scan would
double its traffic.

The dump row: ``make_map`` allocates one row more than the H buckets, the
map carries that ``(H + 1, 4B)`` tensor as ``Map.rows``, and ``Map.packed``
is the view of its first H rows.  The insert's scatter writes the rows it
masks off into the trailing row, the counterpart of JAX's ``mode="drop"``
(torch's ``index_put_`` has no such mode), so it writes through a
fixed-size index with no host read.  Nothing reads the dump row: not
``map_size``, not the kNN kernels (they address H buckets), not the
checkpoints (they save ``packed``).  ``from_packed`` builds a map with the
row from any ``(H, 4B)`` tensor.

Every function of the per-scan step here runs under ``torch.func.vmap``
(the batched step of ``batch.BatchPipeline``, over maps stacked on a
leading stream axis): no in-place write lands in a tensor made inside the
step unless the written values are made from it alone, and the map's rows
are a tensor the map carries, not storage reached through a view.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import control_flow as cf

NUM_MATCH_POINTS = 5  # common_lib.h:26

W_FREE = 1.0e18  # w-channel value of a free slot; d2 >= 1e18 => not a point
W_VALID_MAX = 1.0e17  # found threshold on returned squared distances
_OOB = 1.0e18  # distance penalty for candidates outside the search region


class MapConfig(NamedTuple):
    h_log2: int = 14  # 16384 buckets
    bucket_slots: int = 64  # B; capacity = 2^h_log2 * B points
    cell_size: float = 2.0  # storage-cell side (m), an integer multiple of
    # voxel_size so every downsample voxel nests in exactly one cell
    voxel_size: float = 0.5  # map downsample voxel (filter_size_map_min)

    @property
    def num_buckets(self):
        return 1 << self.h_log2

    @property
    def row_width(self):
        """Floats in one packed row: the planar [x|y|z|w] channels."""
        return 4 * self.bucket_slots

    @property
    def knn_candidates(self):
        """Candidate rows materialized per query by knn_search."""
        return 8 * self.bucket_slots


def make_config(voxel_size: float, h_log2: int = 14,
                bucket_slots: int = None,
                cell_multiplier: int = 4) -> MapConfig:
    """Storage cell = cell_multiplier x map voxel; default slot count is
    cell_multiplier^3 rounded up to a multiple of 64, so a fully
    downsample-populated cell never overflows its bucket."""
    if bucket_slots is None:
        bucket_slots = max(64, -(-cell_multiplier**3 // 64) * 64)
    return MapConfig(
        h_log2=h_log2,
        bucket_slots=bucket_slots,
        cell_size=float(cell_multiplier) * voxel_size,
        voxel_size=voxel_size,
    )


class Map(NamedTuple):
    packed: torch.Tensor  # (H, 4B) planar rows [x|y|z|w]
    dropped: torch.Tensor  # () int32, points lost to bucket overflow
    rows: Optional[torch.Tensor] = None  # (H + 1, 4B): packed and the dump
    # row after it (packed is rows[:H]); None for a map insert cannot take


def make_map(cfg: MapConfig, dtype=torch.float32, device=None) -> Map:
    """An empty map: ``packed`` (H, 4B) is the view of the first H rows of
    an (H + 1, 4B) tensor whose last row is the insert's dump row."""
    H, B = cfg.num_buckets, cfg.bucket_slots
    rows = torch.zeros((H + 1, 4 * B), dtype=dtype, device=device)
    rows[:, 3 * B:] = W_FREE
    return Map(packed=rows[:H],
               dropped=torch.zeros((), dtype=torch.int32, device=device),
               rows=rows)


def from_packed(packed: torch.Tensor, dropped: torch.Tensor) -> Map:
    """A map with a dump row holding a copy of ``packed`` (H, 4B) and
    ``dropped`` (any shape): what ``insert`` takes from a saved or cloned
    table."""
    H, W = packed.shape
    rows = torch.empty((H + 1, W), dtype=packed.dtype, device=packed.device)
    rows[:H] = packed
    rows[H] = 0.0
    return Map(packed=rows[:H], dropped=dropped.clone(), rows=rows)


def channels(m: Map, cfg: MapConfig = None):
    """(x, y, z, w) channel views of the packed rows, each (H, B)."""
    B = m.packed.shape[-1] // 4
    p = m.packed
    return p[:, :B], p[:, B:2 * B], p[:, 2 * B:3 * B], p[:, 3 * B:]


def valid_mask(m: Map, cfg: MapConfig = None) -> torch.Tensor:
    """(H, B) live-slot mask."""
    return channels(m)[3] == 0.0


def map_size(m: Map, cfg: MapConfig = None) -> torch.Tensor:
    """Live point count (the ikd-Tree ``validnum`` analog), a device scalar."""
    return torch.sum(valid_mask(m), dtype=torch.int64)


def points(m: Map, cfg: MapConfig = None) -> torch.Tensor:
    """(H, B, 3) slot coordinates, live or not, on the map's device."""
    x, y, z, _ = channels(m)
    return torch.stack([x, y, z], dim=-1)


def flatten(m: Map, cfg: MapConfig = None) -> np.ndarray:
    """All live map points as a host array (n, 3) (ikd-Tree ``flatten``)."""
    p = m.packed.detach().cpu().numpy()
    B = p.shape[-1] // 4
    pts = np.stack([p[:, :B], p[:, B:2 * B], p[:, 2 * B:3 * B]], axis=-1)
    ok = p[:, 3 * B:] == 0.0
    return pts.reshape(-1, 3)[ok.reshape(-1)]


# --------------------------------------------------------------------------
# hashing
# --------------------------------------------------------------------------

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes
_M32 = 0xFFFFFFFF


def _cell_of(pts: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor(pts / cell_size).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 0 <= h, c < 2^32 in int64 without overflow."""
    lo = (h * (c & 0xFFFF)) & _M32
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def cell_hash(cell: torch.Tensor) -> torch.Tensor:
    """Raw 32-bit spatial hash of integer cell coords (…, 3) -> (…,), as
    int64 holding the JAX package's int32 value (bit-identical).

    Prime-multiply XOR + murmur3-style avalanche.  Computed in int64 and
    masked to 32 bits: that reproduces the int32 wraparound of the prime
    products and the logical shifts on the uint32 view."""
    c = cell.to(torch.int64)
    h = ((c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return torch.where(h >= 2**31, h - 2**32, h)


def _bucket_of(cell: torch.Tensor, h_log2: int) -> torch.Tensor:
    return cell_hash(cell) & ((1 << h_log2) - 1)


# --------------------------------------------------------------------------
# kNN search (plain version of csrc/knn.cu)
# --------------------------------------------------------------------------

_NEIGHBOR_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
    dtype=np.int32,
)  # (8, 3) — the 2x2x2 region above the round-to-corner base cell

_WIDE_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)],
    dtype=np.int32,
)  # (27, 3) — centered 3x3x3 region (wide / sparse-regime mode)


def region_base(queries: torch.Tensor, cfg: MapConfig,
                wide: bool = False) -> torch.Tensor:
    """(N, 3) int32 base cell of each query's search region."""
    return torch.floor(queries / cfg.cell_size - (1.0 if wide else 0.5)).to(
        torch.int32)


def region_cells(queries: torch.Tensor, cfg: MapConfig, wide: bool = False):
    """Search-region cells per query: (base (N,3), cells (N,R,3), n_cells).

    Standard: round-to-corner 2x2x2 (coverage radius cell_size/2).
    Wide: centered 3x3x3 (coverage radius cell_size)."""
    base = region_base(queries, cfg, wide)
    off = _region_offsets(wide, queries.device)
    return base, base[:, None, :] + off[None], off.shape[0]


@functools.lru_cache(maxsize=None)
def _region_offsets(wide: bool, device: torch.device) -> torch.Tensor:
    """The region's cell offsets (R, 3) int32, made once per device: no
    host-to-device copy per search (none may run inside a CUDA graph)."""
    offsets = (_WIDE_OFFSETS + 1) if wide else _NEIGHBOR_OFFSETS
    return torch.as_tensor(offsets, device=device)


def dedup_buckets(buckets: torch.Tensor, sentinel: int):
    """Sort each query's bucket list and point duplicates at ``sentinel``.
    Returns (buckets', dup_mask), both in sorted order."""
    b_sorted = torch.sort(buckets, dim=-1).values
    dup = torch.cat(
        [torch.zeros_like(b_sorted[:, :1], dtype=torch.bool),
         b_sorted[:, 1:] == b_sorted[:, :-1]], dim=-1)
    return torch.where(dup, torch.full_like(b_sorted, sentinel), b_sorted), dup


def smallest_k(d2: torch.Tensor, k: int):
    """Exact k-smallest along the last axis: (vals (..., k) ascending,
    idx (..., k) int64), ties to the lowest index (k min-sweeps)."""
    d = d2
    vals, idxs = [], []
    for _ in range(k):
        v, i = torch.min(d, dim=-1)  # first minimal index on ties
        vals.append(v)
        idxs.append(i)
        # out of place: vmap has no rule for the in-place scatter_
        d = d.scatter(-1, i[..., None], torch.inf)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def region_bounds(base: torch.Tensor, cfg: MapConfig, n_side: int):
    """Half-open AABB [lo, hi) of an n_side^3 cell region starting at base,
    in f32 as the JAX package computes it."""
    lo = base.to(torch.float32) * cfg.cell_size
    hi = lo + n_side * cfg.cell_size
    return lo, hi


def knn_search(m: Map, cfg: MapConfig, queries: torch.Tensor,
               k: int = NUM_MATCH_POINTS, wide: bool = False,
               return_candidates: bool = False):
    """k nearest map points per query — the plain version of csrc/knn.cu.

    queries: (N, 3).  Returns (neighbors (N, k, 3), sq_dists (N, k) with +inf
    for missing, found_mask (N, k)).  Exact within the covered neighborhood;
    candidates are ordered by sorted bucket id, then slot, and ties go to the
    lowest candidate index.  With ``return_candidates`` it also returns the
    gathered candidate block (N, R*B, 3) and its live mask (N, R*B), which
    ``rescore_candidates`` re-ranks."""
    base, cells, _R = region_cells(queries, cfg, wide)
    buckets, dup_mask = dedup_buckets(
        _bucket_of(cells, cfg.h_log2), cfg.num_buckets - 1)
    return search_rows(m, cfg, queries, base, buckets, dup_mask, k, wide,
                       return_candidates)


def search_rows(m: Map, cfg: MapConfig, queries: torch.Tensor,
                base: torch.Tensor, buckets: torch.Tensor,
                dup_mask: torch.Tensor, k: int = NUM_MATCH_POINTS,
                wide: bool = False, return_candidates: bool = False):
    """Top-k of each query over the bucket rows ``buckets`` (N, R), sorted,
    with the rows flagged in ``dup_mask`` skipped, keeping only candidates
    inside the half-open AABB of the region at ``base`` (N, 3).  The math of
    ``knn_search``, which passes each query's own region; the grouped search
    passes its group head's rows."""
    B = cfg.bucket_slots
    N, R = buckets.shape
    rows = m.packed[buckets.reshape(-1)].reshape(N, R, 4 * B)
    cx = rows[:, :, 0 * B:1 * B].reshape(N, R * B)
    cy = rows[:, :, 1 * B:2 * B].reshape(N, R * B)
    cz = rows[:, :, 2 * B:3 * B].reshape(N, R * B)
    cw = rows[:, :, 3 * B:4 * B].reshape(N, R * B)

    d2 = ((cx - queries[:, None, 0]) ** 2 + (cy - queries[:, None, 1]) ** 2
          + (cz - queries[:, None, 2]) ** 2 + cw)
    lo, hi = region_bounds(base, cfg, 3 if wide else 2)
    oob = ((cx < lo[:, None, 0]) | (cx >= hi[:, None, 0])
           | (cy < lo[:, None, 1]) | (cy >= hi[:, None, 1])
           | (cz < lo[:, None, 2]) | (cz >= hi[:, None, 2]))
    kill = oob | dup_mask.repeat_interleave(B, dim=-1)
    d2 = torch.where(kill, torch.full_like(d2, _OOB), d2)

    sq, idx = smallest_k(d2, k)
    found = sq < W_VALID_MAX
    nbrs = torch.stack([torch.take_along_dim(c, idx, dim=1)
                        for c in (cx, cy, cz)], dim=-1)
    sq = torch.where(found, sq, torch.full_like(sq, torch.inf))
    if return_candidates:
        cand_pts = torch.stack([cx, cy, cz], dim=-1)
        return nbrs, sq, found, cand_pts, ~kill & (cw == 0.0)
    return nbrs, sq, found


def rescore_candidates(cand_pts: torch.Tensor, cand_ok: torch.Tensor,
                       queries: torch.Tensor, k: int = NUM_MATCH_POINTS):
    """Re-rank cached candidates (N, C, 3) with live mask (N, C) at new
    query positions (N, 3), with no map gather: the converged-iteration
    re-search of ``Config.rescore_research`` (the pose moves millimetres
    between Gauss-Newton iterates, so the first search's region still
    covers the true kNN).  Returns (nbrs, sq, found) as ``knn_search``."""
    d2 = torch.sum((cand_pts - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(cand_ok, d2, torch.full_like(d2, torch.inf))
    sq, idx = smallest_k(d2, k)
    nbrs = torch.take_along_dim(cand_pts, idx[..., None], dim=1)
    return nbrs, sq, torch.isfinite(sq)


# --------------------------------------------------------------------------
# insertion with spatial hysteresis
# --------------------------------------------------------------------------


def _sqnorm3(v: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 over the last axis, summed left to right."""
    return v[..., 0] ** 2 + v[..., 1] ** 2 + v[..., 2] ** 2


def _voxel_center(p: torch.Tensor, voxel: float) -> torch.Tensor:
    return torch.floor(p / voxel) * voxel + 0.5 * voxel


def insert_decisions(
    pts_world: torch.Tensor,  # (N, 3)
    mask: torch.Tensor,  # (N,) live scan points
    nearest: torch.Tensor,  # (N, k, 3) cached 5-NN from the update loop
    nearest_found: torch.Tensor,  # (N, k)
    ekf_inited,  # bool or () bool tensor
    voxel: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map_incremental policy (laserMapping.cpp:433-467).

    Returns (add_mask, downsample_flag):
      * no neighbors / not inited        -> add, with downsample
      * nearest NN outside the voxel on every axis -> add, NO downsample
      * any of the 5 NN nearer to the voxel center -> skip
      * otherwise                        -> add, with downsample
    """
    mid = _voxel_center(pts_world, voxel)
    dist = _sqnorm3(pts_world - mid)
    have_nbrs = nearest_found[:, 0] & ekf_inited
    nn0 = nearest[:, 0, :]
    far_all_axes = torch.all(torch.abs(nn0 - mid) > 0.5 * voxel, dim=-1)
    nbr_d = _sqnorm3(nearest - mid[:, None, :])
    nbr_d = torch.where(nearest_found, nbr_d, torch.full_like(nbr_d, torch.inf))
    all_found = torch.all(nearest_found, dim=-1)
    blocked = all_found & torch.any(nbr_d < dist[:, None], dim=-1)
    add = torch.where(have_nbrs, far_all_axes | ~blocked, True)
    downsample = torch.where(have_nbrs, ~far_all_axes, True)
    return add & mask, downsample


def insert(
    m: Map,
    cfg: MapConfig,
    pts: torch.Tensor,  # (N, 3) world-frame candidates
    add_mask: torch.Tensor,  # (N,)
    downsample: torch.Tensor,  # (N,) per-point flag
) -> Map:
    """Masked scatter insert (the ``Add_Points`` analog), in place on
    ``m.packed``.

    Downsample-on points keep at most one point per map voxel, preferring the
    one nearest the voxel center.  Bucket-full points are dropped and counted.
    Same algorithm as the JAX package: one stable sort of two int32 keys
    (bucket | rel_x, rel_y | rel_z; 15 bits per axis) serves both the
    per-voxel dedup (segment min of d_mid) and the per-bucket append ranks.
    Every point is scattered: those that write nothing go to the map's dump
    row (see the module docstring), so no host read sizes the scatter.
    """
    if cfg.h_log2 > 15:
        raise ValueError(
            f"insert key layout requires h_log2 <= 15 (got {cfg.h_log2})")
    N = pts.shape[0]
    H, B = cfg.num_buckets, cfg.bucket_slots
    W = 4 * B
    dev = pts.device
    dtype = m.packed.dtype
    i32 = torch.int32

    vox = _cell_of(pts, cfg.voxel_size)  # (N,3) int voxel coords
    mid = _voxel_center(pts, cfg.voxel_size)
    d_mid = _sqnorm3(pts - mid)

    live_ds = add_mask & downsample
    ref = torch.min(torch.where(add_mask[:, None], vox,
                                torch.full_like(vox, 2**30)), dim=0).values
    rel = torch.clamp(vox - ref, 0, 32766)
    GUARD = 32767
    bucket = _bucket_of(_cell_of(pts, cfg.cell_size), cfg.h_log2)  # (N,) int64

    bucket_key = torch.where(add_mask, bucket, torch.full_like(bucket, H))
    rel = rel.to(torch.int64)
    key_hi = (bucket_key << 15) | torch.where(live_ds, rel[:, 0],
                                              torch.full_like(rel[:, 0], GUARD))
    key_lo = torch.where(live_ds, (rel[:, 1] << 15) | rel[:, 2],
                         torch.full_like(rel[:, 1], (GUARD << 15) | GUARD))
    # lexsort((key_lo, key_hi)): both non-negative int32 -> one int64 key
    order = torch.sort((key_hi << 32) | key_lo, stable=True).indices
    shi, slo = key_hi[order], key_lo[order]
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_first = torch.cat([true1, (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    dmid_s = d_mid[order]
    vox_seg = torch.cumsum(is_first.to(i32), dim=0).to(torch.int64) - 1
    seg_min = torch.full_like(dmid_s, torch.inf).scatter_reduce(
        0, vox_seg, dmid_s, reduce="amin", include_self=False)
    elig = dmid_s == seg_min[vox_seg]
    elig_i = elig.to(i32)
    ex_elig = torch.cumsum(elig_i, dim=0, dtype=i32) - elig_i
    elig_base = torch.cummax(
        torch.where(is_first, ex_elig, torch.zeros_like(ex_elig)), dim=0).values
    first_elig = elig & (ex_elig == elig_base)
    winner_sorted = first_elig & live_ds[order]
    winner = torch.zeros_like(winner_sorted).scatter(0, order, winner_sorted)
    live = winner | (add_mask & ~downsample)

    # ---- per-candidate bucket + slot inspection --------------------------
    rows = m.packed[bucket]  # (N, W)
    sx, sy, sz = rows[:, :B], rows[:, B:2 * B], rows[:, 2 * B:3 * B]
    slot_ok = rows[:, 3 * B:] == 0.0  # (N, B) occupied

    same_vox = (
        (torch.floor(sx / cfg.voxel_size).to(i32) == vox[:, None, 0])
        & (torch.floor(sy / cfg.voxel_size).to(i32) == vox[:, None, 1])
        & (torch.floor(sz / cfg.voxel_size).to(i32) == vox[:, None, 2])
        & slot_ok
    )
    has_same = torch.any(same_vox, dim=-1)
    # torch.argmax refuses bool: cast (first maximal index, as jnp.argmax)
    same_slot = torch.argmax(same_vox.to(torch.uint8), dim=-1)

    slot_mid_d = ((sx - mid[:, None, 0]) ** 2 + (sy - mid[:, None, 1]) ** 2
                  + (sz - mid[:, None, 2]) ** 2)
    existing_d = torch.take_along_dim(slot_mid_d, same_slot[:, None], dim=1)[:, 0]

    is_ds = live & downsample
    do_replace = is_ds & has_same & (d_mid < existing_d)
    do_append = live & ~(is_ds & has_same)

    # ---- append slot: rank among appenders within the bucket, from the same
    # sorted order (segmented exclusive cumsum)
    sb = shi >> 15  # bucket_key recovered from the sorted high key
    first_b = torch.cat([true1, sb[1:] != sb[:-1]])
    flag = do_append[order].to(i32)
    ex_cumsum = torch.cumsum(flag, dim=0, dtype=i32) - flag
    seg_base = torch.cummax(
        torch.where(first_b, ex_cumsum, torch.zeros_like(ex_cumsum)), dim=0).values
    rank_sorted = ex_cumsum - seg_base
    rank = torch.zeros_like(rank_sorted).scatter(0, order, rank_sorted)

    # rank-th free slot: first position where the inclusive free-count
    # cumsum reaches rank+1
    free = ~slot_ok
    free_cum = torch.cumsum(free.to(i32), dim=-1, dtype=i32)  # (N, B)
    free_count = free_cum[:, -1]
    app_ok = do_append & (rank < free_count)
    app_slot = torch.argmax(
        (free & (free_cum == (rank + 1)[:, None])).to(torch.uint8), dim=-1)
    overflow = torch.sum(do_append & (rank >= free_count), dtype=i32)

    # ---- scatter: replace and append are disjoint, and every written slot
    # is distinct, so one flat index_put of (x, y, z, w=0) per point; the
    # points that write nothing all land in the dump row at H * W
    write_on = do_replace | app_ok
    write_slot = torch.where(do_replace, same_slot, app_slot)
    base = torch.where(write_on, bucket * W + write_slot, H * W)
    idx = torch.stack([base, base + B, base + 2 * B, base + 3 * B], -1)
    p_all = pts.to(dtype)
    vals = torch.cat([p_all, torch.zeros_like(p_all[:, :1])], dim=-1)
    if m.rows is None:
        raise ValueError("the map has no dump row after its buckets: build "
                         "it with make_map or from_packed")
    m.rows.view(-1)[idx.reshape(-1)] = vals.reshape(-1)
    return m._replace(dropped=m.dropped + overflow)


# --------------------------------------------------------------------------
# deletion (sliding local map)
# --------------------------------------------------------------------------


def prune_outside(m: Map, lo: torch.Tensor, hi: torch.Tensor,
                  active: torch.Tensor = None) -> Map:
    """Invalidate every point outside the box [lo, hi], in place.

    Pruning to the *new* cube replaces the vacated-slab ``Delete_Point_Boxes``
    bookkeeping (laserMapping.cpp:254-275).  ``active`` (a () bool tensor)
    gates the whole pass without a host read, the JAX step's ``lax.cond``:
    with it False the map is unchanged.  The pass is
    ``control_flow.gate(active, ...)`` on the map's weight column as its
    carry: in a gated capture an IF node prunes the map in place only where
    ``active`` holds; in the masked form the pruned or the old weights are
    written back.  None prunes unconditionally.
    """
    x, y, z, w = channels(m)

    def prune(carry):
        inside = ((x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
                  & (z >= lo[2]) & (z <= hi[2]))
        return (torch.where(inside, carry[0], torch.full_like(w, W_FREE)),)

    (pruned,) = (prune((w,)) if active is None
                 else cf.gate(active, prune, (w,)))
    if pruned is not w:  # not already written in place by an IF node
        w.copy_(pruned)
    return m
