"""Voxel-grid downsample (centroid per voxel).

Port of ``fast_lio_tpu/ops/voxel_grid.py`` — the PCL ``VoxelGrid`` input
filter the reference applies to each deskewed scan
(laserMapping.cpp:117,813,904-905), for fixed shapes: sort points by integer
voxel key, mark segment heads, segment-sum positions/counts, emit a padded
(n_out, 3) block with a validity mask.

All three key paths of the JAX package are kept, with the same output order:

* one fused key when 3 * bits <= 30 (``coord_bound`` given);
* two keys when bits <= 15, sorted as the one int64 key ``hi << 32 | lo``
  (both keys are non-negative int32, so this is the lexsort order);
* the exact 3-key lexsort otherwise, as three stable sorts (z, y, x).

``jnp.argsort`` is stable, so every sort here is ``torch.sort(stable=True)``.
The sorted ``segment_sum``s and the division are one op,
``kernels.segment_sum.segment_mean``: on CPU tensors its plain version
(``index_add_``, which adds in index order there, as JAX's sorted
``segment_sum`` does: bit-equal to JAX), on CUDA tensors its kernel, which
sums each voxel in the same sorted order and so gives the same centroids on
every run (``index_add_`` on CUDA adds with atomics, in another order each
run).
"""
from __future__ import annotations

import math

import torch

from ..kernels.segment_sum import segment_mean


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def voxel_downsample(
    pts: torch.Tensor,  # (N, 3)
    mask: torch.Tensor,  # (N,) bool
    leaf: float,
    n_out: int,
    feats: torch.Tensor = None,  # optional (N,) extra channel (intensity)
    coord_bound: float = None,  # static |coordinate| bound enabling key fusion
):
    """Returns (centroids (n_out, 3), out_mask (n_out,)[, feats (n_out,)]).

    Voxels beyond n_out are dropped; masked inputs never contribute;
    ``feats`` is voxel-averaged alongside the positions.  With
    ``coord_bound`` the keys use a static origin and a per-point clamp, exact
    iff every unmasked point satisfies |coord| <= coord_bound (see the JAX
    package's docstring for the argument).
    """
    means, out_mask = segment_mean(
        *voxel_segments(pts, mask, leaf, n_out, feats, coord_bound), n_out)
    if feats is None:
        return means, out_mask
    return means[:, :3], out_mask, means[:, 3]


def voxel_segments(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                   n_out: int, feats: torch.Tensor = None,
                   coord_bound: float = None):
    """The points sorted by voxel key, as ``voxel_downsample`` sorts them:
    (cols (N, 3), or (N, 4) with ``feats``, live (N,), seg_id (N,) int64),
    the inputs of ``segment_mean``.  ``seg_id`` is each point's voxel in
    sorted order, monotone non-decreasing; dead points and the live ones
    past the ``n_out``-th voxel carry ``n_out``."""
    device = pts.device
    cell = torch.floor(pts / leaf).to(torch.int32)
    BIG = 2**30

    bits = 0
    if coord_bound is not None:
        half = math.ceil(coord_bound / leaf) + 1
        bits = max(1, math.ceil(math.log2(2 * half)))
    if coord_bound is not None and 3 * bits <= 30:
        rel = torch.clamp(cell + half, 0, (1 << bits) - 1).to(torch.int64)
        key = (rel[:, 0] << (2 * bits)) | (rel[:, 1] << bits) | rel[:, 2]
        key = torch.where(mask, key, torch.full_like(key, BIG))
        order = _stable_order(key)
        sk = key[order]
        change = sk[1:] != sk[:-1]
    elif coord_bound is not None and bits <= 15:
        rel = torch.clamp(cell + half, 0, (1 << bits) - 1).to(torch.int64)
        key_hi = (rel[:, 0] << bits) | rel[:, 1]
        key_lo = rel[:, 2]
        key_hi = torch.where(mask, key_hi, torch.full_like(key_hi, BIG))
        key_lo = torch.where(mask, key_lo, torch.full_like(key_lo, BIG))
        key = (key_hi << 32) | key_lo
        order = _stable_order(key)
        sk = key[order]
        change = sk[1:] != sk[:-1]
    else:
        big = torch.full_like(cell[:, 0], BIG)
        cx = torch.where(mask, cell[:, 0], big)
        cy = torch.where(mask, cell[:, 1], big)
        cz = torch.where(mask, cell[:, 2], big)
        # lexsort((cz, cy, cx)): stable passes from the least significant key
        order = _stable_order(cz)
        order = order[_stable_order(cy[order])]
        order = order[_stable_order(cx[order])]
        sx, sy, sz = cx[order], cy[order], cz[order]
        change = (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1]) | (sz[1:] != sz[:-1])
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=device), change])
    pts_s = pts[order]
    live_s = mask[order]
    is_first = is_first & live_s
    seg_id = torch.cumsum(is_first.to(torch.int32), dim=0) - 1  # (N,) 0-based
    # dead points -> overflow segment
    seg_id = torch.where(live_s, torch.clamp_max(seg_id, n_out),
                         torch.full_like(seg_id, n_out)).to(torch.int64)

    cols = pts_s if feats is None else torch.cat(
        [pts_s, feats[order][:, None].to(pts.dtype)], dim=-1)
    return cols, live_s, seg_id
