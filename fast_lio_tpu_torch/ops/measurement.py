"""Point-to-plane measurement model — the ``h_share_model`` analog.

Port of ``fast_lio_tpu/ops/measurement.py`` (laserMapping.cpp:638-754): one
batched pass over a fixed-size padded point block —

* body->world transform by quaternion rotation (laserMapping.cpp:656-661);
* convergence-gated kNN re-search with cached neighborhoods and plane fits
  (laserMapping.cpp:667-672): ``control_flow.gate(converge, research,
  cache)``, the counterpart of JAX's ``lax.cond`` with no host read: in the
  single pipeline's captured step a CUDA-graph IF node that runs the search
  and the fit only where ``converge`` holds; in the masked form they run on
  every call and ``torch.where`` keeps the cache where it does not;
* plane fit + robust gate s = 1 - 0.9 |pd2| / sqrt(|p|) > 0.9
  (laserMapping.cpp:678-691);
* no compaction: the effective-point set is a row mask, since H^T H and
  H^T h are the only consumers downstream.

H row layout (laserMapping.cpp:737-748):
    [ n^T,  (hat(R_ext p + t_ext) R^T n)^T,  (hat(p) R_ext^T R^T n)^T,
      (R^T n)^T ]
with the extrinsic columns zeroed when extrinsic estimation is off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import control_flow as cf
from .. import state as st
from ..map import hash_map as hm
from ..math import so3
from .plane_fit import fit_plane

NUM_MATCH = hm.NUM_MATCH_POINTS
MAX_NN_SQ_DIST = 5.0  # 5th-NN gate, m^2 (laserMapping.cpp:671)
PLANE_THRESHOLD = 0.1  # plane residual gate, m (laserMapping.cpp:678)
ROBUST_S_GATE = 0.9  # acceptance on s (laserMapping.cpp:683)


class NeighborCache(NamedTuple):
    """Per-point association state persisted across filter iterations
    (Nearest_Points / point_selected_surf, laserMapping.cpp:101,94), with the
    fitted planes cached too (a plane depends only on its neighbors)."""

    nbrs: torch.Tensor  # (N, K, 3)
    found: torch.Tensor  # (N, K)
    selected: torch.Tensor  # (N,)
    pabcd: torch.Tensor  # (N, 4) cached plane fits
    plane_ok: torch.Tensor  # (N,)


def empty_cache(n: int, dtype=torch.float32, device=None) -> NeighborCache:
    return NeighborCache(
        nbrs=torch.zeros((n, NUM_MATCH, 3), dtype=dtype, device=device),
        found=torch.zeros((n, NUM_MATCH), dtype=torch.bool, device=device),
        selected=torch.zeros(n, dtype=torch.bool, device=device),
        pabcd=torch.zeros((n, 4), dtype=dtype, device=device),
        plane_ok=torch.zeros(n, dtype=torch.bool, device=device),
    )


def body_to_world(x: st.State, pts_body: torch.Tensor) -> torch.Tensor:
    """p_w = R (R_ext p + t_ext) + pos, by quaternion rotation (elementwise,
    full precision; no matmul touches the coordinates)."""
    p_imu = so3.quat_rotate(x.offset_R_L_I, pts_body) + x.offset_T_L_I
    return so3.quat_rotate(x.rot, p_imu) + x.pos


def compute_measurement(
    x: st.State,
    pts_body: torch.Tensor,  # (N, 3) deskewed, LiDAR frame
    mask: torch.Tensor,  # (N,) live points
    knn_fn,  # (queries (N,3), mask (N,)) -> (nbrs (N,K,3), sq (N,K), found)
    cache: NeighborCache,
    converge: torch.Tensor,  # () bool: the re-search's result is kept
    extrinsic_est: bool = True,
    row_mask: torch.Tensor = None,  # optional extra mask on H rows
):
    """One h_share_model evaluation.  Returns (h_x, h, rows, cache', valid,
    p_world) with h_x (N, 12), h = -pd2 (N,), ``valid`` a () bool tensor.

    The re-search (kNN and plane fit) is ``control_flow.gate(converge, ...,
    cache)``: where ``converge`` is False the cache is kept, bit for bit
    (in a gated capture the search does not run, and the cache's tensors
    are written in place where it does)."""
    dtype = pts_body.dtype
    p_world = body_to_world(x, pts_body)

    def research(_cache):
        nbrs, sq, found = knn_fn(p_world, mask)
        all_found = torch.all(found, dim=-1)
        close = sq[:, NUM_MATCH - 1] <= MAX_NN_SQ_DIST
        selected = all_found & close & mask
        pabcd, plane_ok = fit_plane(nbrs, found, PLANE_THRESHOLD)
        return NeighborCache(nbrs.to(dtype), found, selected,
                             pabcd.to(dtype), plane_ok)

    cache = cf.gate(converge, research, cache)

    pabcd, plane_ok = cache.pabcd, cache.plane_ok
    pd2 = torch.sum(pabcd[:, :3] * p_world, dim=-1) + pabcd[:, 3]
    body_norm = torch.linalg.norm(pts_body, dim=-1)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.clamp_min(body_norm, 1e-9))
    gate = plane_ok & (s > ROBUST_S_GATE)
    sel = cache.selected & gate

    norm_vec = pabcd[:, :3]
    C = so3.quat_rotate(so3.quat_conjugate(x.rot), norm_vec)  # R^T n
    p_imu = so3.quat_rotate(x.offset_R_L_I, pts_body) + x.offset_T_L_I
    A = so3.cross(p_imu, C)  # hat(p_imu) @ C
    if extrinsic_est:
        # hat(p_be) @ (R_ext^T C)
        B = so3.cross(pts_body, so3.quat_rotate(
            so3.quat_conjugate(x.offset_R_L_I), C))
    else:
        B = torch.zeros_like(A)
    h_x = torch.cat([norm_vec, A, B, C], dim=-1)  # (N, 12)
    h = -pd2

    rows = sel if row_mask is None else sel & row_mask
    h_x = h_x * rows[:, None].to(dtype)
    h = h * rows.to(dtype)

    new_cache = cache._replace(selected=sel)
    valid = torch.any(sel)
    return h_x, h, rows, new_cache, valid, p_world
