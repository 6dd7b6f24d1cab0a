"""Batched 5-point plane fitting.

Port of ``fast_lio_tpu/ops/plane_fit.py`` (``esti_plane``,
common_lib.h:225-257): fit a plane to the NUM_MATCH_POINTS neighbors, return
unit normal + offset (pabcd), reject when any neighbor sits farther than
``threshold`` (0.1 m) from the plane.

Same design as the JAX package: the orthogonal-regression plane through the
neighborhood centroid (translation invariant, unlike the reference's
unit-RHS least squares), its normal from two inverse-iteration steps of
shifted adjugate solves seeded by an edge cross product; everything
elementwise over the K neighbor axis.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..math.so3 import cross


def _solve3x3_sym(M: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric 3x3 solve via adjugate.  Returns (x, det)."""
    a, d, g = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, h = M[..., 1, 1], M[..., 1, 2]
    i = M[..., 2, 2]
    c00 = e * i - h * h
    c01 = g * h - d * i
    c02 = d * h - e * g
    det = a * c00 + d * c01 + g * c02
    c11 = a * i - g * g
    c12 = d * g - a * h
    c22 = a * e - d * d
    inv_det = 1.0 / torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1), det


def fit_plane(neighbors: torch.Tensor, found: torch.Tensor,
              threshold: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """neighbors (N, K, 3), found (N, K) -> (pabcd (N, 4), ok (N,)).

    pabcd = (unit normal, offset): n . p + d ~ 0 across the K neighbors.  ok
    requires all K neighbors present, a non-degenerate neighborhood, and
    every neighbor within ``threshold`` of the plane (common_lib.h:249-255).
    """
    all_found = torch.all(found, dim=-1)
    centroid = torch.mean(neighbors, dim=-2)  # (N, 3)
    A = neighbors - centroid[:, None, :]
    ax, ay, az = A[..., 0], A[..., 1], A[..., 2]  # (N, K)

    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    xx, xy, xz = dot(ax, ax), dot(ax, ay), dot(ax, az)
    yy, yz, zz = dot(ay, ay), dot(ay, az), dot(az, az)
    AtA = torch.stack([
        torch.stack([xx, xy, xz], -1),
        torch.stack([xy, yy, yz], -1),
        torch.stack([xz, yz, zz], -1),
    ], dim=-2)  # (N, 3, 3)

    # seed normal: cross of two neighborhood edges
    e1 = neighbors[:, 1, :] - neighbors[:, 0, :]
    e2 = neighbors[:, 2, :] - neighbors[:, 0, :]
    seed = cross(e1, e2)
    seed_norm = torch.linalg.norm(seed, dim=-1)
    n_vec = seed / torch.where(seed_norm > 1e-20, seed_norm,
                               torch.ones_like(seed_norm))[:, None]

    # inverse iteration toward the smallest eigenvector of AtA
    trace = AtA[..., 0, 0] + AtA[..., 1, 1] + AtA[..., 2, 2]
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    M = AtA + (1e-6 * trace + 1e-12)[..., None, None] * eye
    for _ in range(2):
        n_vec, _det = _solve3x3_sym(M, n_vec)
        nn = torch.linalg.norm(n_vec, dim=-1, keepdim=True)
        n_vec = n_vec / torch.where(nn > 1e-20, nn, torch.ones_like(nn))

    d = -torch.sum(n_vec * centroid, dim=-1)
    pabcd = torch.cat([n_vec, d[:, None]], dim=-1)

    res = torch.abs(torch.sum(neighbors * n_vec[:, None, :], dim=-1) + d[:, None])
    ok_res = torch.all(res <= threshold, dim=-1)
    ok_geom = (seed_norm > 1e-12) & (trace > 1e-12)
    return pabcd, all_found & ok_geom & ok_res
