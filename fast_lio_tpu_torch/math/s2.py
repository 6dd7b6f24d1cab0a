"""S^2 manifold (gravity direction on a sphere of radius G).

Port of ``fast_lio_tpu/math/s2.py`` (the reference's S2.hpp:97-310 with
``S2_typ = 1``): a 3-vector of fixed length with a 2-DOF tangent space.

Deviation kept from the JAX package (PARITY.md deviation 2): ``mx`` includes
the exp factor that the reference's ``scalar(1/2)`` integer division drops
(S2.hpp:277).
"""
from __future__ import annotations

import torch

from .so3 import A_matrix, cross, hat, quat_rotate, quat_to_matrix, so3_exp

__all__ = ["bx", "boxplus", "boxminus", "nx_yy", "mx", "oplus"]

_TOL = 1e-11


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def bx(vec: torch.Tensor, length: float) -> torch.Tensor:
    """Tangent basis (…,3,2) at ``vec``; S2_typ=1 branch of S2.hpp:215-231,
    with the degenerate branch when vec ~ -length*e_x."""
    v0, v1, v2 = vec.unbind(-1)
    denom_raw = length + v0
    ok = denom_raw > _TOL
    denom = torch.where(ok, denom_raw, torch.ones_like(denom_raw))
    r0 = torch.stack([-v1, -v2], dim=-1)
    r1 = torch.stack([length - v1 * v1 / denom, -v2 * v1 / denom], dim=-1)
    r2 = torch.stack([-v2 * v1 / denom, length - v2 * v2 / denom], dim=-1)
    res = torch.stack([r0, r1, r2], dim=-2) / length
    # fill_ on views: assigning a Python number to a CUDA tensor's item
    # copies it from the host and synchronises
    degen = torch.zeros_like(res)
    degen[..., 1, 1].fill_(-1.0)
    degen[..., 2, 0].fill_(1.0)
    return torch.where(ok[..., None, None], res, degen)


def boxplus(vec: torch.Tensor, delta: torch.Tensor, length: float) -> torch.Tensor:
    """vec ⊞ delta: rotate vec by exp(Bx(vec) @ delta).  S2.hpp:136-142."""
    q = so3_exp(_matvec(bx(vec, length), delta))
    return quat_rotate(q, vec)


def oplus(vec: torch.Tensor, delta3: torch.Tensor, scale) -> torch.Tensor:
    """DIM-space retraction used by predict: rotate vec by exp(scale*delta3)
    (S2.hpp:129-134)."""
    return quat_rotate(so3_exp(delta3 * scale), vec)


def boxminus(vec: torch.Tensor, other: torch.Tensor, length: float) -> torch.Tensor:
    """(…,2) tangent difference this ⊟ other (S2.hpp:144-167), with the
    reference's antipodal/zero guards."""
    v_sin = torch.linalg.norm(cross(vec, other), dim=-1)
    v_cos = torch.sum(vec * other, dim=-1)
    theta = torch.atan2(v_sin, v_cos)
    safe_sin = torch.clamp_min(v_sin, _TOL)
    oxv = cross(other, vec)  # hat(other) @ vec
    general = (theta / safe_sin)[..., None] * _matvec(
        bx(other, length).transpose(-1, -2), oxv)
    degenerate = v_sin < _TOL
    antipodal = torch.abs(theta) > _TOL
    pi_res = torch.stack(
        [torch.full_like(theta, 3.1415926), torch.zeros_like(theta)], dim=-1)
    special = torch.where(antipodal[..., None], pi_res, torch.zeros_like(pi_res))
    return torch.where(degenerate[..., None], special, general)


def nx_yy(vec: torch.Tensor, length: float) -> torch.Tensor:
    """N(x, x): (…,2,3) = 1/len^2 * Bx^T hat(vec).  S2.hpp:259-264."""
    return bx(vec, length).transpose(-1, -2) @ hat(vec) / (length * length)


def mx(vec: torch.Tensor, delta: torch.Tensor, length: float) -> torch.Tensor:
    """M(x, delta): (…,3,2) derivative of boxplus wrt delta (S2.hpp:266-280):
    -exp(Bx delta) hat(vec) A(Bx delta)^T Bx, which is -hat(vec) Bx as
    delta -> 0.  Includes the exp factor (module docstring)."""
    Bx = bx(vec, length)
    Bu = _matvec(Bx, delta)
    small = torch.sum(delta * delta, dim=-1) < _TOL * _TOL
    simple = -(hat(vec) @ Bx)
    R = quat_to_matrix(so3_exp(Bu))
    At = A_matrix(Bu).transpose(-1, -2)
    general = -(R @ hat(vec) @ At @ Bx)
    return torch.where(small[..., None, None], simple, general)
