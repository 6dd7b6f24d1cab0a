"""SO(3) primitives: quaternion exp/log, skew, rotation Jacobians.

Port of ``fast_lio_tpu/math/so3.py`` (the reference's so3_math.h:9-109 and
IKFoM's mtkmath.hpp:142-288, SOn.hpp:233-297).  Functions take tensors whose
leading dimensions broadcast, so one code path serves a single state and the
batched per-point transforms.

Quaternion convention: ``(w, x, y, z)`` (scalar first).

The small-angle branches keep the JAX package's ``_SMALL`` Taylor guards
(both branches computed on sanitized inputs, then selected), and ``so3_log``
uses ``atan`` so that q and -q map to the same rotation vector.
"""
from __future__ import annotations

import torch

__all__ = [
    "hat",
    "quat_identity",
    "quat_multiply",
    "quat_conjugate",
    "quat_normalize",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "so3_exp",
    "so3_log",
    "so3_exp_matrix",
    "A_matrix",
    "quat_to_euler_deg",
]

_SMALL = 1e-8  # squared-angle Taylor switch; safe for f32 and f64


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Cast both to their common float dtype (jnp promotes implicitly)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis (jnp.cross)."""
    a, b = _promote(a, b)
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v (..., 3) -> (..., 3, 3) (MTK::hat)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w,x,y,z) convention; broadcasts over leading dims."""
    q1, q2 = _promote(q1, q2)
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q.  Broadcasts leading dims.

    Uses the 15-mul form r = v + 2*w*(u x v) + 2*(u x (u x v)).
    """
    q, v = _promote(q, v)
    u = q[..., 1:4]
    w = q[..., 0:1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(…,4) quaternion -> (…,3,3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Robust (Shepperd) rotation-matrix -> quaternion, branch-free: the
    candidate seeded by the largest of (trace, R00, R11, R22) is kept."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22
    q0 = torch.stack([1.0 + tr, r21 - r12, r02 - r20, r10 - r01], -1)
    q1 = torch.stack([r21 - r12, 1.0 + r00 - r11 - r22, r01 + r10, r02 + r20], -1)
    q2 = torch.stack([r02 - r20, r01 + r10, 1.0 - r00 + r11 - r22, r12 + r21], -1)
    q3 = torch.stack([r10 - r01, r02 + r20, r12 + r21, 1.0 - r00 - r11 + r22], -1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    best = torch.argmax(torch.stack([tr, r00, r11, r22], -1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.take_along_dim(cands, idx, dim=-2)[..., 0, :]
    return quat_normalize(q)


def _cos_sinc_half(theta2: torch.Tensor):
    """cos(t/2) and sin(t/2)/t for t = sqrt(theta2), Taylor-guarded
    (MTK::exp with scale 1/2, mtkmath.hpp:249-256)."""
    safe2 = torch.clamp_min(theta2, _SMALL)
    t = torch.sqrt(safe2)
    cos_exact = torch.cos(0.5 * t)
    sinc_exact = torch.sin(0.5 * t) / t
    # Taylor: cos(t/2) ~ 1 - t^2/8 ; sin(t/2)/t ~ 1/2 - t^2/48
    cos_taylor = 1.0 - theta2 / 8.0
    sinc_taylor = 0.5 - theta2 / 48.0
    small = theta2 < _SMALL
    return (torch.where(small, cos_taylor, cos_exact),
            torch.where(small, sinc_taylor, sinc_exact))


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (…,3) -> quaternion (…,4), q = exp(v) (SOn.hpp:284-288)."""
    theta2 = torch.sum(v * v, dim=-1)
    c, s = _cos_sinc_half(theta2)
    return torch.cat([c[..., None], s[..., None] * v], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (…,4) -> rotation vector (…,3) in (-pi, pi].

    MTK::log with plus_minus_periodicity and scale 2 (mtkmath.hpp:268-288):
    (2/|vec|) * atan(|vec|/w) * vec, so q and -q give the same answer.
    """
    w = q[..., 0]
    vec = q[..., 1:4]
    nv2 = torch.sum(vec * vec, dim=-1)
    nv = torch.sqrt(torch.clamp_min(nv2, _SMALL * _SMALL))
    small = nv2 < _SMALL * _SMALL
    tiny_w = torch.abs(w) < 1e-30
    safe_w = torch.where(tiny_w, torch.full_like(w, 1e-30), w)
    angle_over_nv = torch.where(
        small,
        2.0 / torch.where(tiny_w, torch.ones_like(w), w),  # lim = 2/w
        2.0 * torch.atan(nv / safe_w) / nv,
    )
    return angle_over_nv[..., None] * vec


def so3_exp_matrix(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: rotation vector (…,3) -> matrix (…,3,3)
    (so3_math.h:17-32)."""
    theta2 = torch.sum(v * v, dim=-1)
    safe2 = torch.clamp_min(theta2, _SMALL)
    t = torch.sqrt(safe2)
    small = theta2 < _SMALL
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / safe2)
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * (K @ K)


def A_matrix(v: torch.Tensor) -> torch.Tensor:
    """A(v) = I + (1-cos|v|)/|v|^2 hat(v) + (1 - sin|v|/|v|)/|v|^2 hat(v)^2
    (mtkmath.hpp:235-247); A(v)^T is the right Jacobian of SO(3)."""
    theta2 = torch.sum(v * v, dim=-1)
    safe2 = torch.clamp_min(theta2, _SMALL)
    t = torch.sqrt(safe2)
    small = theta2 < _SMALL
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / safe2)
    c2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (1.0 - torch.sin(t) / t) / safe2)
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + c1[..., None, None] * K + c2[..., None, None] * (K @ K)


def quat_to_euler_deg(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw) in degrees with the reference's 57.3
    factor and |pitch| = 90 deg guards (SO3ToEuler, use-ikfom.hpp:90-124)."""
    w, x, y, z = q.unbind(-1)
    sqw, sqx, sqy, sqz = w * w, x * x, y * y, z * z
    unit = sqx + sqy + sqz + sqw
    test = w * y - z * x
    roll = torch.atan2(2 * (x * w + y * z), -sqx - sqy + sqz + sqw)
    pitch = torch.asin(torch.clamp(2 * test / unit, -1.0, 1.0))
    yaw = torch.atan2(2 * (z * w + y * x), sqx - sqy - sqz + sqw)
    north = test > 0.49999 * unit
    south = test < -0.49999 * unit
    pole_roll = 2 * torch.atan2(x, w)
    roll = torch.where(north, pole_roll, torch.where(south, -pole_roll, roll))
    half_pi = torch.full_like(pitch, torch.pi / 2)
    pitch = torch.where(north, half_pi, torch.where(south, -half_pi, pitch))
    yaw = torch.where(north | south, torch.zeros_like(yaw), yaw)
    return torch.stack([roll, pitch, yaw], dim=-1) * 57.3
