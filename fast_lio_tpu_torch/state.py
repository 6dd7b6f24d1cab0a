"""The 23-DOF FAST-LIO state manifold as a NamedTuple of tensors.

Port of ``fast_lio_tpu/state.py`` (``state_ikfom``, use-ikfom.hpp:12-21):

    state = pos (R^3) ⊕ rot (SO3) ⊕ offset_R_L_I (SO3) ⊕ offset_T_L_I (R^3)
            ⊕ vel (R^3) ⊕ bg (R^3) ⊕ ba (R^3) ⊕ grav (S^2, radius G)

Error-state (DOF) layout, measurement Jacobian in the first 12 columns:

    idx  0-2   pos            idx 12-14  vel
    idx  3-5   rot            idx 15-17  bg
    idx  6-8   offset_R_L_I   idx 18-20  ba
    idx  9-11  offset_T_L_I   idx 21-22  grav (2-DOF tangent)

Quaternions are stored (w, x, y, z).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math import s2, so3

# Gravity sphere radius: MTK::S2<double, 98090, 10000, 1> -> 98090/10000
# (use-ikfom.hpp:8).  NOTE: distinct from G_m_s2 = 9.81 (common_lib.h:20).
S2_LENGTH = 9.809
G_M_S2 = 9.81

DOF = 23  # error-state dimension (n)
DIM = 24  # flattened dynamics dimension (m)
NOISE_DOF = 12  # process noise dimension (gyro, acc, bias walks)
H_COLS = 12  # measurement Jacobian occupies first 12 error-state columns

IDX_POS = 0
IDX_ROT = 3
IDX_EXT_R = 6
IDX_EXT_T = 9
IDX_VEL = 12
IDX_BG = 15
IDX_BA = 18
IDX_GRAV = 21
SO3_BLOCKS = ((IDX_ROT, IDX_ROT), (IDX_EXT_R, IDX_EXT_R))
S2_BLOCKS = ((IDX_GRAV, IDX_GRAV),)
VECT_BLOCKS = (
    (IDX_POS, IDX_POS, 3),
    (IDX_EXT_T, IDX_EXT_T, 3),
    (IDX_VEL, IDX_VEL, 3),
    (IDX_BG, IDX_BG, 3),
    (IDX_BA, IDX_BA, 3),
)


class State(NamedTuple):
    """One filter state.  All fields share a dtype and device; leading batch
    dims allowed."""

    pos: torch.Tensor  # (…,3)
    rot: torch.Tensor  # (…,4) quaternion wxyz, world <- IMU
    offset_R_L_I: torch.Tensor  # (…,4) quaternion wxyz, IMU <- LiDAR
    offset_T_L_I: torch.Tensor  # (…,3)
    vel: torch.Tensor  # (…,3)
    bg: torch.Tensor  # (…,3)
    ba: torch.Tensor  # (…,3)
    grav: torch.Tensor  # (…,3) vector of length S2_LENGTH

    @property
    def dtype(self):
        return self.pos.dtype

    @property
    def device(self):
        return self.pos.device


def identity_state(dtype=torch.float32, device=None) -> State:
    """Default-constructed state: zeros, identity rotations, grav at the
    S2_typ=1 seed +G*e_x (S2.hpp:114-118)."""
    z3 = torch.zeros(3, dtype=dtype, device=device)
    qi = so3.quat_identity(dtype, device)
    grav0 = torch.tensor([S2_LENGTH, 0.0, 0.0], dtype=dtype, device=device)
    return State(z3, qi, qi.clone(), z3.clone(), z3.clone(), z3.clone(),
                 z3.clone(), grav0)


def normalize_grav(g: torch.Tensor) -> torch.Tensor:
    """Project a gravity estimate onto the S2 sphere (S2.hpp:119-127)."""
    return g / torch.linalg.norm(g, dim=-1, keepdim=True) * S2_LENGTH


def boxplus(s: State, dx: torch.Tensor) -> State:
    """s ⊞ dx with dx in the 23-dim error space (per-block boxplus, scale 1)."""
    return State(
        pos=s.pos + dx[..., IDX_POS:IDX_POS + 3],
        rot=so3.quat_multiply(s.rot, so3.so3_exp(dx[..., IDX_ROT:IDX_ROT + 3])),
        offset_R_L_I=so3.quat_multiply(
            s.offset_R_L_I, so3.so3_exp(dx[..., IDX_EXT_R:IDX_EXT_R + 3])),
        offset_T_L_I=s.offset_T_L_I + dx[..., IDX_EXT_T:IDX_EXT_T + 3],
        vel=s.vel + dx[..., IDX_VEL:IDX_VEL + 3],
        bg=s.bg + dx[..., IDX_BG:IDX_BG + 3],
        ba=s.ba + dx[..., IDX_BA:IDX_BA + 3],
        grav=s2.boxplus(s.grav, dx[..., IDX_GRAV:IDX_GRAV + 2], S2_LENGTH),
    )


def boxminus(s: State, other: State) -> torch.Tensor:
    """(s ⊟ other) in the 23-dim error space."""
    rot_d = so3.so3_log(so3.quat_multiply(so3.quat_conjugate(other.rot), s.rot))
    ext_d = so3.so3_log(so3.quat_multiply(
        so3.quat_conjugate(other.offset_R_L_I), s.offset_R_L_I))
    grav_d = s2.boxminus(s.grav, other.grav, S2_LENGTH)
    return torch.cat(
        [
            s.pos - other.pos,
            rot_d,
            ext_d,
            s.offset_T_L_I - other.offset_T_L_I,
            s.vel - other.vel,
            s.bg - other.bg,
            s.ba - other.ba,
            grav_d,
        ],
        dim=-1,
    )


def oplus(s: State, f: torch.Tensor, dt) -> State:
    """DIM-space retraction used by predict: vect blocks +f*dt, SO3 blocks
    q <- q * exp(f_seg * dt), S2 block rotated by exp(f_seg * dt)."""
    return State(
        pos=s.pos + f[..., IDX_POS:IDX_POS + 3] * dt,
        rot=so3.quat_multiply(s.rot, so3.so3_exp(f[..., IDX_ROT:IDX_ROT + 3] * dt)),
        offset_R_L_I=so3.quat_multiply(
            s.offset_R_L_I, so3.so3_exp(f[..., IDX_EXT_R:IDX_EXT_R + 3] * dt)),
        offset_T_L_I=s.offset_T_L_I + f[..., IDX_EXT_T:IDX_EXT_T + 3] * dt,
        vel=s.vel + f[..., IDX_VEL:IDX_VEL + 3] * dt,
        bg=s.bg + f[..., IDX_BG:IDX_BG + 3] * dt,
        ba=s.ba + f[..., IDX_BA:IDX_BA + 3] * dt,
        grav=s2.oplus(s.grav, f[..., IDX_GRAV:IDX_GRAV + 3], dt),
    )


def astype(s: State, dtype) -> State:
    """Every field of ``s`` cast to ``dtype``."""
    return State(*(v.to(dtype) for v in s))
