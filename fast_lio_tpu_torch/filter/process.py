"""Process model of the LiDAR-inertial system.

Port of ``fast_lio_tpu/filter/process.py`` (use-ikfom.hpp:28-88): ``get_f``
(24-dim flattened dynamics), ``df_dx`` (24x23), ``df_dw`` (24x12) and the
12x12 process-noise covariance.  Every function takes states with leading
batch dims, which is how the IMU propagation builds all per-interval
Jacobians at once (the JAX package vmaps instead).

Noise vector layout (process_noise_ikfom, use-ikfom.hpp:28-33):
    [0:3] gyro noise  [3:6] acc noise  [6:9] gyro-bias walk  [9:12] acc-bias walk
"""
from __future__ import annotations

import torch

from .. import state as st
from ..math import s2, so3


def f_dynamics(s: st.State, acc: torch.Tensor, gyro: torch.Tensor) -> torch.Tensor:
    """Flattened dynamics vector (…, 24).  use-ikfom.hpp:47-59."""
    omega = gyro - s.bg
    a_inertial = so3.quat_rotate(s.rot, acc - s.ba) + s.grav
    batch = torch.broadcast_shapes(s.vel.shape, omega.shape, a_inertial.shape)
    vel = s.vel.expand(batch)
    z = vel.new_zeros(batch[:-1] + (6,))
    z9 = vel.new_zeros(batch[:-1] + (9,))
    return torch.cat([vel, omega.expand(batch), z, a_inertial.expand(batch), z9],
                     dim=-1)


def df_dx(s: st.State, acc: torch.Tensor, gyro: torch.Tensor) -> torch.Tensor:
    """(…, 24, 23) Jacobian of f wrt the error state.  use-ikfom.hpp:61-77."""
    R = so3.quat_to_matrix(s.rot)
    a = acc - s.ba
    batch = torch.broadcast_shapes(R.shape[:-2], a.shape[:-1])
    J = R.new_zeros(batch + (st.DIM, st.DOF))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    J[..., st.IDX_POS:st.IDX_POS + 3, st.IDX_VEL:st.IDX_VEL + 3] = eye
    J[..., st.IDX_VEL:st.IDX_VEL + 3, st.IDX_ROT:st.IDX_ROT + 3] = -R @ so3.hat(a)
    J[..., st.IDX_VEL:st.IDX_VEL + 3, st.IDX_BA:st.IDX_BA + 3] = -R
    zero2 = R.new_zeros(s.grav.shape[:-1] + (2,))
    J[..., st.IDX_VEL:st.IDX_VEL + 3, st.IDX_GRAV:st.IDX_GRAV + 2] = s2.mx(
        s.grav, zero2, st.S2_LENGTH)
    J[..., st.IDX_ROT:st.IDX_ROT + 3, st.IDX_BG:st.IDX_BG + 3] = -eye
    return J


def df_dw(s: st.State) -> torch.Tensor:
    """(…, 24, 12) Jacobian of f wrt process noise.  use-ikfom.hpp:80-88."""
    R = so3.quat_to_matrix(s.rot)
    J = R.new_zeros(R.shape[:-2] + (st.DIM, st.NOISE_DOF))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    J[..., st.IDX_ROT:st.IDX_ROT + 3, 0:3] = -eye
    J[..., st.IDX_VEL:st.IDX_VEL + 3, 3:6] = -R
    J[..., st.IDX_BG:st.IDX_BG + 3, 6:9] = eye
    J[..., st.IDX_BA:st.IDX_BA + 3, 9:12] = eye
    return J


def process_noise_cov(gyr_cov, acc_cov, b_gyr_cov, b_acc_cov,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """12x12 diagonal Q (IMU_Processing.hpp:280-283)."""
    diag = torch.tensor(
        [gyr_cov] * 3 + [acc_cov] * 3 + [b_gyr_cov] * 3 + [b_acc_cov] * 3,
        dtype=dtype, device=device)
    return torch.diag(diag)
