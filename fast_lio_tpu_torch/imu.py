"""IMU processing: static initialization, forward propagation, motion deskew.

Port of ``fast_lio_tpu/imu.py`` (the reference's IMU_Processing.hpp):

* ``update_stats`` / ``make_init_state`` — static initialization on the host
  (IMU_Processing.hpp:159-214), numpy as in the JAX package.
* ``propagate_and_deskew`` — forward propagation over a fixed-size padded IMU
  block (IMU_Processing.hpp:243-301) and backward per-point motion
  compensation (IMU_Processing.hpp:307-345) as a vectorized gather.  The
  quaternion chain and the (F, G) covariance composition are the JAX
  package's two ``associative_scan``s in JAX's association order (the
  chain's ``control_flow.associative_scan``, log depth; of the (F, G) scan
  only its last element, ``control_flow.associative_last``, the only one
  read); every per-interval Jacobian is built in one batched call.  On
  CUDA tensors the stage runs as two hand-written kernels instead
  (``kernels/imu.py``, ``csrc/imu.cu``), held to this plain version.

Padding contract for the IMU block (length M): slot 0 is the previous frame's
tail sample (IMU_Processing.hpp:220); ``imu_mask[i]`` marks real samples;
masked-out slots come after all real ones and have nondecreasing times.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import state as st
from .control_flow import associative_last, associative_scan
from .filter import ekf
from .math import so3

_FAR_FUTURE = 1e9


class InitStats(NamedTuple):
    """Host-side running statistics for static initialization."""

    n: int
    mean_acc: np.ndarray
    mean_gyr: np.ndarray
    cov_acc: np.ndarray
    cov_gyr: np.ndarray


def empty_stats() -> InitStats:
    return InitStats(
        n=0,
        mean_acc=np.array([0.0, 0.0, -1.0]),
        mean_gyr=np.zeros(3),
        cov_acc=np.full(3, 0.1),
        cov_gyr=np.full(3, 0.1),
    )


def update_stats(stats: InitStats, acc: np.ndarray, gyr: np.ndarray) -> InitStats:
    """Accumulate one frame of IMU samples (IMU_Processing.hpp:178-194).
    The first-ever call seeds the means from the first sample (:166-176)."""
    n = stats.n
    mean_acc, mean_gyr = stats.mean_acc.copy(), stats.mean_gyr.copy()
    cov_acc, cov_gyr = stats.cov_acc.copy(), stats.cov_gyr.copy()
    if n == 0:
        mean_acc = acc[0].astype(float).copy()
        mean_gyr = gyr[0].astype(float).copy()
        n = 1
    for i in range(len(acc)):
        mean_acc += (acc[i] - mean_acc) / n
        mean_gyr += (gyr[i] - mean_gyr) / n
        cov_acc = cov_acc * (n - 1.0) / n + (acc[i] - mean_acc) ** 2 * (n - 1.0) / n**2
        cov_gyr = cov_gyr * (n - 1.0) / n + (gyr[i] - mean_gyr) ** 2 * (n - 1.0) / n**2
        n += 1
    return InitStats(n, mean_acc, mean_gyr, cov_acc, cov_gyr)


def make_init_state(stats: InitStats, ext_R: np.ndarray, ext_T: np.ndarray,
                    dtype=torch.float32, device=None) -> Tuple[st.State, torch.Tensor]:
    """Initial (state, P) after static init (IMU_Processing.hpp:195-211)."""
    x = st.identity_state(dtype, device)
    grav = -stats.mean_acc / np.linalg.norm(stats.mean_acc) * st.G_M_S2

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    x = x._replace(
        grav=st.normalize_grav(t(grav)),
        bg=t(stats.mean_gyr),
        offset_R_L_I=so3.matrix_to_quat(t(ext_R)),
        offset_T_L_I=t(ext_T),
    )
    P = np.eye(st.DOF)
    P[6:9, 6:9] *= 1e-5  # extrinsic rot
    P[9:12, 9:12] *= 1e-5  # extrinsic trans
    P[15:18, 15:18] *= 1e-4  # bg
    P[18:21, 18:21] *= 1e-3  # ba
    P[21:23, 21:23] *= 1e-5  # grav
    return x, t(P)


class ImuCarry(NamedTuple):
    """Cross-frame IMU state (angvel_last / acc_s_last,
    IMU_Processing.hpp:78-79).  last_lidar_end_time stays on the host."""

    angvel_last: torch.Tensor  # (3,)
    acc_s_last: torch.Tensor  # (3,)


def init_imu_carry(dtype=torch.float32, device=None) -> ImuCarry:
    return ImuCarry(torch.zeros(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device))


def propagate_and_deskew(
    x: st.State,
    P: torch.Tensor,
    Q: torch.Tensor,
    imu_t: torch.Tensor,
    imu_acc: torch.Tensor,
    imu_gyr: torch.Tensor,
    imu_mask: torch.Tensor,
    acc_scale: torch.Tensor,
    last_end_rel: torch.Tensor,
    pcl_end_rel: torch.Tensor,
    carry: ImuCarry,
    pts: torch.Tensor,
    pt_time: torch.Tensor,
    deskew: bool = True,
):
    """``propagate_and_deskew_plain``'s results (``kernels/imu.py``): on CPU
    tensors the plain version itself, on CUDA tensors the custom op
    ``fast_lio_tpu_torch::propagate_and_deskew``, one propagation kernel
    and, with ``deskew``, one deskew kernel (``csrc/imu.cu``)."""
    from .kernels import imu as imu_kernels  # the kernels import this module
    return imu_kernels.propagate_and_deskew(
        x, P, Q, imu_t, imu_acc, imu_gyr, imu_mask, acc_scale, last_end_rel,
        pcl_end_rel, carry, pts, pt_time, deskew)


def propagate_and_deskew_plain(
    x: st.State,
    P: torch.Tensor,
    Q: torch.Tensor,
    imu_t: torch.Tensor,  # (M,) seconds RELATIVE to scan begin
    imu_acc: torch.Tensor,  # (M, 3)
    imu_gyr: torch.Tensor,  # (M, 3)
    imu_mask: torch.Tensor,  # (M,) bool
    acc_scale: torch.Tensor,  # () G / |mean_acc|  (IMU_Processing.hpp:266)
    last_end_rel: torch.Tensor,  # () previous scan end, relative to scan begin
    pcl_end_rel: torch.Tensor,  # () scan end, relative to scan begin
    carry: ImuCarry,
    pts: torch.Tensor,  # (N, 3) LiDAR-frame points
    pt_time: torch.Tensor,  # (N,) per-point offset from scan begin, SECONDS
    deskew: bool = True,
):
    """Forward-propagate through the IMU block and deskew the scan.

    Returns (x_end, P_end, pts_out, new_carry); all points end up in the
    scan-end LiDAR frame (IMU_Processing.hpp:323-343).
    """
    dtype = P.dtype
    M = imu_t.shape[0]
    Mp = M - 1

    rel_t = imu_t.to(dtype)
    rel_last_end = torch.as_tensor(last_end_rel).to(dtype)
    rel_pcl_end = torch.as_tensor(pcl_end_rel).to(dtype)

    pair_tail_mask = imu_mask[1:]  # tail sample must be real
    head_t = rel_t[:-1]
    tail_t = rel_t[1:]
    not_stale = tail_t >= rel_last_end  # skip pre-scan leftovers (:255)
    pair_valid = pair_tail_mask & not_stale

    angvel_avr = 0.5 * (imu_gyr[:-1] + imu_gyr[1:]).to(dtype)
    acc_avr = 0.5 * (imu_acc[:-1] + imu_acc[1:]).to(dtype) * acc_scale
    dts = tail_t - torch.maximum(head_t, rel_last_end)  # (:268-276)
    dts = torch.where(pair_valid, torch.clamp_min(dts, 0.0),
                      torch.zeros_like(dts))

    # ---- forward propagation, batched: the quaternion chain and P's
    # recursion P <- F P F^T + G compose associatively, so both are scans
    omega = angvel_avr - x.bg  # (Mp, 3)
    a_body = acc_avr - x.ba  # (Mp, 3)
    dq = so3.so3_exp(omega * dts[:, None])  # identity where dt == 0
    q_incl = associative_scan(so3.quat_multiply, dq)
    q_after = so3.quat_multiply(x.rot[None, :], q_incl)  # (Mp, 4)
    q_before = torch.cat([x.rot[None, :], q_after[:-1]], dim=0)

    a_w_int = so3.quat_rotate(q_before, a_body) + x.grav  # pre-state f_vel
    vel_after = x.vel + torch.cumsum(a_w_int * dts[:, None], dim=0)
    vel_before = torch.cat([x.vel[None, :], vel_after[:-1]], dim=0)
    pos_after = x.pos + torch.cumsum(vel_before * dts[:, None], dim=0)
    pos_before = torch.cat([x.pos[None, :], pos_after[:-1]], dim=0)

    def bcast(v):
        return v.expand((Mp,) + v.shape)

    x_pre = st.State(
        pos=pos_before, rot=q_before,
        offset_R_L_I=bcast(x.offset_R_L_I), offset_T_L_I=bcast(x.offset_T_L_I),
        vel=vel_before, bg=bcast(x.bg), ba=bcast(x.ba), grav=bcast(x.grav),
    )
    F, Fw, _f = ekf.predict_matrices(x_pre, dts, acc_avr, angvel_avr)
    G = Fw @ Q.to(dtype) @ Fw.transpose(-1, -2)
    eyeD = torch.eye(st.DOF, dtype=dtype, device=F.device)
    F = torch.where(pair_valid[:, None, None], F, eyeD)
    G = torch.where(pair_valid[:, None, None], G, torch.zeros_like(G))
    # invalid pairs are exact identities (F = I, G = 0): padding is a no-op

    def compose(a, b):  # a precedes b: (F_b F_a, F_b G_a F_b^T + G_b)
        Fa, Ga = a
        Fb, Gb = b
        return Fb @ Fa, Fb @ Ga @ Fb.transpose(-1, -2) + Gb

    F_tot, G_tot = associative_last(compose, (F, G))
    P_prop = F_tot @ P @ F_tot.T + G_tot
    P_prop = 0.5 * (P_prop + P_prop.T)

    # forward-fill knot gyr/acc over invalid pairs (angvel_last / acc_s_last
    # carry, IMU_Processing.hpp:290-295)
    steps = torch.arange(Mp, device=dts.device)
    last_valid = torch.cummax(
        torch.where(pair_valid, steps, torch.full_like(steps, -1)), dim=0).values

    def ffill(vals, init):
        picked = vals[torch.clamp(last_valid, 0, Mp - 1)]
        return torch.where((last_valid >= 0)[:, None], picked, init[None, :])

    knot_gyr_v = ffill(omega, carry.angvel_last.to(dtype))
    a_w_knot = so3.quat_rotate(q_after, a_body) + x.grav  # post-state frame
    knot_acc_v = ffill(a_w_knot, carry.acc_s_last.to(dtype))
    last_in = ffill(torch.cat([acc_avr, angvel_avr], dim=-1),
                    torch.zeros(6, dtype=dtype, device=dts.device))[-1]

    # knot offset times: valid -> tail offset; stale-prefix -> 0; padding
    # tail -> far future so searchsorted never selects them as head
    knot_offsets = torch.where(
        pair_valid, tail_t,
        torch.where(pair_tail_mask, torch.zeros_like(tail_t),
                    torch.full_like(tail_t, _FAR_FUTURE)))

    def prepend(k0, arr):
        return torch.cat([k0[None], arr], dim=0)

    knot_t = prepend(torch.zeros((), dtype=dtype, device=dts.device), knot_offsets)
    knot_rot = prepend(x.rot, q_after)
    knot_pos = prepend(x.pos, pos_after)
    knot_vel = prepend(x.vel, vel_after)
    knot_gyr = prepend(carry.angvel_last.to(dtype), knot_gyr_v)
    knot_acc = prepend(carry.acc_s_last.to(dtype), knot_acc_v)

    x_prop = x._replace(pos=pos_after[-1], rot=q_after[-1], vel=vel_after[-1])

    # final fractional predict to scan end (IMU_Processing.hpp:298-301)
    imu_end_rel = torch.max(torch.where(imu_mask, rel_t,
                                        torch.full_like(rel_t, -torch.inf)))
    dt_final = rel_pcl_end - imu_end_rel
    x_end, P_end = ekf.predict(x_prop, P_prop, dt_final, Q, last_in[:3],
                               last_in[3:])

    new_carry = ImuCarry(angvel_last=knot_gyr_v[-1], acc_s_last=knot_acc_v[-1])

    if not deskew:  # MARSIM bypass (IMU_Processing.hpp:310)
        return x_end, P_end, pts, new_carry

    # ---- backward compensation as a vectorized gather (quaternion
    # rotations, elementwise — no matmul touches the point coordinates) ----
    t_p = pt_time.to(dtype)
    head = torch.clamp(
        torch.searchsorted(knot_t, t_p, right=False) - 1, 0, M - 2)
    tail = head + 1
    q_head = knot_rot[head]  # (N,4)
    pos_head = knot_pos[head]
    vel_head = knot_vel[head]
    acc_tail = knot_acc[tail]
    gyr_tail = knot_gyr[tail]
    dt_p = (t_p - knot_t[head])[:, None]  # (N,1)

    q_i = so3.quat_multiply(q_head, so3.so3_exp(gyr_tail * dt_p))
    T_ei = pos_head + vel_head * dt_p + 0.5 * acc_tail * dt_p * dt_p - x_end.pos

    p_lidar_i = so3.quat_rotate(x_end.offset_R_L_I, pts) + x_end.offset_T_L_I
    p_world_rel = so3.quat_rotate(q_i, p_lidar_i) + T_ei
    p_imu_e = so3.quat_rotate(so3.quat_conjugate(x_end.rot), p_world_rel)
    pts_out = so3.quat_rotate(so3.quat_conjugate(x_end.offset_R_L_I),
                              p_imu_e - x_end.offset_T_L_I)
    return x_end, P_end, pts_out, new_carry
