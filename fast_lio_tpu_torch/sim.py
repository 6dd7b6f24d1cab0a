"""Synthetic LiDAR + IMU world — the MARSIM-analog test fixture.

A numpy-only copy of ``fast_lio_tpu/sim.py``, so that the port (and
``chip_smoke.py``) can generate scans on a host without JAX.

The reference's only deterministic data source is the MARSIM simulator
(README.md:207-220, preprocess.cpp:458-481, external).  This module provides
an in-repo equivalent: a closed-room world (AABB walls + pillars), an
analytic smooth trajectory, exact IMU samples (finite-differenced from the
trajectory in f64), and spinning-LiDAR scans generated by ray casting with
per-point timestamps — everything the e2e tests, ATE regression, and bench
need, with ground truth attached.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

G = 9.81


# ---------------------------------------------------------------------------
# trajectory (smooth ramp from rest, closed-form position + yaw; derivatives
# via high-accuracy central differences in f64)
# ---------------------------------------------------------------------------


def _smoothstep(u):
    u = np.clip(u, 0.0, 1.0)
    return u * u * u * (10.0 - 15.0 * u + 6.0 * u * u)


@dataclasses.dataclass
class Trajectory:
    radius: float = 3.0
    omega: float = 0.5  # rad/s around the loop
    z_amp: float = 0.3
    t_ramp_start: float = 0.5
    t_ramp: float = 1.5
    yaw_rate_scale: float = 1.0

    def _blend(self, t):
        return _smoothstep((t - self.t_ramp_start) / self.t_ramp)

    def pos(self, t):
        t = np.asarray(t, np.float64)
        b = self._blend(t)
        tau = (t - self.t_ramp_start) * b  # stilled before ramp
        x = self.radius * np.sin(self.omega * tau)
        y = self.radius * (1.0 - np.cos(self.omega * tau))
        z = 1.0 + self.z_amp * np.sin(0.7 * self.omega * tau) * b
        return np.stack([x, y, z], axis=-1)

    def yaw(self, t):
        t = np.asarray(t, np.float64)
        b = self._blend(t)
        tau = (t - self.t_ramp_start) * b
        return self.yaw_rate_scale * self.omega * tau

    def rot(self, t):
        """World <- body rotation (yaw only; body x looks along motion)."""
        y = self.yaw(t)
        c, s = np.cos(y), np.sin(y)
        zero = np.zeros_like(y)
        one = np.ones_like(y)
        R = np.stack(
            [
                np.stack([c, -s, zero], -1),
                np.stack([s, c, zero], -1),
                np.stack([zero, zero, one], -1),
            ],
            axis=-2,
        )
        return R

    def imu_sample(self, t, h=1e-5):
        """Exact-ish IMU at time t: body-frame acc (specific force) + gyro."""
        t = np.asarray(t, np.float64)
        p_m, p0, p_p = self.pos(t - h), self.pos(t), self.pos(t + h)
        acc_w = (p_p - 2 * p0 + p_m) / (h * h)
        R = self.rot(t)
        # specific force: f_b = R^T (a_w - g_w), g_w = (0,0,-G)
        f_w = acc_w - np.array([0.0, 0.0, -G])
        f_b = np.einsum("...ji,...j->...i", R, f_w)
        # gyro: omega_b from Rdot = R hat(omega_b)
        y_m, y_p = self.yaw(t - h), self.yaw(t + h)
        yaw_rate = (y_p - y_m) / (2 * h)
        gyro_b = np.stack(
            [np.zeros_like(yaw_rate), np.zeros_like(yaw_rate), yaw_rate], -1
        )
        return f_b, gyro_b


# ---------------------------------------------------------------------------
# world geometry + ray casting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class World:
    """Axis-aligned room with pillars.  Each box: (lo(3,), hi(3,))."""

    room_lo: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-12.0, -8.0, 0.0])
    )
    room_hi: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([12.0, 16.0, 5.0])
    )
    pillars: Tuple = (
        (np.array([-4.0, 2.0, 0.0]), np.array([-3.0, 3.0, 5.0])),
        (np.array([3.0, 6.0, 0.0]), np.array([4.5, 7.5, 5.0])),
        (np.array([-1.0, 10.0, 0.0]), np.array([0.5, 11.0, 5.0])),
    )

    def cast(self, origins: np.ndarray, dirs: np.ndarray, max_range: float):
        """Batched ray cast.  origins (N,3), dirs (N,3) unit.
        Returns (ranges (N,), hit (N,))."""
        N = len(origins)
        best = np.full(N, max_range + 1.0)

        inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)

        # room: rays are INSIDE, hit the exit face (max of slab entries ...
        # for an inside ray, exit t = min over axes of the far slab)
        t1 = (self.room_lo - origins) * inv
        t2 = (self.room_hi - origins) * inv
        t_far = np.maximum(t1, t2).min(axis=-1)
        valid = t_far > 1e-6
        best = np.where(valid, np.minimum(best, t_far), best)

        # pillars: standard slab test, rays outside
        for lo, hi in self.pillars:
            t1 = (lo - origins) * inv
            t2 = (hi - origins) * inv
            t_near = np.minimum(t1, t2).max(axis=-1)
            t_far = np.maximum(t1, t2).min(axis=-1)
            hit = (t_near <= t_far) & (t_near > 1e-6)
            best = np.where(hit, np.minimum(best, t_near), best)

        hit = best <= max_range
        return best, hit


# ---------------------------------------------------------------------------
# scan generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimConfig:
    scan_period: float = 0.1
    n_rings: int = 16
    n_azimuth: int = 400
    elev_min: float = -15.0  # degrees
    elev_max: float = 15.0
    max_range: float = 40.0
    imu_rate: float = 200.0
    range_noise: float = 0.0  # std, m
    imu_acc_noise: float = 0.0  # std, m/s^2
    imu_gyr_noise: float = 0.0  # std, rad/s
    imu_acc_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    imu_gyr_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # bias random walks (std per sqrt(s)) — the process the filter's
    # b_gyr_cov/b_acc_cov terms model; the realized bias trajectories are
    # recorded in SimData.gt_{gyr,acc}_bias for convergence assertions
    imu_acc_bias_walk: float = 0.0
    imu_gyr_bias_walk: float = 0.0
    duration: float = 10.0
    seed: int = 0
    # the port's own sensor shapes (the JAX package's sim has neither; at
    # their defaults the runs are bit for bit its runs): ``spin`` -1 sweeps
    # the azimuth clockwise seen from above, as a Velodyne spins (the
    # direction its driver's time reconstruction assumes); ``fov_deg`` below
    # 360 sweeps a forward-looking field of view centred on the body's x
    # axis instead of a full turn, ``n_azimuth`` columns across it
    spin: int = 1
    fov_deg: float = 360.0


@dataclasses.dataclass
class SimData:
    scan_stamps: np.ndarray  # (S,)
    scans: List[np.ndarray]  # (n_i, 3) body-frame points
    scan_pt_times: List[np.ndarray]  # (n_i,) offsets, seconds
    imu_t: np.ndarray  # (K,)
    imu_acc: np.ndarray  # (K, 3)
    imu_gyr: np.ndarray  # (K, 3)
    gt_pos: np.ndarray  # (S, 3) at scan END times
    gt_rot: np.ndarray  # (S, 3, 3)
    gt_gyr_bias: np.ndarray = None  # (K, 3) realized gyro bias at imu_t
    gt_acc_bias: np.ndarray = None  # (K, 3) realized accel bias at imu_t


def generate(
    sim: SimConfig = SimConfig(),
    traj: Trajectory = Trajectory(),
    world: World = World(),
) -> SimData:
    rng = np.random.default_rng(sim.seed)
    n_scans = int(sim.duration / sim.scan_period)

    # IMU stream (starts slightly before first scan like a real sensor)
    imu_t = np.arange(0.0, sim.duration + 0.5 / sim.imu_rate, 1.0 / sim.imu_rate)
    f_b, w_b = traj.imu_sample(imu_t)
    dt = 1.0 / sim.imu_rate
    gt_ab = np.broadcast_to(np.asarray(sim.imu_acc_bias, np.float64),
                            f_b.shape).copy()
    gt_gb = np.broadcast_to(np.asarray(sim.imu_gyr_bias, np.float64),
                            w_b.shape).copy()
    if sim.imu_acc_bias_walk > 0:
        gt_ab += np.cumsum(
            rng.normal(0, sim.imu_acc_bias_walk * np.sqrt(dt), f_b.shape), 0)
    if sim.imu_gyr_bias_walk > 0:
        gt_gb += np.cumsum(
            rng.normal(0, sim.imu_gyr_bias_walk * np.sqrt(dt), w_b.shape), 0)
    f_b = f_b + gt_ab
    w_b = w_b + gt_gb
    if sim.imu_acc_noise > 0:
        f_b = f_b + rng.normal(0, sim.imu_acc_noise, f_b.shape)
    if sim.imu_gyr_noise > 0:
        w_b = w_b + rng.normal(0, sim.imu_gyr_noise, w_b.shape)

    elev = np.deg2rad(np.linspace(sim.elev_min, sim.elev_max, sim.n_rings))
    scans, pt_times, stamps = [], [], []
    gt_pos, gt_rot = [], []
    for k in range(n_scans):
        t0 = k * sim.scan_period
        # azimuth sweeps a full turn per scan; all rings fire per step
        sweep = np.linspace(0, 2 * np.pi, sim.n_azimuth, endpoint=False)
        tt = t0 + (sweep / (2 * np.pi)) * sim.scan_period  # (A,)
        az = sweep
        if sim.fov_deg < 360.0:
            az = np.deg2rad(sim.fov_deg) * (sweep / (2 * np.pi) - 0.5)
        if sim.spin < 0:
            az = -az
        AZ, EL = np.meshgrid(az, elev, indexing="ij")  # (A, R)
        T = np.repeat(tt[:, None], sim.n_rings, 1)  # (A, R)

        d_body = np.stack(
            [
                np.cos(EL) * np.cos(AZ),
                np.cos(EL) * np.sin(AZ),
                np.sin(EL),
            ],
            axis=-1,
        ).reshape(-1, 3)
        T = T.reshape(-1)

        R_wb = traj.rot(T)  # (P, 3, 3)
        p_wb = traj.pos(T)  # (P, 3)
        d_world = np.einsum("nij,nj->ni", R_wb, d_body)
        rng_hit, hit = world.cast(p_wb, d_world, sim.max_range)
        if sim.range_noise > 0:
            rng_hit = rng_hit + rng.normal(0, sim.range_noise, len(rng_hit))
        pts_body = d_body * rng_hit[:, None]
        scans.append(pts_body[hit].astype(np.float32))
        pt_times.append((T[hit] - t0).astype(np.float64))
        stamps.append(t0)
        te = t0 + sim.scan_period * (sim.n_azimuth - 1) / sim.n_azimuth
        gt_pos.append(traj.pos(te))
        gt_rot.append(traj.rot(te))

    return SimData(
        scan_stamps=np.asarray(stamps),
        scans=scans,
        scan_pt_times=pt_times,
        imu_t=imu_t,
        imu_acc=f_b,
        imu_gyr=w_b,
        gt_pos=np.stack(gt_pos),
        gt_rot=np.stack(gt_rot),
        gt_gyr_bias=gt_gb,
        gt_acc_bias=gt_ab,
    )


def _matched_positions(traj_est, sim: SimData):
    est_t = np.array([t for t, _, _ in traj_est])
    est_p = np.stack([np.asarray(p, np.float64) for _, p, _ in traj_est])
    gt_end_t = sim.scan_stamps + (sim.scan_stamps[1] - sim.scan_stamps[0]) \
        if len(sim.scan_stamps) > 1 else sim.scan_stamps
    pairs = [int(np.argmin(np.abs(gt_end_t - t))) for t in est_t]
    return est_p, sim.gt_pos[pairs]


def ate_rmse(traj_est: List[Tuple[float, np.ndarray, np.ndarray]],
             sim: SimData) -> float:
    """Absolute trajectory error (position RMSE) vs ground truth, matched by
    scan end time and aligned by the first matched pair (the estimator's
    world origin is the IMU pose at init; orientations already share the
    gravity-aligned identity yaw).  STRICTER than the standard TUM/evo ATE
    (no rotation alignment): any frame-yaw error grows with distance from
    the origin.  See ate_rmse_aligned for the standard definition."""
    if not traj_est:
        return float("inf")
    est_p, gt_p = _matched_positions(traj_est, sim)
    off = est_p[0] - gt_p[0]
    err = (est_p - off) - gt_p
    return float(np.sqrt((err**2).sum(-1).mean()))


def ate_rmse_aligned(traj_est: List[Tuple[float, np.ndarray, np.ndarray]],
                     sim: SimData) -> float:
    """Standard ATE RMSE: least-squares SE(3) (Umeyama) alignment of the
    estimate onto ground truth before the position RMSE — the definition the
    evo toolkit and the FAST-LIO2 paper's ATE tables use."""
    if not traj_est:
        return float("inf")
    est_p, gt_p = _matched_positions(traj_est, sim)
    mu_s, mu_d = est_p.mean(0), gt_p.mean(0)
    cs, cd = est_p - mu_s, gt_p - mu_d
    cov = cd.T @ cs / len(est_p)
    U, S, Vt = np.linalg.svd(cov)
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1
    R = U @ W @ Vt
    t = mu_d - R @ mu_s
    err = (R @ est_p.T).T + t - gt_p
    return float(np.sqrt((err**2).sum(-1).mean()))


def write_avia_bag(path, sim: SimData, scans=None, imu_after: float = -np.inf,
                   lidar_topic: str = "/livox/lidar",
                   imu_topic: str = "/livox/imu") -> None:
    """Write a sim run as a ROS1 bag: each scan as a Livox CustomMsg (tag
    0x10, line = point index mod 6, reflectivity 1) after the Imu messages
    stamped up to it, then the remaining Imu messages.

    ``scans`` picks the scan indices (default all); Imu samples stamped at or
    before ``imu_after`` are left out, so a bag can carry the second half of
    a run that resumes from a checkpoint."""
    from .io.rosbag import BagWriter, serialize_imu, serialize_livox

    w = BagWriter(path)
    imu_i = int(np.searchsorted(sim.imu_t, imu_after, side="right"))

    def imu_until(t_max):
        nonlocal imu_i
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_max:
            t = float(sim.imu_t[imu_i])
            w.write(imu_topic, "sensor_msgs/Imu", t,
                    serialize_imu(t, sim.imu_acc[imu_i], sim.imu_gyr[imu_i]))
            imu_i += 1

    for k in (range(len(sim.scans)) if scans is None else scans):
        stamp = float(sim.scan_stamps[k])
        imu_until(stamp + 1e-9)
        pts = sim.scans[k]
        n = len(pts)
        w.write(lidar_topic, "livox_ros_driver/CustomMsg", stamp,
                serialize_livox(stamp, pts, np.ones(n, np.float32),
                                (sim.scan_pt_times[k] * 1e9).astype(np.uint32),
                                np.full(n, 0x10, np.uint8),
                                (np.arange(n) % 6).astype(np.uint8)))
    imu_until(np.inf)
    w.close()


# PointCloud2 layouts of the sensors whose drivers publish one
# (preprocess/drivers.py decodes each): (field, dtype), in wire order
_XYZI = (("x", np.float32), ("y", np.float32), ("z", np.float32),
         ("intensity", np.float32))
POINTCLOUD2_KINDS = {
    # time: offset from the scan start in ms (the VELODYNE preset's unit)
    "velodyne": _XYZI + (("time", np.float32), ("ring", np.uint16)),
    # the same with every time 0: the decoder reconstructs the offsets from
    # the azimuth, as for a driver that gives none
    "velodyne_no_time": _XYZI + (("time", np.float32), ("ring", np.uint16)),
    # t: offset in ns (the OUSTER64 preset's unit)
    "ouster": _XYZI + (("t", np.uint32), ("ring", np.uint8)),
    "marsim": _XYZI,
}
POINTCLOUD2_TOPICS = {"velodyne": "/velodyne_points",
                      "velodyne_no_time": "/velodyne_points",
                      "ouster": "/os_cloud_node/points",
                      "marsim": "/sim_cloud"}


def ring_of(pts: np.ndarray, sim: SimConfig) -> np.ndarray:
    """Each point's ring: the index of the elevation band of ``sim``'s
    rings (evenly spaced from ``elev_min`` to ``elev_max``) nearest its
    elevation (range noise moves a return along its ray, not across)."""
    p = np.asarray(pts, np.float64)
    elev = np.rad2deg(np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1])))
    if sim.n_rings == 1:
        return np.zeros(len(p), np.int64)
    step = (sim.elev_max - sim.elev_min) / (sim.n_rings - 1)
    return np.clip(np.rint((elev - sim.elev_min) / step), 0,
                   sim.n_rings - 1).astype(np.int64)


def pointcloud2_fields(pts: np.ndarray, pt_time: np.ndarray, kind: str,
                       sim: SimConfig) -> dict:
    """One scan's PointCloud2 fields in ``kind``'s layout
    (``POINTCLOUD2_KINDS``): intensity 1, time from ``pt_time`` (seconds
    from the scan start), ring from ``ring_of``."""
    n = len(pts)
    values = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
              "intensity": np.ones(n),
              "time": (np.zeros(n) if kind == "velodyne_no_time"
                       else pt_time * 1e3),
              "t": np.rint(pt_time * 1e9), "ring": ring_of(pts, sim)}
    return {name: np.ascontiguousarray(values[name], dtype)
            for name, dtype in POINTCLOUD2_KINDS[kind]}


def write_pointcloud2_bag(path, sim: SimData, kind: str,
                          sim_cfg: SimConfig = SimConfig(), scans=None,
                          lidar_topic: str = None,
                          imu_topic: str = "/imu/data") -> None:
    """Write a sim run as a ROS1 bag of ``sensor_msgs/PointCloud2`` scans in
    the layout of ``kind`` (``POINTCLOUD2_KINDS``: velodyne,
    velodyne_no_time, ouster, marsim), each scan stamped at its start after
    the Imu messages stamped up to it, then the remaining Imu messages.
    ``sim_cfg`` is the run's sim config (its rings give the ring field);
    ``scans`` picks the scan indices (default all); ``lidar_topic`` defaults
    to ``POINTCLOUD2_TOPICS[kind]``."""
    from .io.rosbag import BagWriter, serialize_imu, serialize_pointcloud2

    if kind not in POINTCLOUD2_KINDS:
        raise ValueError(f"unknown PointCloud2 kind {kind!r}: one of "
                         f"{', '.join(POINTCLOUD2_KINDS)}")
    lidar_topic = lidar_topic or POINTCLOUD2_TOPICS[kind]
    w = BagWriter(path)
    imu_i = 0

    def imu_until(t_max):
        nonlocal imu_i
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_max:
            t = float(sim.imu_t[imu_i])
            w.write(imu_topic, "sensor_msgs/Imu", t,
                    serialize_imu(t, sim.imu_acc[imu_i], sim.imu_gyr[imu_i]))
            imu_i += 1

    for k in (range(len(sim.scans)) if scans is None else scans):
        stamp = float(sim.scan_stamps[k])
        imu_until(stamp + 1e-9)
        w.write(lidar_topic, "sensor_msgs/PointCloud2", stamp,
                serialize_pointcloud2(stamp, pointcloud2_fields(
                    sim.scans[k], sim.scan_pt_times[k], kind, sim_cfg)))
    imu_until(np.inf)
    w.close()
