"""Per-vendor LiDAR decoders — the ``Preprocess`` handlers re-designed as
vectorized numpy host-side kernels.

Port of ``fast_lio_tpu/preprocess/drivers.py`` (numpy only, the same
code).  Reference: FAST_LIO's src/preprocess.cpp
  * avia_handler      (:92-187)  — Livox CustomMsg: tag/line gates, duplicate
    suppression, 1-in-N decimation, blind cull, offset ns -> time
  * oust64_handler    (:189-282) — PointCloud2 with t (ns): decimate + blind
  * velodyne_handler  (:284-456) — PointCloud2 with time+ring; when per-point
    time is missing, reconstruct offsets from azimuth unwrap at
    omega = 0.361 * SCAN_RATE deg/ms per ring
  * sim_handler       (:458-481) — plain XYZI, zero offsets (MARSIM)

The reference stores per-point time in the ``curvature`` field in MILLISECONDS
(preprocess.cpp:122 comment).  We output a RawScan with offsets in SECONDS —
the unit conversion lives here and nowhere else.

Feature extraction (LOAM-style, default-off in every reference launch file)
lives in fast_lio_tpu_torch.preprocess.features and is applied by ``decode`` when
cfg.feature_extract_enable is set.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import tracing
from ..config import Config, LidarType


@dataclasses.dataclass
class RawScan:
    """Decoded scan: LiDAR-frame points + per-point offsets from scan start."""

    pts: np.ndarray  # (n, 3) f32
    time_offset_s: np.ndarray  # (n,) f64 seconds
    intensity: np.ndarray  # (n,) f32


def decode_avia(
    xyz: np.ndarray,  # (n, 3)
    reflectivity: np.ndarray,  # (n,)
    offset_time_ns: np.ndarray,  # (n,)
    tag: np.ndarray,  # (n,) uint8
    line: np.ndarray,  # (n,) uint8
    cfg: Config,
) -> RawScan:
    """Livox CustomMsg path (preprocess.cpp:161-186, feature-off branch)."""
    n = len(xyz)
    if n == 0:
        return RawScan(np.zeros((0, 3), np.float32), np.zeros(0), np.zeros(0, np.float32))
    keep = (line < cfg.n_scans) & (
        ((tag & 0x30) == 0x10) | ((tag & 0x30) == 0x00)
    )
    keep[0] = False  # reference loop starts at i=1
    # decimation counts only tag/line-valid returns (valid_num % N == 0)
    valid_num = np.cumsum(keep)
    keep &= (valid_num % cfg.point_filter_num) == 0
    # duplicate suppression vs the previous raw return + blind cull
    prev = np.roll(xyz, 1, axis=0)
    moved = np.abs(xyz - prev).max(axis=1) > 1e-7
    r2 = (xyz**2).sum(axis=1)
    keep &= moved & (r2 > cfg.blind * cfg.blind)
    return RawScan(
        pts=xyz[keep].astype(np.float32),
        time_offset_s=offset_time_ns[keep].astype(np.float64) * 1e-9,
        intensity=reflectivity[keep].astype(np.float32),
    )


def decode_ouster(
    xyz: np.ndarray,
    intensity: np.ndarray,
    t_raw: np.ndarray,
    cfg: Config,
) -> RawScan:
    """Ouster path (preprocess.cpp:253-279): decimate 1-in-N + blind cull."""
    n = len(xyz)
    idx = np.arange(n)
    r2 = (xyz**2).sum(axis=1)
    keep = ((idx % cfg.point_filter_num) == 0) & (r2 >= cfg.blind * cfg.blind)
    t_ms = t_raw.astype(np.float64) * cfg.time_unit.to_ms
    return RawScan(
        pts=xyz[keep].astype(np.float32),
        time_offset_s=t_ms[keep] * 1e-3,
        intensity=intensity[keep].astype(np.float32),
    )


def _velodyne_reconstruct_offsets(
    xyz: np.ndarray, ring: np.ndarray, cfg: Config
) -> np.ndarray:
    """Azimuth-unwrap time reconstruction (preprocess.cpp:415-445) when the
    driver gives no per-point time.  Returns offsets in ms; the first point
    of each ring is marked with NaN (the reference `continue`s it away)."""
    omega_l = 0.361 * cfg.scan_rate  # deg per ms
    # f64 yaw regardless of input dtype: the exact contract shared with the
    # native decoder (native/lio_host.cpp decode_velodyne, parity-tested)
    yaw = np.arctan2(xyz[:, 1].astype(np.float64),
                     xyz[:, 0].astype(np.float64)) * 57.2957
    out = np.full(len(xyz), np.nan)
    for layer in np.unique(ring):
        sel = np.where(ring == layer)[0]
        if len(sel) == 0:
            continue
        yaw_fp = yaw[sel[0]]
        curv = np.where(
            yaw[sel] <= yaw_fp,
            (yaw_fp - yaw[sel]) / omega_l,
            (yaw_fp - yaw[sel] + 360.0) / omega_l,
        )
        # the reference's single monotonicity fix-up (+one revolution)
        period = 360.0 / omega_l
        t_last = 0.0
        for k in range(1, len(sel)):
            if curv[k] < t_last:
                curv[k] += period
            t_last = curv[k]
        out[sel[1:]] = curv[1:]
    return out


def decode_velodyne(
    xyz: np.ndarray,
    intensity: np.ndarray,
    time_raw: np.ndarray,  # per-point time field (may be all <= 0)
    ring: np.ndarray,
    cfg: Config,
) -> RawScan:
    """Velodyne path (preprocess.cpp:399-455, feature-off branch)."""
    n = len(xyz)
    if n == 0:
        return RawScan(np.zeros((0, 3), np.float32), np.zeros(0), np.zeros(0, np.float32))
    given = time_raw[-1] > 0  # preprocess.cpp:304
    if given:
        t_ms = time_raw.astype(np.float64) * cfg.time_unit.to_ms
        drop = np.zeros(n, bool)
    else:
        t_ms = _velodyne_reconstruct_offsets(xyz, ring, cfg)
        drop = np.isnan(t_ms)
        t_ms = np.nan_to_num(t_ms)
    idx = np.arange(n)
    r2 = (xyz**2).sum(axis=1)
    keep = ((idx % cfg.point_filter_num) == 0) & (r2 > cfg.blind * cfg.blind) & ~drop
    return RawScan(
        pts=xyz[keep].astype(np.float32),
        time_offset_s=t_ms[keep] * 1e-3,
        intensity=intensity[keep].astype(np.float32),
    )


def decode_marsim(xyz: np.ndarray, intensity: np.ndarray, cfg: Config) -> RawScan:
    """MARSIM path (preprocess.cpp:458-481): blind cull, zero offsets."""
    r2 = (xyz**2).sum(axis=1)
    keep = r2 >= cfg.blind * cfg.blind
    return RawScan(
        pts=xyz[keep].astype(np.float32),
        time_offset_s=np.zeros(int(keep.sum())),
        intensity=intensity[keep].astype(np.float32),
    )


def _native_decode(msg: dict, cfg: Config):
    """Native-library fast path (native/lio_host.cpp) for the branchy
    per-point decode loops — all four handlers, including the Velodyne
    azimuth-unwrap time reconstruction; semantics identical to the numpy
    decoders above (tests/test_native.py asserts parity).  Returns None when
    the shared library is unavailable."""
    from .. import native

    if not native.available():
        return None
    lt = cfg.lidar_type
    if lt == LidarType.AVIA:
        pts, t_s, inten = native.decode_avia(
            msg["xyz"], msg["reflectivity"], msg["offset_time_ns"],
            msg["tag"], msg["line"], cfg.n_scans, cfg.blind,
            cfg.point_filter_num,
        )
    elif lt == LidarType.OUST64:
        pts, t_s, inten = native.decode_generic(
            msg["xyz"], msg["intensity"], np.asarray(msg["t"], np.float64),
            cfg.blind, cfg.point_filter_num, cfg.time_unit.to_ms * 1e-3,
        )
    elif lt == LidarType.MARSIM:
        # sim_handler has no decimation (preprocess.cpp:458-481)
        pts, t_s, inten = native.decode_generic(
            msg["xyz"], msg["intensity"],
            np.zeros(len(msg["xyz"]), np.float64),
            cfg.blind, 1, 0.0,
        )
    elif lt == LidarType.VELO16:
        pts, t_s, inten = native.decode_velodyne(
            msg["xyz"], msg["intensity"], msg["time"], msg["ring"],
            cfg.scan_rate, cfg.time_unit.to_ms, cfg.blind,
            cfg.point_filter_num,
        )
    else:
        return None
    return RawScan(pts=pts, time_offset_s=t_s, intensity=inten)


def decode(msg: dict, cfg: Config, use_native: bool = None) -> RawScan:
    """Dispatch on cfg.lidar_type (Preprocess::process, preprocess.cpp:44-90).

    ``msg`` is a dict of named numpy arrays as produced by
    fast_lio_tpu_torch.io.rosbag or any custom feeder.  ``use_native``: None = use
    the native decoder when the shared library is available (set env
    FAST_LIO_NATIVE=0 to force numpy), True = require it, False = numpy.
    With the tracer on, a ``decode`` span.
    """
    sp = tracing.begin("decode") if tracing.ON else None
    scan = _decode(msg, cfg, use_native)
    if sp is not None:
        tracing.end(sp)
    return scan


def _decode(msg: dict, cfg: Config, use_native) -> RawScan:
    import os

    if use_native is None:
        use_native = os.environ.get("FAST_LIO_NATIVE", "1") != "0"
    lt = cfg.lidar_type
    scan = _native_decode(msg, cfg) if use_native else None
    if scan is None:
        if lt == LidarType.AVIA:
            scan = decode_avia(
                msg["xyz"], msg["reflectivity"], msg["offset_time_ns"],
                msg["tag"], msg["line"], cfg,
            )
        elif lt == LidarType.OUST64:
            scan = decode_ouster(msg["xyz"], msg["intensity"], msg["t"], cfg)
        elif lt == LidarType.VELO16:
            scan = decode_velodyne(
                msg["xyz"], msg["intensity"], msg["time"], msg["ring"], cfg
            )
        elif lt == LidarType.MARSIM:
            scan = decode_marsim(msg["xyz"], msg["intensity"], cfg)
        else:
            raise ValueError(f"unknown lidar_type {lt}")
    if cfg.feature_extract_enable:
        from .features import extract_surfaces

        scan = extract_surfaces(msg, scan, cfg)
    return scan
